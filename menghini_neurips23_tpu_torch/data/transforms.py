"""CLIP image preprocessing.

Host side: PIL decode -> bicubic resize (shorter side) -> center crop ->
uint8 HWC array.  This matches the pip `clip` package's `_transform`
(Resize(n_px, BICUBIC) + CenterCrop + ToTensor + Normalize) that the
reference gets back from `clip.load` and threads through every dataset as
`self.transform`.

Device side: uint8 -> float -> /255 -> per-channel normalize, folded by the
runtime into the patch matmul (ops/patch_embed.py), so the host->device copy
is 1 byte/pixel and no float image is written to device memory.
"""

from __future__ import annotations

import numpy as np

# OpenAI CLIP normalization constants
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def preprocess_pil(img, resolution: int) -> np.ndarray:
    """PIL image -> uint8 (resolution, resolution, 3), CLIP-style."""
    from PIL import Image

    img = img.convert("RGB")
    w, h = img.size
    # Resize shorter side to `resolution` (torchvision Resize(int) semantics)
    if w < h:
        nw, nh = resolution, max(resolution, int(round(h * resolution / w)))
    else:
        nh, nw = resolution, max(resolution, int(round(w * resolution / h)))
    img = img.resize((nw, nh), Image.BICUBIC)
    # Center crop
    left = (nw - resolution) // 2
    top = (nh - resolution) // 2
    img = img.crop((left, top, left + resolution, top + resolution))
    return np.asarray(img, dtype=np.uint8)


def load_image(path: str, resolution: int) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as img:
        return preprocess_pil(img, resolution)
