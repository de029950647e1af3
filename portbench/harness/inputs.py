"""Inputs made from `--seed`: sub-seeds, class names, images, CLIP weights.

The same seed gives the same inputs, and every seed gives the same sizes:
the class names' shapes (words and letters) are one fixed multiset that a
seed only shuffles and spells, so the text context length is the same for
every seed, and each class holds a fixed number of rows.

Weights follow OpenAI CLIP's state-dict names (the patch embedding as the
(P*P*3, W) matmul kernel `visual.conv1_kernel`, rows in (p_h, p_w, channel)
order).  They are drawn on the device in one call per distribution: every
normal leaf is a slice of one `torch.randn` draw, scaled in place.  Both the
program and the plain reference are handed the same state dict.
"""

from __future__ import annotations

import hashlib
import math
import string
from typing import Dict, List, Tuple

import numpy as np
import torch


def sub_seed(seed: int, tag: str, bits: int = 63) -> int:
    """A seed for one purpose, derived from the run's seed and a tag."""
    h = hashlib.blake2b(f"{int(seed)}:{tag}".encode(), digest_size=8).digest()
    return int.from_bytes(h, "little") % (1 << bits)


def class_names(seed: int, count: int, words: Tuple[int, int], letters: Tuple[int, int]
                ) -> List[str]:
    """`count` distinct lowercase names, words joined by '_'.  The shapes come
    from a fixed generator; the seed shuffles them and draws the letters."""
    fixed = np.random.default_rng(20231017)
    shapes = [tuple(int(n) for n in fixed.integers(letters[0], letters[1] + 1,
                                                   size=int(fixed.integers(words[0], words[1] + 1))))
              for _ in range(count)]
    rng = np.random.default_rng(sub_seed(seed, "class_names"))
    order = rng.permutation(count)
    alphabet = np.array(list(string.ascii_lowercase))
    names: List[str] = []
    for i in order:
        while True:
            name = "_".join("".join(rng.choice(alphabet, size=n)) for n in shapes[i])
            if name not in names:
                names.append(name)
                break
    return names


def balanced_labels(seed: int, tag: str, classes: int, per_class: int) -> np.ndarray:
    """`per_class` rows of each class, in an order drawn from the seed."""
    labels = np.repeat(np.arange(classes), per_class)
    return labels[np.random.default_rng(sub_seed(seed, tag)).permutation(len(labels))]


def images(seed: int, count: int, resolution: int, device) -> torch.Tensor:
    """(count, R, R, 3) uint8 noise images drawn on `device` from the seed."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "images"))
    return torch.randint(0, 256, (count, resolution, resolution, 3), generator=g,
                         device=device, dtype=torch.uint8)


def _block_shapes(prefix: str, width: int, layers: int) -> Dict[str, tuple]:
    out = {}
    for i in range(layers):
        p = f"{prefix}.transformer.resblocks.{i}."
        out.update({
            p + "ln_1.weight": (width,), p + "ln_1.bias": (width,),
            p + "attn.in_proj_weight": (3 * width, width), p + "attn.in_proj_bias": (3 * width,),
            p + "attn.out_proj.weight": (width, width), p + "attn.out_proj.bias": (width,),
            p + "ln_2.weight": (width,), p + "ln_2.bias": (width,),
            p + "mlp.c_fc.weight": (4 * width, width), p + "mlp.c_fc.bias": (4 * width,),
            p + "mlp.c_proj.weight": (width, 4 * width), p + "mlp.c_proj.bias": (width,),
        })
    return out


def state_shapes(cfg: dict) -> Dict[str, tuple]:
    """Every leaf of the CLIP state dict, by name, from a configuration's sizes."""
    vw, tw, e = cfg["vision_width"], cfg["transformer_width"], cfg["embed_dim"]
    p = cfg["vision_patch_size"]
    grid = cfg["image_resolution"] // p
    shapes = {
        "visual.conv1_kernel": (p * p * 3, vw),
        "visual.class_embedding": (vw,),
        "visual.positional_embedding": (grid * grid + 1, vw),
        "visual.ln_pre.weight": (vw,), "visual.ln_pre.bias": (vw,),
        **_block_shapes("visual", vw, cfg["vision_layers"]),
        "visual.ln_post.weight": (vw,), "visual.ln_post.bias": (vw,),
        "visual.proj": (vw, e),
        "text.token_embedding.weight": (cfg["vocab_size"], tw),
        "text.positional_embedding": (cfg["context_length"], tw),
        **_block_shapes("text", tw, cfg["transformer_layers"]),
        "text.ln_final.weight": (tw,), "text.ln_final.bias": (tw,),
        "text.text_projection": (tw, e),
        "logit_scale": (),
    }
    return shapes


def _std(name: str, shape: tuple, cfg: dict):
    """The leaf's normal std, or None for a constant leaf (LayerNorm scales 1,
    biases 0, logit_scale log(1/0.07))."""
    leaf = name.rsplit(".", 1)[-1]
    width = cfg["vision_width"] if name.startswith("visual.") else cfg["transformer_width"]
    if name == "logit_scale" or ("ln_" in name and leaf in ("weight", "bias")) \
            or leaf in ("bias", "in_proj_bias"):
        return None
    if name == "text.token_embedding.weight":
        return 0.02
    if name == "text.positional_embedding":
        return 0.01
    if leaf == "weight":  # out_proj, c_fc, c_proj: 1/sqrt(fan_in)
        return shape[1] ** -0.5
    return width ** -0.5  # conv1 kernel, class/positional embeddings, in_proj, projections


def clip_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """fp32 CLIP weights on `device` from the seed: one randn draw for all
    normal leaves (each a scaled slice of it), constants for the rest."""
    shapes = state_shapes(cfg)
    stds = {k: _std(k, s, cfg) for k, s in shapes.items()}
    total = sum(math.prod(s) for k, s in shapes.items() if stds[k] is not None)
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    flat = torch.randn(total, generator=g, device=device)
    sd, at = {}, 0
    for k, s in shapes.items():
        if stds[k] is None:
            if k == "logit_scale":
                sd[k] = torch.full(s, math.log(1.0 / 0.07), device=device)
            elif k.endswith("weight"):
                sd[k] = torch.ones(s, device=device)
            else:
                sd[k] = torch.zeros(s, device=device)
            continue
        n = math.prod(s)
        sd[k] = flat[at : at + n].view(s).mul_(stds[k])
        at += n
    return sd


def prompt_init(seed: int, shape: tuple, std: float = 0.02) -> np.ndarray:
    """The prompt every run starts from: normal(0, std), fp32, on the host."""
    rng = np.random.default_rng(sub_seed(seed, "prompt"))
    return (rng.standard_normal(shape) * std).astype(np.float32)
