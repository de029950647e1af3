"""Normalization-folded patch embedding.

The standard pipeline is `normalize(u8/255) -> patchify -> @ conv_kernel`,
which writes a full-resolution float image to device memory.  Because the
normalization is affine per channel, it folds algebraically into the patch
matmul:

    ((u8/255 - mean_c) / std_c) @ K  ==  u8 @ K' + b
    K'[i, :] = K[i, :] / (255 * std_{c(i)}),   b = -sum_i (mean_{c(i)}/std_{c(i)}) K[i, :]

so the uint8 pixels are cast on the device and go straight into one matmul.
Exact to fp32 rounding.  This is a plain `torch.matmul`, not a hand kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from menghini_neurips23_tpu_torch.data.transforms import CLIP_MEAN, CLIP_STD


def fold_normalization(conv1_kernel: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(P*P*3, W) patch kernel -> (K', b) with CLIP normalize folded in.

    Rows of the kernel are ordered (p_h, p_w, channel) - the layout
    `patch_tokens` produces - so row i has channel i % 3.  Computed in
    float64 NumPy, returned as float32."""
    k = np.asarray(conv1_kernel, np.float64)
    rows = k.shape[0]
    ch = np.arange(rows) % 3
    scale = 1.0 / (255.0 * CLIP_STD[ch])  # (rows,)
    shift = CLIP_MEAN[ch] / CLIP_STD[ch]
    k_folded = (k * scale[:, None]).astype(np.float32)
    bias = (-(shift[:, None] * k).sum(axis=0)).astype(np.float32)
    return k_folded, bias


def patch_tokens(
    images: torch.Tensor,
    kernel: torch.Tensor,
    patch: int,
    dtype=torch.float32,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, H, W, 3) -> (B, N, width) patch tokens: patchify + one matmul.

    Row order of `kernel` is (p_h, p_w, channel).  Used both with the
    normalize-folded kernel (uint8 inputs, cast to `dtype` on the device
    after the patch shuffle) and with the raw conv1 kernel (float inputs
    already preprocessed by a user transform)."""
    B, H, W, C = images.shape
    gh, gw = H // patch, W // patch
    x = (
        images.reshape(B, gh, patch, gw, patch, C)
        .permute(0, 1, 3, 2, 4, 5)
        .reshape(B, gh * gw, patch * patch * C)
        .to(dtype)
    )
    x = torch.matmul(x, kernel.to(dtype))
    if bias is not None:
        x = x + bias.to(dtype)
    return x
