"""Phase-grouped multi-head self-attention forward (K4).

`twophase_attention(qkv, heads)` computes what `fused_attention(qkv, None,
heads)` computes (unmasked; K1's numerics: fp32 logits scaled by D^-0.5
after the dot, an fp32 softmax, P rounded to the input type before P.V,
fp32 accumulation, outputs in the input type), in another order: all the
heads' logits first, then all their softmaxes, then all their P.V.  It is
the counterpart of the attention experiment's `twophase` variant
(`scripts/exp_attn_kernels.py`), which asks whether grouping the products
by phase beats the fused per-tile form.  No model of the package calls it.

On a CUDA tensor it launches the hand-written kernel in
csrc/twophase_attention.cu: one block per (batch row, group of G heads)
holds the group's k, v and fp32 logits (q staged under the logits) in
shared memory.  `group` is G; left out, the kernel picks the divisor of
`heads` that keeps the most warps resident (G = 1 at the experiment's
(256, 66, 768, 12)).  A G that does not divide `heads`, or whose block does
not fit 227 KB, raises ValueError on any device; on the card so does a T
whose single head does not fit (above 192 tokens in bf16, 176 in fp32, at
D = 64).  On a CPU tensor it takes `twophase_attention_reference`, the
plain version in the same phase order, which ignores G.  There is no
backward: neither has the Pallas kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from menghini_neurips23_tpu_torch.ops import _cuda
from menghini_neurips23_tpu_torch.ops.attention import (
    _DTYPE_CODES,
    _MAX_SMEM_BYTES,
    _check_cuda_qkv,
    _split_heads,
)

_SIGNATURES = {
    "mnt_twophase_attention": (
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
        ctypes.c_int,
    ),
    "mnt_twophase_attention_groups": ([ctypes.c_int] * 5, ctypes.c_int),
    "mnt_twophase_attention_blocks_per_sm": ([ctypes.c_int] * 5, ctypes.c_int),
    "mnt_twophase_attention_smem": ([ctypes.c_int] * 4, ctypes.c_size_t),
    **_cuda.ERROR_STRING,
}


def twophase_smem_bytes(seq: int, head_dim: int, group: int, dtype: torch.dtype) -> int:
    """Bytes of shared memory a block of `group` heads takes, as
    csrc/twophase_attention.cu lays it out: per head the fp32 logits of
    round16(seq) rows of round16(seq) + 8 floats (q staged at their end,
    where they are larger), then k and v rows of D + 8 (bf16) or D + 4
    (fp32) elements."""
    tp = -(-seq // 16) * 16
    elem = 2 if dtype == torch.bfloat16 else 4
    stage = tp * (head_dim + (8 if elem == 2 else 4)) * elem
    return group * (max(tp * (tp + 8) * 4, stage) + 2 * stage)


def _check_group(qkv: torch.Tensor, heads: int, group: Optional[int]) -> None:
    """Raise unless one head (group None) or `group` heads fit a block."""
    T, W = qkv.shape[1], qkv.shape[2] // 3
    g = 1 if group is None else group
    if group is not None and (not isinstance(group, int) or group < 1 or heads % group):
        raise ValueError(f"twophase_attention: group={group!r} does not divide heads={heads}")
    smem = twophase_smem_bytes(T, W // heads, g, qkv.dtype)
    if smem > _MAX_SMEM_BYTES:
        what = "one head" if group is None else f"group={group}"
        raise ValueError(
            f"twophase_attention: T={T} needs {smem} bytes of shared memory per block for "
            f"{what} (limit {_MAX_SMEM_BYTES})"
        )


def twophase_attention_reference(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel, phase by phase as the Pallas
    kernel `_twophase_fwd_kernel` runs: every head's fp32 logits into one
    (heads, B, T, T) scratch, then every head's softmax in place, then
    every head's P.V with P rounded to the input type."""
    dt = qkv.dtype
    B, T, three_w = qkv.shape
    W = three_w // 3
    D = W // heads
    q, k, v = (_split_heads(t, heads) for t in qkv.split(W, dim=-1))
    logits = qkv.new_empty((heads, B, T, T), dtype=torch.float32)
    for h in range(heads):
        logits[h] = torch.matmul(q[:, h], k[:, h].transpose(-1, -2)) * (D**-0.5)
    for h in range(heads):
        logits[h] = torch.softmax(logits[h], dim=-1)
    out = qkv.new_empty((B, T, W))
    for h in range(heads):
        out[:, :, h * D:(h + 1) * D] = torch.matmul(logits[h].to(dt).float(), v[:, h]).to(dt)
    return out


def twophase_attention(qkv: torch.Tensor, heads: int, group: Optional[int] = None) -> torch.Tensor:
    """(B, T, 3W) fused qkv -> (B, T, W) attention output, unmasked.

    `group`: the heads a block of the kernel takes (None: the kernel's own
    choice); checked on every device, used only by the kernel.  CPU tensors
    take `twophase_attention_reference`; CUDA tensors launch the kernel
    (counted in `twophase_attention.launches`) or raise."""
    if qkv.requires_grad and torch.is_grad_enabled():
        raise ValueError("twophase_attention has no backward (nor has the Pallas kernel it ports)")
    if qkv.device.type not in ("cpu", "cuda"):
        raise ValueError(f"twophase_attention: unsupported device {qkv.device}")
    if qkv.dim() != 3 or qkv.shape[-1] % 3 or (qkv.shape[-1] // 3) % heads:
        raise ValueError(f"twophase_attention: expected (B, T, 3W) with W a multiple of "
                         f"heads={heads}, got {tuple(qkv.shape)}")
    if qkv.device.type == "cpu":
        if group is not None:
            _check_group(qkv, heads, group)
        return twophase_attention_reference(qkv, heads)
    D = _check_cuda_qkv("twophase_attention", qkv, heads)
    _check_group(qkv, heads, group)
    B, T, three_w = qkv.shape
    W = three_w // 3
    out = torch.empty((B, T, W), dtype=qkv.dtype, device=qkv.device)
    if B == 0 or T == 0:
        return out
    lib = _cuda.library("twophase_attention", _SIGNATURES)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = lib.mnt_twophase_attention(
            qkv.data_ptr(), out.data_ptr(), B, T, W, heads, D**-0.5, _DTYPE_CODES[qkv.dtype],
            group or 0, stream
        )
    _cuda.check(lib, err, "twophase_attention")
    twophase_attention.launches += 1
    return out


twophase_attention.launches = 0
