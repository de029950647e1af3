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
holds the group's q, k, v and fp32 logits in shared memory, G being the
largest divisor of `heads` that fits.  A T whose single head does not fit a
block (above 176 tokens in bf16, 144 in fp32, at D = 64) raises.  On a CPU
tensor it takes `twophase_attention_reference`, the plain version in the
same phase order.  There is no backward: neither has the Pallas kernel.
"""

from __future__ import annotations

import ctypes

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
         ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
        ctypes.c_int,
    ),
    "mnt_twophase_attention_groups": ([ctypes.c_int] * 4, ctypes.c_int),
    "mnt_twophase_attention_smem": ([ctypes.c_int] * 4, ctypes.c_size_t),
    **_cuda.ERROR_STRING,
}


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


def twophase_attention(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, T, 3W) fused qkv -> (B, T, W) attention output, unmasked.

    CPU tensors take `twophase_attention_reference`; CUDA tensors launch
    the kernel (counted in `twophase_attention.launches`) or raise."""
    if qkv.requires_grad and torch.is_grad_enabled():
        raise ValueError("twophase_attention has no backward (nor has the Pallas kernel it ports)")
    if qkv.device.type == "cpu":
        return twophase_attention_reference(qkv, heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"twophase_attention: unsupported device {qkv.device}")
    D = _check_cuda_qkv("twophase_attention", qkv, heads)
    B, T, three_w = qkv.shape
    W = three_w // 3
    code = _DTYPE_CODES[qkv.dtype]
    lib = _cuda.library("twophase_attention", _SIGNATURES)
    if lib.mnt_twophase_attention_groups(T, D, heads, code) == 0:
        smem = lib.mnt_twophase_attention_smem(T, D, heads, code)
        raise ValueError(
            f"twophase_attention: T={T} needs {smem} bytes of shared memory per block for "
            f"one head (limit {_MAX_SMEM_BYTES})"
        )
    out = torch.empty((B, T, W), dtype=qkv.dtype, device=qkv.device)
    if B == 0 or T == 0:
        return out
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = lib.mnt_twophase_attention(
            qkv.data_ptr(), out.data_ptr(), B, T, W, heads, D**-0.5, code, stream
        )
    _cuda.check(lib, err, "twophase_attention")
    twophase_attention.launches += 1
    return out


twophase_attention.launches = 0
