"""Fused multi-head self-attention forward for CLIP's short sequences (K1).

`fused_attention(qkv, mask, heads)` takes the fused (B, T, 3W) projection
`x @ in_proj + b` as it comes out of the matmul and returns the
head-concatenated (B, T, W) attention output.  Head h's q, k and v are the
column slices at h*D, W + h*D and 2W + h*D (D = W / heads).  The mask is a
static spec: None (the vision tower) or "causal" (the text tower).

On a CUDA tensor the wrapper launches the hand-written kernel in
csrc/attention_fwd.cu, which reads the fused layout in place and never writes
the (B, H, T, T) scores to device memory.  On a CPU tensor it computes the
plain version, `attention_reference`, which performs the same arithmetic
with PyTorch operators.  There is no other path: anything the kernel does
not take raises.

Numerics (both versions): logits accumulate in fp32 and are scaled by
D^-0.5 after the dot; the softmax runs in fp32; the probabilities are rounded
to the input type before P.V, which accumulates in fp32.

Only the forward pass is here.  The backward kernel and the
`torch.autograd.Function` pairing the two arrive with the training slice, so
on CUDA a `qkv` that requires grad raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from menghini_neurips23_tpu_torch.ops import _cuda

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64)
_MAX_SMEM_BYTES = 227 * 1024  # per-block shared memory on an H100

_SIGNATURES = {
    "mnt_attention_fwd": (
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
        ctypes.c_int,
    ),
    "mnt_attention_fwd_smem": ([ctypes.c_int, ctypes.c_int], ctypes.c_size_t),
    **_cuda.ERROR_STRING,
}


def _check_mask(mask: Optional[str]) -> None:
    if mask not in (None, "causal"):
        raise ValueError(f"unknown mask spec {mask!r}; expected None or 'causal'")


def attention_reference(qkv: torch.Tensor, mask: Optional[str], heads: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel (head-split, as the JAX model's
    XLA path lays it out), with the kernel's fp32 accumulation."""
    _check_mask(mask)
    B, T, three_w = qkv.shape
    W = three_w // 3
    D = W // heads
    q, k, v = qkv.split(W, dim=-1)
    q = q.reshape(B, T, heads, D).transpose(1, 2).float()
    k = k.reshape(B, T, heads, D).transpose(1, 2).float()
    v = v.reshape(B, T, heads, D).transpose(1, 2).float()
    logits = torch.matmul(q, k.transpose(-1, -2)) * (D**-0.5)
    if mask == "causal":
        logits = logits + torch.triu(
            torch.full((T, T), float("-inf"), device=qkv.device), diagonal=1
        )
    attn = torch.softmax(logits, dim=-1).to(qkv.dtype).float()
    out = torch.matmul(attn, v).to(qkv.dtype)
    return out.transpose(1, 2).reshape(B, T, W)


def fused_attention(qkv: torch.Tensor, mask: Optional[str], heads: int) -> torch.Tensor:
    """(B, T, 3W) fused qkv -> (B, T, W) attention output.

    CPU tensors take `attention_reference`; CUDA tensors launch the kernel
    (counted in `fused_attention.launches`) or raise."""
    _check_mask(mask)
    if qkv.device.type == "cpu":
        return attention_reference(qkv, mask, heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"fused_attention: unsupported device {qkv.device}")
    if qkv.requires_grad:
        raise NotImplementedError(
            "fused_attention on CUDA is forward-only: the backward kernel and its "
            "autograd.Function arrive with the training slice"
        )
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"fused_attention: expected (B, T, 3W), got {tuple(qkv.shape)}")
    if qkv.dtype not in _DTYPE_CODES:
        raise ValueError(f"fused_attention: unsupported dtype {qkv.dtype} (float32 or bfloat16)")
    if not qkv.is_contiguous():
        raise ValueError("fused_attention: qkv must be contiguous")
    B, T, three_w = qkv.shape
    W = three_w // 3
    if W % heads or W // heads not in _HEAD_DIMS:
        raise ValueError(
            f"fused_attention: head width {W}/{heads} is not one of {_HEAD_DIMS}"
        )
    D = W // heads
    lib = _cuda.library("attention_fwd", _SIGNATURES)
    smem = lib.mnt_attention_fwd_smem(T, D)
    if smem > _MAX_SMEM_BYTES:
        raise ValueError(
            f"fused_attention: T={T} needs {smem} bytes of shared memory per block "
            f"(limit {_MAX_SMEM_BYTES})"
        )
    out = torch.empty((B, T, W), dtype=qkv.dtype, device=qkv.device)
    if B == 0 or T == 0:
        return out
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        code = lib.mnt_attention_fwd(
            qkv.data_ptr(), out.data_ptr(), B, T, W, heads, D**-0.5,
            int(mask == "causal"), _DTYPE_CODES[qkv.dtype], stream,
        )
    _cuda.check(lib, code, "fused_attention")
    fused_attention.launches += 1
    return out


fused_attention.launches = 0
