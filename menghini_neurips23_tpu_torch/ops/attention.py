"""Fused multi-head self-attention for CLIP's short sequences: the forward
kernel (K1), the backward kernel (K2) and the autograd pairing of the two.

`fused_attention(qkv, mask, heads)` takes the fused (B, T, 3W) projection
`x @ in_proj + b` as it comes out of the matmul and returns the
head-concatenated (B, T, W) attention output.  Head h's q, k and v are the
column slices at h*D, W + h*D and 2W + h*D (D = W / heads).  The mask is a
static spec: None (the vision tower) or "causal" (the text tower).

On a CUDA tensor the forward launches the hand-written kernel in
csrc/attention_fwd.cu and the backward the one in csrc/attention_bwd.cu; both
read the fused layout in place and never write the (B, H, T, T) scores to
device memory.  On a CPU tensor each takes its plain version,
`attention_reference` and `attention_bwd_reference`, which perform the same
arithmetic with PyTorch operators.  There is no other path: anything a
kernel does not take raises.  Both kernels take any T at head widths 16, 32
and 64: above 128 tokens neither keeps a T x T tile.  In bf16 up to 320
tokens both hold the head (K and V; the backward also q and g) in shared
memory; past that, and in fp32 past 128, they stream it through shared
memory in chunks.

When `qkv` requires grad (and grad mode is on) the call goes through
`FusedAttention`, a `torch.autograd.Function` that saves only `qkv` and
recomputes the softmax in the backward, as the JAX package's custom VJP does.

Numerics (both directions, both versions): logits accumulate in fp32 and are
scaled by D^-0.5 after the dot; the softmax runs in fp32.  Forward: the
probabilities are rounded to the input type before P.V.  Backward:
dv = P_lp^T g with P rounded to the input type; datt = g v^T in fp32;
dS = P * (datt - rowsum(datt * P)) with the fp32 P, times the scale, rounded
to the input type; dq = dS k and dk = dS^T q.  Every product accumulates in
fp32; outputs are cast to the input type.  In bf16 this gradient is not
autograd of the bf16 forward (dS uses the fp32 P); in fp32 the two agree.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from menghini_neurips23_tpu_torch.ops import _cuda

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64)
_MAX_SMEM_BYTES = 227 * 1024  # per-block shared memory on an H100
# up to this many tokens K1 keeps a warp's scores in its registers
# (kShortMaxSeq in csrc/attention_fwd.cu); past it, up to the resident
# length, bf16 holds the head in shared memory (attention_fwd_resident)
_FWD_SHORT_MAX_SEQ = 128

_FWD_SIGNATURES = {
    "mnt_attention_fwd": (
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
        ctypes.c_int,
    ),
    "mnt_attention_fwd_smem": ([ctypes.c_int, ctypes.c_int, ctypes.c_int], ctypes.c_size_t),
    "mnt_attention_fwd_resident_max_seq": ([ctypes.c_int], ctypes.c_int),
    **_cuda.ERROR_STRING,
}

_BWD_SIGNATURES = {
    "mnt_attention_bwd": (
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
         ctypes.c_void_p],
        ctypes.c_int,
    ),
    "mnt_attention_bwd_smem": ([ctypes.c_int, ctypes.c_int], ctypes.c_size_t),
    "mnt_attention_bwd_resident_max_seq": ([], ctypes.c_int),
    "mnt_attention_bwd_warps": ([ctypes.c_int, ctypes.c_int, ctypes.c_int], ctypes.c_int),
    "mnt_attention_bwd_workspace": (
        [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int], ctypes.c_size_t
    ),
    **_cuda.ERROR_STRING,
}


def _check_mask(mask: Optional[str]) -> None:
    if mask not in (None, "causal"):
        raise ValueError(f"unknown mask spec {mask!r}; expected None or 'causal'")


def _split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, T, heads*D) -> (B, heads, T, D) fp32."""
    B, T, W = x.shape
    return x.reshape(B, T, heads, W // heads).transpose(1, 2).float()


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, heads, T, D) -> (B, T, heads*D)."""
    B, H, T, D = x.shape
    return x.transpose(1, 2).reshape(B, T, H * D)


def _softmax_fp32(q: torch.Tensor, k: torch.Tensor, mask: Optional[str]) -> torch.Tensor:
    """fp32 softmax of the scaled logits, (B, H, T, T)."""
    T, D = q.shape[-2], q.shape[-1]
    logits = torch.matmul(q, k.transpose(-1, -2)) * (D**-0.5)
    if mask == "causal":
        logits = logits + torch.triu(
            torch.full((T, T), float("-inf"), device=q.device), diagonal=1
        )
    return torch.softmax(logits, dim=-1)


def attention_reference(qkv: torch.Tensor, mask: Optional[str], heads: int) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel (head-split, as the JAX
    model's XLA path lays it out), with the kernel's fp32 accumulation."""
    _check_mask(mask)
    W = qkv.shape[-1] // 3
    q, k, v = (_split_heads(t, heads) for t in qkv.split(W, dim=-1))
    attn = _softmax_fp32(q, k, mask).to(qkv.dtype).float()
    return _merge_heads(torch.matmul(attn, v).to(qkv.dtype))


def attention_bwd_reference(
    qkv: torch.Tensor, g: torch.Tensor, mask: Optional[str], heads: int
) -> torch.Tensor:
    """Plain PyTorch version of the backward kernel: (B, T, 3W) qkv and the
    (B, T, W) output gradient -> (B, T, 3W) dqkv, step by step as the Pallas
    kernel `_bwd_kernel` computes it."""
    _check_mask(mask)
    dt = qkv.dtype
    W = qkv.shape[-1] // 3
    D = W // heads
    q, k, v = (_split_heads(t, heads) for t in qkv.split(W, dim=-1))
    gh = _split_heads(g, heads)
    attn = _softmax_fp32(q, k, mask)
    attn_lp = attn.to(dt).float()
    dv = torch.matmul(attn_lp.transpose(-1, -2), gh)
    datt = torch.matmul(gh, v.transpose(-1, -2))
    ds = attn * (datt - (datt * attn).sum(-1, keepdim=True))
    ds = (ds * (D**-0.5)).to(dt).float()
    dq = torch.matmul(ds, k)
    dk = torch.matmul(ds.transpose(-1, -2), q)
    return torch.cat([_merge_heads(t.to(dt)) for t in (dq, dk, dv)], dim=-1)


def _check_cuda_qkv(what: str, qkv: torch.Tensor, heads: int) -> int:
    """Validate a CUDA qkv for the kernels; returns the head width D."""
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"{what}: expected (B, T, 3W), got {tuple(qkv.shape)}")
    if qkv.dtype not in _DTYPE_CODES:
        raise ValueError(f"{what}: unsupported dtype {qkv.dtype} (float32 or bfloat16)")
    if not qkv.is_contiguous():
        raise ValueError(f"{what}: qkv must be contiguous")
    if qkv.data_ptr() % 16:  # the kernels stage rows with 16-byte copies
        raise ValueError(f"{what}: qkv must be 16-byte aligned")
    W = qkv.shape[-1] // 3
    if W % heads or W // heads not in _HEAD_DIMS:
        raise ValueError(f"{what}: head width {W}/{heads} is not one of {_HEAD_DIMS}")
    return W // heads


def _check_smem(what: str, smem: int, T: int) -> None:
    if smem > _MAX_SMEM_BYTES:
        raise ValueError(
            f"{what}: T={T} needs {smem} bytes of shared memory per block "
            f"(limit {_MAX_SMEM_BYTES})"
        )


def _forward(qkv: torch.Tensor, mask: Optional[str], heads: int) -> torch.Tensor:
    """The forward without autograd: plain version on the CPU, K1 on CUDA."""
    if qkv.device.type == "cpu":
        return attention_reference(qkv, mask, heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"fused_attention: unsupported device {qkv.device}")
    D = _check_cuda_qkv("fused_attention", qkv, heads)
    B, T, three_w = qkv.shape
    W = three_w // 3
    code = _DTYPE_CODES[qkv.dtype]
    lib = _cuda.library("attention_fwd", _FWD_SIGNATURES)
    _check_smem("fused_attention", lib.mnt_attention_fwd_smem(T, D, code), T)
    out = torch.empty((B, T, W), dtype=qkv.dtype, device=qkv.device)
    if B == 0 or T == 0:
        return out
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = lib.mnt_attention_fwd(
            qkv.data_ptr(), out.data_ptr(), B, T, W, heads, D**-0.5,
            int(mask == "causal"), code, stream,
        )
    _cuda.check(lib, err, "fused_attention")
    fused_attention.launches += 1
    if T > lib.mnt_attention_fwd_resident_max_seq(code):
        fused_attention.streamed_launches += 1
    elif T > _FWD_SHORT_MAX_SEQ:
        fused_attention.resident_launches += 1
    return out


def attention_bwd(
    qkv: torch.Tensor, g: torch.Tensor, mask: Optional[str], heads: int
) -> torch.Tensor:
    """(B, T, 3W) qkv + (B, T, W) output gradient -> (B, T, 3W) dqkv.

    CPU tensors take `attention_bwd_reference`; CUDA tensors launch the
    kernel (counted in `attention_bwd.launches`, one per call, and above 320
    tokens in `attention_bwd.streamed_launches` too) or raise.  A
    call is one grid launch, except fp32 above 128 tokens and bf16 above
    320: two (the query side, then the key side), on an fp32 workspace of
    the row statistics allocated here, B*H*round64(T)*12 bytes in fp32 and
    B*H*round64(T)*8 in bf16."""
    _check_mask(mask)
    if qkv.device != g.device:
        raise ValueError(f"attention_bwd: qkv on {qkv.device}, g on {g.device}")
    if qkv.device.type == "cpu":
        return attention_bwd_reference(qkv, g, mask, heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"attention_bwd: unsupported device {qkv.device}")
    D = _check_cuda_qkv("attention_bwd", qkv, heads)
    B, T, three_w = qkv.shape
    W = three_w // 3
    if g.shape != (B, T, W) or g.dtype != qkv.dtype or not g.is_contiguous() or g.data_ptr() % 16:
        raise ValueError(
            f"attention_bwd: g must be a contiguous, 16-byte aligned {(B, T, W)} {qkv.dtype} "
            f"tensor, got {tuple(g.shape)} {g.dtype} (contiguous: {g.is_contiguous()})"
        )
    lib = _cuda.library("attention_bwd", _BWD_SIGNATURES)
    _check_smem("attention_bwd", lib.mnt_attention_bwd_smem(T, D), T)
    dqkv = torch.empty_like(qkv)
    if B == 0 or T == 0:
        return dqkv
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        # the streamed pair's row statistics, held here until the launch is queued
        ws_bytes = lib.mnt_attention_bwd_workspace(B, T, heads, _DTYPE_CODES[qkv.dtype])
        ws = (torch.empty(ws_bytes // 4, dtype=torch.float32, device=qkv.device)
              if ws_bytes else None)
        code = lib.mnt_attention_bwd(
            qkv.data_ptr(), g.data_ptr(), dqkv.data_ptr(), None if ws is None else ws.data_ptr(),
            B, T, W, heads, D**-0.5, int(mask == "causal"), _DTYPE_CODES[qkv.dtype], stream,
        )
    _cuda.check(lib, code, "attention_bwd")
    attention_bwd.launches += 1
    if T > lib.mnt_attention_bwd_resident_max_seq():
        attention_bwd.streamed_launches += 1
    return dqkv


# launches, and those above 320 tokens (the streamed forms) apart
attention_bwd.launches = attention_bwd.streamed_launches = 0


class FusedAttention(torch.autograd.Function):
    """K1 forward, K2 backward (their plain versions on the CPU).  Saves only
    qkv; the backward recomputes the softmax."""

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, mask: Optional[str], heads: int) -> torch.Tensor:
        qkv = qkv.contiguous()
        ctx.save_for_backward(qkv)
        ctx.mask, ctx.heads = mask, heads
        return _forward(qkv, mask, heads)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (qkv,) = ctx.saved_tensors
        return attention_bwd(qkv, g.contiguous(), ctx.mask, ctx.heads), None, None


def fused_attention(qkv: torch.Tensor, mask: Optional[str], heads: int) -> torch.Tensor:
    """(B, T, 3W) fused qkv -> (B, T, W) attention output.

    CPU tensors take `attention_reference`; CUDA tensors launch the kernel
    (counted in `fused_attention.launches`; where it streams K and V - bf16
    above 320 tokens, fp32 above 128 - in `fused_attention.streamed_launches`
    too, and where bf16 holds them resident above 128 tokens in
    `fused_attention.resident_launches`) or raise.  A qkv that requires
    grad goes through `FusedAttention`, whose backward is `attention_bwd`."""
    _check_mask(mask)
    if qkv.requires_grad and torch.is_grad_enabled():
        return FusedAttention.apply(qkv, mask, heads)
    return _forward(qkv, mask, heads)


fused_attention.launches = fused_attention.streamed_launches = 0
fused_attention.resident_launches = 0
