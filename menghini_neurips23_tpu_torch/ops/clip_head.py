"""The fused CLIP head (K3): normalize -> scaled logits -> softmax.

Every zero-shot and pseudolabel path ends in

    p = softmax(scale * (img / ||img||) @ (txt / ||txt||).T)

`fused_probs` computes it in one pass.  On a CUDA tensor it launches the
hand-written kernel in csrc/clip_head.cu: the (B, E) image features are read
once and no (B, C) logits round-trip through device memory.  On a CPU tensor
it computes the plain version, `fused_probs_reference`, which performs the
same fp32 arithmetic (rsqrt-normalise, dot, scale, row softmax) with PyTorch
operators.  C and E are taken as given: the class count is not padded.
"""

from __future__ import annotations

import ctypes

import torch

from menghini_neurips23_tpu_torch.ops import _cuda

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_E = 1024
_MAX_SMEM_BYTES = 227 * 1024  # per-block shared memory on an H100

_SIGNATURES = {
    "mnt_clip_head": (
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
        ctypes.c_int,
    ),
    "mnt_clip_head_smem": ([ctypes.c_int, ctypes.c_int], ctypes.c_size_t),
    **_cuda.ERROR_STRING,
}


def fused_probs_reference(img_feats: torch.Tensor, txt_feats: torch.Tensor, scale) -> torch.Tensor:
    """Plain PyTorch version of the kernel: fp32 (B, C) probabilities."""
    img = img_feats.float()
    txt = txt_feats.float()
    img = img * torch.rsqrt((img * img).sum(-1, keepdim=True))
    txt = txt * torch.rsqrt((txt * txt).sum(-1, keepdim=True))
    logits = (img @ txt.T) * float(scale)
    return torch.softmax(logits, dim=-1)


def fused_probs(img_feats: torch.Tensor, txt_feats: torch.Tensor, scale) -> torch.Tensor:
    """softmax(scale * normalize(img) @ normalize(txt).T) as fp32 (B, C).

    :param img_feats: (B, E) unnormalized image features
    :param txt_feats: (C, E) unnormalized text features, same dtype and device
    :param scale: CLIP logit scale (exp(logit_scale)), a Python float
    CPU tensors take `fused_probs_reference`; CUDA tensors launch the kernel
    (counted in `fused_probs.launches`) or raise."""
    if img_feats.device != txt_feats.device:
        raise ValueError(
            f"fused_probs: img on {img_feats.device}, txt on {txt_feats.device}"
        )
    if img_feats.device.type == "cpu":
        return fused_probs_reference(img_feats, txt_feats, scale)
    if img_feats.device.type != "cuda":
        raise ValueError(f"fused_probs: unsupported device {img_feats.device}")
    if img_feats.dim() != 2 or txt_feats.dim() != 2 or img_feats.shape[1] != txt_feats.shape[1]:
        raise ValueError(
            f"fused_probs: expected (B, E) and (C, E), got {tuple(img_feats.shape)} "
            f"and {tuple(txt_feats.shape)}"
        )
    if img_feats.dtype != txt_feats.dtype or img_feats.dtype not in _DTYPE_CODES:
        raise ValueError(
            f"fused_probs: img and txt must share a dtype of float32 or bfloat16, got "
            f"{img_feats.dtype} and {txt_feats.dtype}"
        )
    if not (img_feats.is_contiguous() and txt_feats.is_contiguous()):
        raise ValueError("fused_probs: img and txt must be contiguous")
    B, E = img_feats.shape
    C = txt_feats.shape[0]
    if E > _MAX_E:
        raise ValueError(f"fused_probs: feature width {E} exceeds {_MAX_E}")
    lib = _cuda.library("clip_head", _SIGNATURES)
    smem = lib.mnt_clip_head_smem(C, E)
    if smem > _MAX_SMEM_BYTES:
        raise ValueError(
            f"fused_probs: C={C}, E={E} need {smem} bytes of shared memory per block "
            f"(limit {_MAX_SMEM_BYTES})"
        )
    out = torch.empty((B, C), dtype=torch.float32, device=img_feats.device)
    if B == 0 or C == 0:
        return out
    with torch.cuda.device(img_feats.device):
        stream = torch.cuda.current_stream(img_feats.device).cuda_stream
        code = lib.mnt_clip_head(
            img_feats.data_ptr(), txt_feats.data_ptr(), out.data_ptr(), B, C, E,
            float(scale), _DTYPE_CODES[img_feats.dtype], stream,
        )
    _cuda.check(lib, code, "fused_probs")
    fused_probs.launches += 1
    return out


fused_probs.launches = 0
