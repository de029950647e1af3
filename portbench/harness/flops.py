"""The algorithm's operations and bytes, counted from shapes, and the peaks.

These count the work the mathematics needs, not what a kernel happens to do:
an fp32 matmul is its 2*M*N*K operations whatever precision trick computes
it, and the backward to the prompt counts input gradients only (the towers
are frozen) with no recomputation.  A causal attention counts the T(T+1)/2
query-key pairs it needs.  LayerNorms, softmaxes and elementwise work are
left out: they are a few percent of the operations at these widths.

Bytes count each input read once and each output written once.

Peaks (NVIDIA H100 SXM data sheet, dense, at its 700 W limit): 495 TFLOP/s
TF32 (the peak fp32 is held against: a matmul of fp32 data on the tensor
cores runs there), 989 TFLOP/s bf16, 3.35 TB/s HBM.
"""

from __future__ import annotations

PEAK_FLOPS = {"float32": 495e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12
ELT = {"float32": 4, "bfloat16": 2}


def pairs(T: int, causal: bool) -> float:
    return T * (T + 1) / 2 if causal else T * T


def attn_fwd_flops(B, T, H, D, causal):
    """S = q k^T and O = P v: two products over the needed pairs."""
    return 4.0 * B * H * D * pairs(T, causal)


def attn_bwd_flops(B, T, H, D, causal):
    """dv = P^T g, dP = g v^T, dq = dS k, dk = dS^T q (no recomputation of S)."""
    return 8.0 * B * H * D * pairs(T, causal)


def attn_fwd_bytes(B, T, H, D, dtype):
    """qkv (B, T, 3W) read, the output (B, T, W) written."""
    return 4.0 * B * T * H * D * ELT[dtype]


def attn_bwd_bytes(B, T, H, D, dtype):
    """qkv and the output gradient read, dqkv written."""
    return 7.0 * B * T * H * D * ELT[dtype]


def head_flops(B, C, E):
    """K3: the (B, E) x (E, C) product."""
    return 2.0 * B * C * E


def head_bytes(B, C, E, dtype):
    """K3: image and text features read, fp32 probabilities written."""
    return ELT[dtype] * (B * E + C * E) + 4.0 * B * C


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def layer_linear_flops(tokens: int, width: int) -> float:
    """qkv (3W^2), out_proj (W^2), c_fc and c_proj (4W^2 each) per token."""
    return 2.0 * tokens * width * width * (3 + 1 + 4 + 4)


def tower_flops(B, T, width, heads, layers, causal, backward=False):
    """A tower's blocks over (B, T) tokens: forward, or the backward to the
    input (the same linear work plus the attention backward)."""
    D = width // heads
    attn = (attn_bwd_flops if backward else attn_fwd_flops)(B, T, heads, D, causal)
    return layers * (layer_linear_flops(B * T, width) + attn)
