"""The fp32 schedules of the attention kernels up to 128 tokens (K1's
`attention_fwd_f32` and K2's `attention_bwd_f32`: every product as 3xTF32 on
the tensor cores), emulated in plain torch, against the JAX package's fused
attention and its custom VJP on the CPU.

The kernels themselves run only on a card (tests/test_torch_port_gpu.py
holds them against the port's plain versions there, at every length from 1
to 128).  What these tests pin is their arithmetic: the base-2 softmax over
every key a row sees at once (its exact max and sum, no online rescaling),
P normalised in fp32 before P.V, K2's row statistics (lse and r * D^-0.5)
handed from its query phase to its key phase, r taken from the fp32 P, dS
formed before dq and dk, and fp32 products as 3xTF32.  The JAX side runs
its Pallas kernels as its own tests do off-TPU (interpreted); the same numpy
inputs, made from a seed, go to both.

Tolerances: 1e-5 for the forward, 1e-5 + 1e-5 |ref| for the backward (its
gradients exceed 1 on unit-scale inputs), as on the card: sums run in
another order.  The fp32 products are emulated as the kernels form them:
each operand split on its bit pattern into a TF32 hi and lo, lo.hi + hi.lo
+ hi.hi summed in fp32; K1 rounds hi to nearest (split_tf32,
tests/torch_port_fixtures.py's mm_3xtf32), K2 cuts it toward zero, in two
operations where rounding takes four (split_tf32_trunc, `_mm_3xtf32_trunc`
here), which doubles a product's error and keeps it far inside the
tolerance.  One TF32 product alone misses those tolerances on the same
inputs, which is why the kernels take three.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from menghini_neurips23_tpu.ops.attention import fused_attention as jax_fused_attention
from menghini_neurips23_tpu_torch.ops.attention import attention_bwd_reference, attention_reference
from tests.torch_port_fixtures import _tf32_cut, mm_1xtf32, mm_3xtf32

torch.set_num_threads(2)

B, H = 2, 2
TOL = 1e-5
LOG2E = 1.4426950408889634
# T = 1: one key; 17: one past a 16-row tile; 24: CoOp's truncated text;
# 50: ViT-B/32 vision; 54: UPT's 4-token prompt; 66: VPT's 16-token prompt
# (80 of KC = 96 key slots); 77: the full text tower; 128: the longest
LENGTHS = [1, 17, 24, 50, 54, 66, 77, 128]


def _mm_3xtf32_trunc(a, b):
    """a @ b as K2 up to 128 tokens forms it: hi = x cut to TF32, lo = x - hi
    as the tensor core reads it (cut to TF32), lo.hi + hi.lo + hi.hi."""
    ah, bh = _tf32_cut(a), _tf32_cut(b)
    al, bl = _tf32_cut(a - ah), _tf32_cut(b - bh)
    return torch.matmul(al, bh) + torch.matmul(ah, bl) + torch.matmul(ah, bh)


def _inputs(T, D, seed, grad=False):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(0, 1, (B, T, 3 * H * D)).astype(np.float32)
    g = rng.normal(0, 1, (B, T, H * D)).astype(np.float32) if grad else None
    return qkv, g


def _heads(x, D):
    """(B, T, H*D) -> (B, H, T, D)."""
    return x.reshape(B, x.shape[1], H, D).transpose(1, 2)


def _merge(x):
    return x.transpose(1, 2).reshape(B, x.shape[2], -1)


def _masked(dots, mask):
    """-inf above the diagonal when causal; dots are (..., query, key)."""
    if mask != "causal":
        return dots
    T = dots.shape[-1]
    return dots.masked_fill(torch.ones(T, T, dtype=torch.bool).triu(1), float("-inf"))


def _scales(D):
    scale = torch.tensor(D**-0.5, dtype=torch.float32)
    return scale, scale * torch.tensor(LOG2E, dtype=torch.float32)


def _k1_short(qkv, mask, D, mm):
    """K1 fp32 up to 128 tokens: the scores of every key a row sees, scaled
    by D^-0.5 * log2(e), in one sweep; the exact row max m and sum l of
    2^(s - m); P = 2^(s - m) * (1 / l) in fp32, then P.V.  `mm` forms both
    products."""
    q, k, v = (_heads(t, D) for t in qkv.split(H * D, dim=-1))
    _, scale2 = _scales(D)
    s = _masked(mm(q, k.transpose(-1, -2)) * scale2, mask)
    e = torch.exp2(s - s.amax(-1, keepdim=True))
    p = e * (1 / e.sum(-1, keepdim=True))
    return _merge(mm(p, v))


def _k2_short(qkv, g, mask, D, mm):
    """K2 fp32 up to 128 tokens.  Phase A (query rows): the raw dots S of
    every key, the exact row max m and l = sum 2^(s c - m c) (c = D^-0.5
    log2(e)), lse = m c + log2(l), P = 2^(s c - lse), dP = g . v^T, r =
    rowsum(dP * P) and rs = r D^-0.5, dS = P (dP D^-0.5 - rs), dq = dS . k.
    Phase B (keys): S^T = k . q^T and dP^T = v . g^T formed anew, P^T and
    dS^T by the same expressions from the query rows' lse and rs, dv = P^T .
    g and dk = dS^T . q.  `mm` forms every product."""
    q, k, v = (_heads(t, D) for t in qkv.split(H * D, dim=-1))
    gh = _heads(g, D)
    scale, scale2 = _scales(D)
    # phase A
    dots = _masked(mm(q, k.transpose(-1, -2)), mask)
    m2 = dots.amax(-1, keepdim=True) * scale2
    lse = m2 + torch.log2(torch.exp2(dots * scale2 - m2).sum(-1, keepdim=True))
    p = torch.exp2(dots * scale2 - lse)
    dp = mm(gh, v.transpose(-1, -2))
    rs = (dp * p).sum(-1, keepdim=True) * scale
    dq = mm(p * (dp * scale - rs), k)
    # phase B, (key, query) tiles; the statistics by query
    pt = torch.exp2(_masked(mm(k, q.transpose(-1, -2)).transpose(-1, -2), mask) * scale2
                    - lse).transpose(-1, -2)
    dst = pt * (mm(v, gh.transpose(-1, -2)) * scale - rs.transpose(-1, -2))
    dv = mm(pt, gh)
    dk = mm(dst, q)
    return torch.cat([_merge(t) for t in (dq, dk, dv)], dim=-1)


def _jax_forward(qkv, mask):
    return np.asarray(jax_fused_attention(jnp.asarray(qkv), mask, H))


def _jax_vjp(qkv, g, mask):
    _, vjp = jax.vjp(lambda x: jax_fused_attention(x, mask, H), jnp.asarray(qkv))
    (want,) = vjp(jnp.asarray(g))
    return np.asarray(want)


def _bwd_close(got, want):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


# D = 64 at every length (ViT-B/32's and the text tower's head width), and
# one D = 32 case of each mask
CASES = [(T, 64) for T in LENGTHS] + [(77, 32)]


@pytest.mark.parametrize("T,D", CASES, ids=lambda x: str(x))
@pytest.mark.parametrize("mask", [None, "causal"], ids=["unmasked", "causal"])
def test_k1_short_fp32_schedule_matches_jax(mask, T, D):
    """K1's fp32 schedule up to 128 tokens on 3xTF32 products against the
    JAX package's fused attention (its Pallas forward, interpreted off-TPU)
    and the port's plain version, at 1e-5."""
    qkv, _ = _inputs(T, D, 600 + T + D)
    qkv_t = torch.from_numpy(qkv)
    got = _k1_short(qkv_t, mask, D, mm_3xtf32)
    assert got.dtype == torch.float32 and got.shape == (B, T, H * D)
    np.testing.assert_allclose(got.numpy(), _jax_forward(qkv, mask), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), attention_reference(qkv_t, mask, H).numpy(),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("T,D", CASES, ids=lambda x: str(x))
@pytest.mark.parametrize("mask", [None, "causal"], ids=["unmasked", "causal"])
def test_k2_short_fp32_schedule_matches_jax_vjp(mask, T, D):
    """K2's fp32 schedule up to 128 tokens (two phases, the row statistics
    handed from the query phase to the key phase) on 3xTF32 products of
    truncated splits against the JAX package's custom VJP (its Pallas
    backward, interpreted off-TPU) and the port's plain version, at 1e-5 +
    1e-5 |ref|."""
    qkv, g = _inputs(T, D, 700 + T + D, grad=True)
    qkv_t, g_t = torch.from_numpy(qkv), torch.from_numpy(g)
    got = _k2_short(qkv_t, g_t, mask, D, _mm_3xtf32_trunc)
    assert got.dtype == torch.float32 and got.shape == (B, T, 3 * H * D)
    _bwd_close(got.numpy(), _jax_vjp(qkv, g, mask))
    _bwd_close(got.numpy(), attention_bwd_reference(qkv_t, g_t, mask, H).numpy())


@pytest.mark.parametrize("mask", [None, "causal"], ids=["unmasked", "causal"])
def test_k1_short_fp32_needs_three_tf32_products(mask):
    """At the text tower's T = 77, K1's fp32 schedule on one TF32 product a
    product errs against the JAX package's forward by far more than the
    kernel's 1e-5 (7.9e-4 unmasked, 1.3e-3 causal), and on 3xTF32 by less
    than a fifth of it (7.2e-7 and 9.5e-7, much of it the two sides' own
    fp32 sums): the kernel takes three."""
    T, D = 77, 64
    qkv, _ = _inputs(T, D, 600 + T + D)
    want = _jax_forward(qkv, mask)
    err = {name: float(np.abs(_k1_short(torch.from_numpy(qkv), mask, D, mm).numpy()
                              - want).max())
           for name, mm in (("one", mm_1xtf32), ("three", mm_3xtf32))}
    assert err["one"] > TOL, err
    assert err["three"] < TOL / 5, err


@pytest.mark.parametrize("mask", [None, "causal"], ids=["unmasked", "causal"])
def test_k2_short_fp32_needs_three_tf32_products(mask):
    """At T = 77, K2's fp32 schedule on one TF32 product a product misses
    1e-5 + 1e-5 |ref| against the JAX package's custom VJP (by 7.8e-4
    unmasked and 1.9e-3 causal past the relative part); on 3xTF32 it meets
    it, with hi rounded (max abs error 1.0e-6 and 1.9e-6) and with hi cut as
    the kernel cuts it (1.8e-6 and 3.1e-6, past the relative part by under
    1e-6): the kernel takes three, and the cheaper split costs no margin
    that matters."""
    T, D = 77, 64
    qkv, g = _inputs(T, D, 700 + T + D, grad=True)
    want = _jax_vjp(qkv, g, mask)
    excess = {name: float((np.abs(_k2_short(torch.from_numpy(qkv), torch.from_numpy(g), mask,
                                            D, mm).numpy() - want)
                           - TOL * np.abs(want)).max())
              for name, mm in (("one", mm_1xtf32), ("three", mm_3xtf32),
                               ("three_cut", _mm_3xtf32_trunc))}
    assert excess["one"] > TOL, excess
    assert excess["three"] <= TOL, excess
    assert excess["three_cut"] < TOL / 10, excess
