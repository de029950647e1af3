"""The schedules of the attention kernels above 128 tokens (K1's forward: in
bf16 with K and V resident up to 320 and streamed past it, both forms on one
schedule, and in fp32 on warpgroup MMA; K2's pair of launches, in fp32 from
129 tokens on warpgroup MMA and in bf16 past 320), emulated in plain torch,
against the JAX package's fused attention and its custom VJP on the CPU.
The fp32 forms' schedules are tests/torch_port_fixtures.py's
`k1_wgmma_tf32` and `k2_wgmma_tf32` (tests/test_torch_port_wgmma_tf32.py and
test_torch_port_wgmma_bwd_tf32.py hold them at more lengths).

The kernels themselves run only on a card (tests/test_torch_port_gpu.py
holds them against the port's plain versions there).  What these tests pin
is their arithmetic: the order of the sums, the base-2 softmax, the row
statistics the two sweeps (and the two launches of the backward) hand on,
the rounding points, and, in fp32, 3xTF32 products on the tensor cores,
chained k-step by k-step as the kernels chain them.
The JAX side runs its Pallas kernels as its own tests do off-TPU
(interpreted); the same numpy inputs, made from a seed, go to both.

Tolerances: fp32 1e-5 and bf16 2e-2, as in tests/test_torch_port_ops.py
(both sides round the probabilities, dS and the outputs to bf16 at the same
points; sums run in another order).  The fp32 products are emulated as the
kernels form them: each operand x split on its bit pattern into hi (x
rounded to TF32's 10 fraction bits, to nearest, ties away from zero, as
cvt.rna.tf32.f32 rounds) and lo (x - hi cut to TF32), and lo.hi, hi.lo and
hi.hi summed in fp32.  One TF32 product alone misses 1e-5 on the same
inputs, which is why the kernels take three.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from menghini_neurips23_tpu.ops.attention import fused_attention as jax_fused_attention
from menghini_neurips23_tpu_torch.ops.attention import attention_bwd_reference, attention_reference
from tests.torch_port_fixtures import k1_wgmma_tf32, k2_wgmma_tf32

torch.set_num_threads(2)

_DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
           "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
B, H, D = 2, 2, 64
# the keys of one update of a row's statistics: K1 bf16's 64-key chunks
# (resident or streamed) and K2 bf16's pair's query side's 64-key chunks
# (one online update a chunk on warpgroup MMA)
K1_CHUNK = 64
K2_STEP = 64
LOG2E = 1.4426950408889634


def _inputs(T, seed, grad=False):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(0, 1, (B, T, 3 * H * D)).astype(np.float32)
    g = rng.normal(0, 1, (B, T, H * D)).astype(np.float32) if grad else None
    return qkv, g


def _heads(x):
    """(B, T, H*D) -> (B, H, T, D) fp32."""
    return x.reshape(B, x.shape[1], H, D).transpose(1, 2).float()


def _merge(x):
    return x.transpose(1, 2).reshape(B, x.shape[2], H * D)


def _mm_plain(a, b):
    return torch.matmul(a, b)


def _causal_mask(T):
    return torch.ones(T, T, dtype=torch.bool).triu(1)


def _k1_streamed(qkv, mask, chunk, mm):
    """K1's schedule above 128 tokens (resident or streamed): scores scaled
    by D^-0.5 * log2(e); sweep 1 in steps of `chunk` keys keeps each row's
    online max m and sum l of 2^(s - m), rescaling l when m grows; sweep 2
    recomputes the scores and forms P = 2^(s - m) * (1 / l) in fp32, rounds
    it to the input type and multiplies it by V.  `mm` forms every product
    (Q.K^T in both sweeps, P.V)."""
    dt = qkv.dtype
    T = qkv.shape[1]
    q, k, v = (_heads(t) for t in qkv.split(H * D, dim=-1))
    scale2 = torch.tensor(D**-0.5, dtype=torch.float32) * torch.tensor(LOG2E, dtype=torch.float32)

    def scores():
        s = mm(q, k.transpose(-1, -2)) * scale2
        return s.masked_fill(_causal_mask(T), float("-inf")) if mask == "causal" else s

    s = scores()
    m = torch.full((B, H, T, 1), float("-inf"))
    l = torch.zeros(B, H, T, 1)
    for c0 in range(0, T, chunk):  # key 0 keeps every row's m finite after chunk 0
        sc = s[..., c0:c0 + chunk]
        mn = torch.maximum(m, sc.amax(-1, keepdim=True))
        l = l * torch.exp2(m - mn) + torch.exp2(sc - mn).sum(-1, keepdim=True)
        m = mn
    p = torch.exp2(scores() - m) * (1 / l)
    out = mm(p.to(dt).float(), v)
    return _merge(out).to(dt)


def _jax_forward(qkv, mask, jdt):
    out = jax_fused_attention(jnp.asarray(qkv).astype(jdt), mask, H)
    return np.asarray(out.astype(jnp.float32))


# T = 129: one key past a single 128-key chunk; 200: a ragged last chunk
# (64 and 32 keys, 16-row tiles); 273: ViT-L/14 with a 16-token VPT prompt;
# 320: the last length bf16 keeps resident (five whole 64-key chunks);
# 337: ViT-L/14 with an 80-token VPT prompt; 577: ViT-L/14@336
@pytest.mark.parametrize("dtype", sorted(_DTYPES))
@pytest.mark.parametrize("T", [129, 200, 273, 320, 337, 577])
@pytest.mark.parametrize("mask", [None, "causal"], ids=["unmasked", "causal"])
def test_k1_streamed_schedule_matches_jax(mask, T, dtype):
    """K1's schedule above 128 tokens (fp32 on warpgroup MMA as 3xTF32,
    `k1_wgmma_tf32`; bf16 on products of bf16 values, which fp32 holds
    exactly, in 64-key chunks, resident up to 320 and streamed past it)
    against the JAX package's fused attention (its Pallas forward,
    interpreted off-TPU) and the port's plain version."""
    jdt, tdt, tol = _DTYPES[dtype]
    qkv, _ = _inputs(T, 300 + T)
    qkv_t = torch.from_numpy(qkv).to(tdt)
    if tdt == torch.float32:
        got = k1_wgmma_tf32(qkv_t, mask, H)
    else:
        got = _k1_streamed(qkv_t, mask, K1_CHUNK, _mm_plain)
    assert got.dtype == tdt and got.shape == (B, T, H * D)
    np.testing.assert_allclose(got.float().numpy(), _jax_forward(qkv, mask, jdt), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(got.float().numpy(),
                               attention_reference(qkv_t, mask, H).float().numpy(), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("mask", [None, "causal"], ids=["unmasked", "causal"])
def test_k1_streamed_fp32_needs_three_tf32_products(mask):
    """At T = 337 in fp32, the schedule (`k1_wgmma_tf32`) on one TF32
    product errs by more than the kernel's 1e-5 against the JAX package's
    forward, and on 3xTF32 by less than a tenth of it (much of it the two
    sides' own fp32 sums): the kernel takes three."""
    T = 337
    qkv, _ = _inputs(T, 300 + T)
    qkv_t = torch.from_numpy(qkv)
    want = _jax_forward(qkv, mask, jnp.float32)
    err = {name: float(np.abs(k1_wgmma_tf32(qkv_t, mask, H, three=three).numpy() - want).max())
           for name, three in (("one", False), ("three", True))}
    assert err["one"] > 1e-5, err
    assert err["three"] < 1e-6, err


def _k2_pair(qkv, g, mask, mm):
    """K2's bf16 pair of launches (above 320 tokens, on warpgroup MMA).
    Query side: sweep 1 in 64-key chunks (one update a chunk) keeps each
    row's online max m of the raw dots, l = sum 2^(s c - m c) and rho =
    sum 2^(s c - m c) * dP (c = D^-0.5 log2(e)), rescaling l and rho
    alike when m grows; each row's
    lse = m c + log2(l) and r D^-0.5 = rho / l * D^-0.5 go to a (B, H, 2,
    round64(T)) workspace (+inf and 0 past T); sweep 2 forms the dots and
    dP again, P = 2^(s c - lse), dS = P (dP D^-0.5 - r D^-0.5) rounded to
    the input type and dq = dS k.  Key side: S^T = k q^T and dP^T = v g^T
    formed anew, the same P and dS from the workspace, dv = P_lp^T g and
    dk = dS^T q.  `mm` forms every product: the plain product of bf16
    values, which fp32 holds exactly."""
    dt = qkv.dtype
    T = qkv.shape[1]
    q, k, v = (_heads(t) for t in qkv.split(H * D, dim=-1))
    gh = _heads(g)
    scale = torch.tensor(D**-0.5, dtype=torch.float32)
    scale2 = scale * torch.tensor(LOG2E, dtype=torch.float32)

    def masked(dots):  # (query, key)
        return dots.masked_fill(_causal_mask(T), float("-inf")) if mask == "causal" else dots

    dots = masked(mm(q, k.transpose(-1, -2)))
    dp = mm(gh, v.transpose(-1, -2))

    # query side: the statistics
    m = torch.full((B, H, T, 1), float("-inf"))
    l = torch.zeros(B, H, T, 1)
    rho = torch.zeros(B, H, T, 1)
    for c0 in range(0, T, K2_STEP):
        sc, dpc = dots[..., c0:c0 + K2_STEP], dp[..., c0:c0 + K2_STEP]
        mn = torch.maximum(m, sc.amax(-1, keepdim=True))
        alpha = torch.exp2(m * scale2 - mn * scale2)
        p = torch.exp2(sc * scale2 - mn * scale2)
        l = l * alpha + p.sum(-1, keepdim=True)
        rho = rho * alpha + (p * dpc).sum(-1, keepdim=True)
        m = mn
    rows = math.ceil(T / 64) * 64
    ws = torch.zeros(B, H, 2, rows)
    ws[:, :, 0] = float("inf")
    ws[:, :, 0, :T] = (m * scale2 + torch.log2(l))[..., 0]
    ws[:, :, 1, :T] = (rho / l * scale)[..., 0]
    lse, rs = ws[:, :, 0, :T, None], ws[:, :, 1, :T, None]

    def p_ds(dots, dp):
        p = torch.exp2(dots * scale2 - lse)
        return p, (p * (dp * scale - rs)).to(dt).float()

    # query side, sweep 2
    _, ds = p_ds(dots, dp)
    dq = mm(ds, k)
    # key side: the transposed products anew, the statistics as the
    # workspace holds them, by query
    p, ds = p_ds(masked(mm(k, q.transpose(-1, -2)).transpose(-1, -2)),
                 mm(v, gh.transpose(-1, -2)).transpose(-1, -2))
    dv = mm(p.to(dt).float().transpose(-1, -2), gh)
    dk = mm(ds.transpose(-1, -2), q)
    return torch.cat([_merge(t).to(dt) for t in (dq, dk, dv)], dim=-1)


def _jax_vjp(qkv, g, mask, jdt):
    _, vjp = jax.vjp(lambda x: jax_fused_attention(x, mask, H), jnp.asarray(qkv).astype(jdt))
    (want,) = vjp(jnp.asarray(g).astype(jdt))
    return np.asarray(want.astype(jnp.float32))


# T = 321: one key past the resident kernel; 337: ViT-L/14 with an 80-token
# VPT prompt; 385: one key past six whole 64-row tiles and chunks
@pytest.mark.parametrize("T", [321, 337, 385])
@pytest.mark.parametrize("mask", [None, "causal"], ids=["unmasked", "causal"])
def test_k2_streamed_bf16_schedule_matches_jax_vjp(mask, T):
    """K2's bf16 pair above 320 tokens (base-2 statistics updated once a
    64-key chunk, handed from the query side to the key side as the
    workspace holds them) against the JAX package's custom VJP (its Pallas
    backward, interpreted off-TPU) and the port's plain version, at 2e-2."""
    jdt, tdt, tol = _DTYPES["bfloat16"]
    qkv, g = _inputs(T, 400 + T, grad=True)
    qkv_t, g_t = torch.from_numpy(qkv).to(tdt), torch.from_numpy(g).to(tdt)
    got = _k2_pair(qkv_t, g_t, mask, _mm_plain)
    assert got.dtype == tdt and got.shape == (B, T, 3 * H * D)
    np.testing.assert_allclose(got.float().numpy(), _jax_vjp(qkv, g, mask, jdt), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(got.float().numpy(),
                               attention_bwd_reference(qkv_t, g_t, mask, H).float().numpy(),
                               rtol=tol, atol=tol)


# T = 129: one key past the short kernels; 273: ViT-L/14 with a 16-token
# VPT prompt (its fp32 default); 337: with an 80-token prompt
@pytest.mark.parametrize("T", [129, 273, 337])
@pytest.mark.parametrize("mask", [None, "causal"], ids=["unmasked", "causal"])
def test_k2_tf32_pair_schedule_matches_jax_vjp(mask, T):
    """K2's fp32 pair above 128 tokens on warpgroup MMA (`k2_wgmma_tf32`),
    every product as 3xTF32, the base-2 statistics handed from the query
    side to the key side as the workspace holds them, against the JAX
    package's custom VJP (its Pallas backward, interpreted off-TPU) and the
    port's plain version, at 1e-5 + 1e-5 |ref|."""
    jdt, tdt, tol = _DTYPES["float32"]
    qkv, g = _inputs(T, 500 + T, grad=True)
    qkv_t, g_t = torch.from_numpy(qkv), torch.from_numpy(g)
    got = k2_wgmma_tf32(qkv_t, g_t, mask, H)
    assert got.dtype == tdt and got.shape == (B, T, 3 * H * D)
    np.testing.assert_allclose(got.numpy(), _jax_vjp(qkv, g, mask, jdt), rtol=tol, atol=tol)
    np.testing.assert_allclose(got.numpy(), attention_bwd_reference(qkv_t, g_t, mask, H).numpy(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("mask", [None, "causal"], ids=["unmasked", "causal"])
def test_k2_tf32_pair_needs_three_tf32_products(mask):
    """At T = 273 in fp32, K2's pair (`k2_wgmma_tf32`) on one TF32 product a
    product misses 1e-5 + 1e-5 |ref| against the JAX package's custom VJP,
    and on 3xTF32 it meets it: the kernels take three."""
    T = 273
    qkv, g = _inputs(T, 500 + T, grad=True)
    qkv_t, g_t = torch.from_numpy(qkv), torch.from_numpy(g)
    want = _jax_vjp(qkv, g, mask, jnp.float32)
    excess = {name: float((np.abs(k2_wgmma_tf32(qkv_t, g_t, mask, H, three=three).numpy()
                                  - want) - 1e-5 * np.abs(want)).max())
              for name, three in (("one", False), ("three", True))}
    assert excess["one"] > 1e-5, excess
    assert excess["three"] <= 1e-5, excess


@pytest.mark.parametrize("flags", [[], ["--short-fp32"], ["--long-fp32"]],
                         ids=["streamed", "short_fp32", "long_fp32"])
def test_streamed_compare_script_needs_a_card(capsys, flags):
    """scripts/streamed_attention_compare.py, which times these kernels (and,
    with --short-fp32, K1's and K2's fp32 forms up to 128 tokens; with
    --long-fp32, K1's fp32 form above 128) on the card, exits 1 without one
    (here) before building anything."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts",
                        "streamed_attention_compare.py")
    spec = importlib.util.spec_from_file_location("streamed_attention_compare", path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    assert not torch.cuda.is_available()
    assert script.main(flags) == 1
    assert "needs a CUDA card" in capsys.readouterr().err
