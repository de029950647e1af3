"""The schedules of the attention kernels above 128 tokens (K1's forward: in
fp32 streamed from 129 tokens, in bf16 with K and V resident up to 320 and
streamed past it, both forms on one schedule; K2's bf16 streamed pair past
320), emulated in plain torch, against the JAX package's fused attention on
the CPU.

The kernels themselves run only on a card (tests/test_torch_port_gpu.py
holds them against the port's plain versions there).  What these tests pin
is their arithmetic: the order of the sums, the base-2 softmax, the row
statistics the two sweeps (and the two launches of the backward) hand on,
the rounding points, and, for the fp32 forward, 3xTF32 products on the
tensor cores.  The JAX side runs its Pallas kernels as its own tests do
off-TPU (interpreted); the same numpy inputs, made from a seed, go to both.

Tolerances: fp32 1e-5 and bf16 2e-2, as in tests/test_torch_port_ops.py
(both sides round the probabilities, dS and the outputs to bf16 at the same
points; sums run in another order).  The fp32 forward's products are
emulated as the kernel forms them: each operand x split on its bit pattern
into hi (x rounded to TF32's 10 fraction bits, to nearest, ties away from
zero, as cvt.rna.tf32.f32 rounds) and lo (x - hi cut to TF32), and
lo.hi + hi.lo + hi.hi summed in fp32.  One TF32 product alone misses 1e-5
on the same inputs, which is why the kernel takes three.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from menghini_neurips23_tpu.ops.attention import fused_attention as jax_fused_attention
from menghini_neurips23_tpu_torch.ops.attention import attention_bwd_reference, attention_reference

torch.set_num_threads(2)

_DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
           "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
B, H, D = 2, 2, 64
# the keys of one update of a row's statistics: K1's chunks (64 in bf16,
# resident or streamed; 32 in fp32) and K2's query side's 32-key steps
K1_CHUNK = {torch.bfloat16: 64, torch.float32: 32}
K2_STEP = 32
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


def _tf32_hi(x):
    """x rounded to TF32 (10 fraction bits), to nearest, ties away from zero,
    on the fp32 bit pattern."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_cut(x):
    """x cut to TF32: the bits a tensor core reads of an fp32 operand."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _split(x):
    hi = _tf32_hi(x)
    return hi, _tf32_cut(x - hi)


def _mm_3xtf32(a, b):
    """a @ b as the kernel forms it: lo.hi + hi.lo + hi.hi, in fp32."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    return torch.matmul(al, bh) + torch.matmul(ah, bl) + torch.matmul(ah, bh)


def _mm_1xtf32(a, b):
    """a @ b from one TF32 product: both operands rounded to TF32."""
    return torch.matmul(_tf32_hi(a), _tf32_hi(b))


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
    """K1's schedule above 128 tokens (fp32 on 3xTF32 products in 32-key
    chunks, bf16 on products of bf16 values, which fp32 holds exactly, in
    64-key chunks, resident up to 320 and streamed past it) against the JAX
    package's fused attention (its Pallas forward, interpreted off-TPU) and
    the port's plain version."""
    jdt, tdt, tol = _DTYPES[dtype]
    qkv, _ = _inputs(T, 300 + T)
    qkv_t = torch.from_numpy(qkv).to(tdt)
    mm = _mm_3xtf32 if tdt == torch.float32 else _mm_plain
    got = _k1_streamed(qkv_t, mask, K1_CHUNK[tdt], mm)
    assert got.dtype == tdt and got.shape == (B, T, H * D)
    np.testing.assert_allclose(got.float().numpy(), _jax_forward(qkv, mask, jdt), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(got.float().numpy(),
                               attention_reference(qkv_t, mask, H).float().numpy(), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("mask", [None, "causal"], ids=["unmasked", "causal"])
def test_k1_streamed_fp32_needs_three_tf32_products(mask):
    """At T = 337 in fp32, the schedule on one TF32 product errs by more than
    the kernel's 1e-5 against the JAX package's forward (3.4e-4 unmasked),
    and on 3xTF32 by less than a tenth of it (5.7e-7, much of it the two
    sides' own fp32 sums): the kernel takes three."""
    T = 337
    qkv, _ = _inputs(T, 300 + T)
    qkv_t = torch.from_numpy(qkv)
    want = _jax_forward(qkv, mask, jnp.float32)
    err = {name: float(np.abs(_k1_streamed(qkv_t, mask, K1_CHUNK[torch.float32], mm).numpy()
                              - want).max())
           for name, mm in (("one", _mm_1xtf32), ("three", _mm_3xtf32))}
    assert err["one"] > 1e-5, err
    assert err["three"] < 1e-6, err


def _k2_streamed_bf16(qkv, g, mask):
    """K2's bf16 streamed pair.  Query side: sweep 1 in 32-key steps keeps
    each row's online max m of the raw dots, l = sum 2^(s c - m c) and rho =
    sum 2^(s c - m c) * dP (c = D^-0.5 log2(e)), rescaling l and rho alike
    when m grows; each row's lse = m c + log2(l) and r D^-0.5 = rho / l *
    D^-0.5 go to a (B, H, 2, round64(T)) workspace (+inf and 0 past T);
    sweep 2 forms P = 2^(s c - lse), dS = P (dP D^-0.5 - r D^-0.5) rounded
    to bf16 and dq = dS k.  Key side, from the workspace: the same P and dS,
    dv = P_bf16^T g and dk = dS^T q."""
    dt = qkv.dtype
    T = qkv.shape[1]
    q, k, v = (_heads(t) for t in qkv.split(H * D, dim=-1))
    gh = _heads(g)
    scale = torch.tensor(D**-0.5, dtype=torch.float32)
    scale2 = scale * torch.tensor(LOG2E, dtype=torch.float32)
    dots = torch.matmul(q, k.transpose(-1, -2))
    if mask == "causal":
        dots = dots.masked_fill(_causal_mask(T), float("-inf"))
    dp = torch.matmul(gh, v.transpose(-1, -2))

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

    def p_ds(lse, rs):
        p = torch.exp2(dots * scale2 - lse)
        return p, (p * (dp * scale - rs)).to(dt).float()

    # query side, sweep 2
    _, ds = p_ds(ws[:, :, 0, :T, None], ws[:, :, 1, :T, None])
    dq = torch.matmul(ds, k)
    # key side: the statistics as the workspace holds them, by query
    p, ds = p_ds(ws[:, :, 0, :T, None], ws[:, :, 1, :T, None])
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), gh)
    dk = torch.matmul(ds.transpose(-1, -2), q)
    return torch.cat([_merge(t).to(dt) for t in (dq, dk, dv)], dim=-1)


@pytest.mark.parametrize("mask", [None, "causal"], ids=["unmasked", "causal"])
def test_k2_streamed_bf16_schedule_matches_jax_vjp(mask):
    """K2's bf16 streamed pair at T = 337 (base-2 statistics handed from the
    query side to the key side as the workspace holds them) against the JAX
    package's custom VJP (its Pallas backward, interpreted off-TPU) and the
    port's plain version, at 2e-2."""
    T = 337
    jdt, tdt, tol = _DTYPES["bfloat16"]
    qkv, g = _inputs(T, 400 + T, grad=True)
    _, vjp = jax.vjp(lambda x: jax_fused_attention(x, mask, H), jnp.asarray(qkv).astype(jdt))
    (want,) = vjp(jnp.asarray(g).astype(jdt))
    qkv_t, g_t = torch.from_numpy(qkv).to(tdt), torch.from_numpy(g).to(tdt)
    got = _k2_streamed_bf16(qkv_t, g_t, mask)
    assert got.dtype == tdt and got.shape == (B, T, 3 * H * D)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(got.float().numpy(),
                               attention_bwd_reference(qkv_t, g_t, mask, H).float().numpy(),
                               rtol=tol, atol=tol)


def test_streamed_compare_script_needs_a_card(capsys):
    """scripts/streamed_attention_compare.py, which times these kernels on the
    card, exits 1 without one (here) before building anything."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts",
                        "streamed_attention_compare.py")
    spec = importlib.util.spec_from_file_location("streamed_attention_compare", path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    assert not torch.cuda.is_available()
    assert script.main([]) == 1
    assert "needs a CUDA card" in capsys.readouterr().err
