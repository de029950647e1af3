"""The port's kernel modules (menghini_neurips23_tpu_torch.ops) against the
JAX package's, on the CPU.

On a CPU tensor each port wrapper computes its plain PyTorch version; the JAX
side runs its Pallas kernels as its own tests do off-TPU (interpreted).  The
same numpy inputs, made from a seed, go to both.

Tolerances: attention forward and backward 1e-5 in fp32 and 2e-2 in bf16
(both sides round the probabilities, dS and the outputs to bf16 at the same
points; summation order differs, so a value may land on a neighbouring bf16
step); the CLIP head rtol 1e-5 / atol 1e-6 (fp32 math on both sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from menghini_neurips23_tpu.ops.attention import fused_attention as jax_fused_attention
from menghini_neurips23_tpu.ops.clip_head import fused_probs as jax_fused_probs
from menghini_neurips23_tpu.ops.patch_embed import (
    fold_normalization as jax_fold_normalization,
    patch_tokens as jax_patch_tokens,
)
from menghini_neurips23_tpu_torch.ops import _cuda
from menghini_neurips23_tpu_torch.ops.attention import (
    FusedAttention,
    attention_bwd,
    attention_bwd_reference,
    attention_reference,
    fused_attention,
)
from menghini_neurips23_tpu_torch.ops.clip_head import fused_probs, fused_probs_reference
from menghini_neurips23_tpu_torch.ops.patch_embed import fold_normalization, patch_tokens
from tests.torch_port_fixtures import native_build_outside_checkout  # noqa: F401

torch.set_num_threads(2)

_DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5), "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


# T = 273: ViT-L/14's VPT sequence, which the forward kernel takes in two
# sweeps and the backward kernel tiles on the card
@pytest.mark.parametrize("dtype", sorted(_DTYPES))
@pytest.mark.parametrize("T", [17, 24, 273])
@pytest.mark.parametrize("mask", [None, "causal"], ids=["unmasked", "causal"])
def test_attention_plain_matches_jax_kernel(mask, T, dtype):
    jdt, tdt, tol = _DTYPES[dtype]
    B, H, D = 8, 2, 16
    qkv = np.random.default_rng(T).normal(0, 1, (B, T, 3 * H * D)).astype(np.float32)
    want = np.asarray(jax_fused_attention(jnp.asarray(qkv).astype(jdt), mask, H).astype(jnp.float32))
    got = fused_attention(torch.from_numpy(qkv).to(tdt), mask, H)
    assert got.dtype == tdt and got.shape == (B, T, H * D)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


# T = 129 and 273: the lengths K2 tiles on the card (the first past 128,
# ViT-L/14's VPT sequence)
@pytest.mark.parametrize("dtype", sorted(_DTYPES))
@pytest.mark.parametrize("T", [12, 24, 129, 273])
@pytest.mark.parametrize("mask", [None, "causal"], ids=["unmasked", "causal"])
def test_attention_bwd_plain_matches_jax_vjp(mask, T, dtype):
    """K2's plain version against the JAX package's custom VJP, whose `_bwd`
    runs the Pallas backward kernel (interpreted off-TPU)."""
    jdt, tdt, tol = _DTYPES[dtype]
    B, H, D = 8, 2, 16
    rng = np.random.default_rng(100 + T)
    qkv = rng.normal(0, 1, (B, T, 3 * H * D)).astype(np.float32)
    g = rng.normal(0, 1, (B, T, H * D)).astype(np.float32)
    _, vjp = jax.vjp(lambda x: jax_fused_attention(x, mask, H), jnp.asarray(qkv).astype(jdt))
    (want,) = vjp(jnp.asarray(g).astype(jdt))
    got = attention_bwd(torch.from_numpy(qkv).to(tdt), torch.from_numpy(g).to(tdt), mask, H)
    assert got.dtype == tdt and got.shape == (B, T, 3 * H * D)
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)), rtol=tol, atol=tol
    )


def _merged_sweep_bwd(qkv, g, mask, heads, chunk):
    """K2's schedule above 128 tokens, in plain torch: sweep 1 over `chunk`-key
    chunks keeps each query row's online max m, sum l = sum exp(s - m) and
    rho = sum exp(s - m) * dP, rescaling l and rho alike when m grows, and
    ends with r = rho / l; sweep 2 forms P = exp(s - m) * (1 / l), dS =
    P (dP - r) D^-0.5 rounded to the input type, dq = dS k, dk = dS^T q and
    dv = P_lp^T g (P_lp: P rounded to the input type)."""
    dt = qkv.dtype
    B, T, three_w = qkv.shape
    W = three_w // 3
    D = W // heads

    def split(x):
        return x.reshape(B, T, heads, D).transpose(1, 2).float()

    q, k, v = (split(t) for t in qkv.split(W, dim=-1))
    gh = split(g)
    scale = D**-0.5
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if mask == "causal":
        s = s.masked_fill(torch.ones(T, T, dtype=torch.bool).triu(1), float("-inf"))
    dp = torch.matmul(gh, v.transpose(-1, -2))
    m = torch.full((B, heads, T, 1), float("-inf"))
    l = torch.zeros(B, heads, T, 1)
    rho = torch.zeros(B, heads, T, 1)
    for c0 in range(0, T, chunk):  # key 0 keeps every row's m finite after chunk 0
        sc, dpc = s[..., c0:c0 + chunk], dp[..., c0:c0 + chunk]
        mn = torch.maximum(m, sc.amax(-1, keepdim=True))
        alpha = torch.exp(m - mn)
        p = torch.exp(sc - mn)
        l = l * alpha + p.sum(-1, keepdim=True)
        rho = rho * alpha + (p * dpc).sum(-1, keepdim=True)
        m = mn
    r = rho / l
    p = torch.exp(s - m) * (1 / l)
    ds = (p * (dp - r) * scale).to(dt).float()
    dq = torch.matmul(ds, k)
    dk = torch.matmul(ds.transpose(-1, -2), q)
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), gh)
    return torch.cat([t.transpose(1, 2).reshape(B, T, W).to(dt) for t in (dq, dk, dv)], dim=-1)


# T = 129 and 273, as above; chunks of 32 keys (the fp32 kernel's) and 64
# (the bf16 kernel's)
@pytest.mark.parametrize("dtype", sorted(_DTYPES))
@pytest.mark.parametrize("T", [129, 273])
@pytest.mark.parametrize("mask", [None, "causal"], ids=["unmasked", "causal"])
def test_attention_bwd_merged_sweep_matches_jax_vjp(mask, T, dtype):
    """The one-sweep statistics (online m, l and rho, r = rho / l) that K2
    runs above 128 tokens, emulated in plain torch, against the JAX
    package's custom VJP (its Pallas `_bwd`, interpreted off-TPU) and
    against K2's plain version, at the tolerances of the test above."""
    jdt, tdt, tol = _DTYPES[dtype]
    B, H, D = 8, 2, 16
    rng = np.random.default_rng(200 + T)
    qkv = rng.normal(0, 1, (B, T, 3 * H * D)).astype(np.float32)
    g = rng.normal(0, 1, (B, T, H * D)).astype(np.float32)
    _, vjp = jax.vjp(lambda x: jax_fused_attention(x, mask, H), jnp.asarray(qkv).astype(jdt))
    (want,) = vjp(jnp.asarray(g).astype(jdt))
    qkv_t, g_t = torch.from_numpy(qkv).to(tdt), torch.from_numpy(g).to(tdt)
    plain = attention_bwd_reference(qkv_t, g_t, mask, H).float().numpy()
    for chunk in (32, 64):
        got = _merged_sweep_bwd(qkv_t, g_t, mask, H, chunk)
        assert got.dtype == tdt and got.shape == (B, T, 3 * H * D)
        np.testing.assert_allclose(
            got.float().numpy(), np.asarray(want.astype(jnp.float32)), rtol=tol, atol=tol
        )
        np.testing.assert_allclose(got.float().numpy(), plain, rtol=tol, atol=tol)


# T = 384: past the 320 tokens up to which the kernels keep K and V resident
# in shared memory (both stream them above, with the plain versions' math)
@pytest.mark.parametrize("dtype", sorted(_DTYPES))
@pytest.mark.parametrize("mask", [None, "causal"], ids=["unmasked", "causal"])
def test_attention_plain_versions_at_384_match_jax_vjp(mask, dtype):
    """Both plain versions at T = 384 against the JAX package's fused
    attention (its Pallas forward, interpreted off-TPU) and its custom VJP
    (the Pallas backward), at the tolerances above."""
    jdt, tdt, tol = _DTYPES[dtype]
    B, T, H, D = 2, 384, 2, 16
    rng = np.random.default_rng(384)
    qkv = rng.normal(0, 1, (B, T, 3 * H * D)).astype(np.float32)
    g = rng.normal(0, 1, (B, T, H * D)).astype(np.float32)
    out, vjp = jax.vjp(lambda x: jax_fused_attention(x, mask, H), jnp.asarray(qkv).astype(jdt))
    (want,) = vjp(jnp.asarray(g).astype(jdt))
    qkv_t, g_t = torch.from_numpy(qkv).to(tdt), torch.from_numpy(g).to(tdt)
    fwd = attention_reference(qkv_t, mask, H)
    bwd = attention_bwd_reference(qkv_t, g_t, mask, H)
    assert fwd.dtype == bwd.dtype == tdt and bwd.shape == (B, T, 3 * H * D)
    np.testing.assert_allclose(fwd.float().numpy(), np.asarray(out.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(bwd.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("mask", [None, "causal"], ids=["unmasked", "causal"])
def test_fused_attention_cpu_gradient_matches_autograd_of_plain(mask):
    """Through `FusedAttention` on the CPU (plain forward + plain backward)
    against autograd of the plain forward, fp32; no kernel launch counted."""
    fused_attention.launches = attention_bwd.launches = 0
    gen = torch.Generator().manual_seed(1)
    qkv = torch.randn(4, 12, 3 * 64, generator=gen)
    g = torch.randn(4, 12, 64, generator=gen)
    a = qkv.clone().requires_grad_(True)
    out = fused_attention(a, mask, 4)
    assert out.grad_fn is not None and type(out.grad_fn).__name__ == "FusedAttentionBackward"
    (got,) = torch.autograd.grad(out, a, g)
    b = qkv.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(attention_reference(b, mask, 4), b, g)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got, attention_bwd_reference(qkv, g, mask, 4), rtol=0, atol=0)
    # a non-contiguous qkv (a transposed view) is made contiguous in the forward
    c = qkv.transpose(0, 1).contiguous().transpose(0, 1).requires_grad_(True)
    (got_c,) = torch.autograd.grad(FusedAttention.apply(c, mask, 4), c, g)
    torch.testing.assert_close(got_c, got, rtol=0, atol=0)
    assert fused_attention.launches == 0 and attention_bwd.launches == 0


# (dtype, B, E, C): tiny bf16 inputs; the ViT-B/32 width at Flowers102's 102
# classes in fp32, the main path's type
@pytest.mark.parametrize("dtype, B, E, C", [("bfloat16", 12, 24, 7), ("float32", 40, 512, 102)],
                         ids=["bf16-12x24x7", "f32-40x512x102"])
def test_clip_head_plain_matches_jax_kernel(dtype, B, E, C):
    jdt, tdt, _ = _DTYPES[dtype]
    rng = np.random.default_rng(3)
    img = rng.normal(0, 1, (B, E)).astype(np.float32)
    txt = rng.normal(0, 1, (C, E)).astype(np.float32)
    scale = float(np.exp(np.float32(np.log(1 / 0.07))))
    want = np.asarray(
        jax_fused_probs(
            jnp.asarray(img).astype(jdt), jnp.asarray(txt).astype(jdt),
            scale, force_pallas=True, interpret=True,
        )
    )
    got = fused_probs(torch.from_numpy(img).to(tdt), torch.from_numpy(txt).to(tdt), scale)
    assert got.dtype == torch.float32 and got.shape == (B, C)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_fold_normalization_and_patch_tokens_match_jax():
    rng = np.random.default_rng(4)
    P, W = 16, 32
    conv1 = rng.normal(0, 0.05, (P * P * 3, W)).astype(np.float32)
    kf, b = fold_normalization(conv1)
    jkf, jb = jax_fold_normalization(conv1)
    np.testing.assert_array_equal(kf, jkf)
    np.testing.assert_array_equal(b, jb)
    u8 = rng.integers(0, 256, (3, 32, 32, 3)).astype(np.uint8)
    got = patch_tokens(torch.from_numpy(u8), torch.from_numpy(kf), P, bias=torch.from_numpy(b))
    want = np.asarray(jax_patch_tokens(jnp.asarray(u8), jnp.asarray(jkf), P, bias=jnp.asarray(jb)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    f32 = rng.normal(0, 1, (2, 32, 32, 3)).astype(np.float32)
    got = patch_tokens(torch.from_numpy(f32), torch.from_numpy(conv1), P)
    want = np.asarray(jax_patch_tokens(jnp.asarray(f32), jnp.asarray(conv1), P))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_cpu_tensors_take_the_plain_path_and_count_no_launch():
    fused_attention.launches = 0
    fused_probs.launches = 0
    qkv = torch.randn(2, 5, 3 * 32, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(
        fused_attention(qkv, "causal", 2), attention_reference(qkv, "causal", 2), rtol=0, atol=0
    )
    img, txt = torch.randn(4, 16), torch.randn(3, 16)
    torch.testing.assert_close(
        fused_probs(img, txt, 10.0), fused_probs_reference(img, txt, 10.0), rtol=0, atol=0
    )
    assert fused_attention.launches == 0 and fused_probs.launches == 0


def test_wrappers_refuse_other_devices_and_masks():
    with pytest.raises(ValueError, match="unsupported device"):
        fused_attention(torch.empty(2, 5, 96, device="meta"), None, 2)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_probs(torch.empty(2, 8, device="meta"), torch.empty(3, 8, device="meta"), 1.0)
    with pytest.raises(ValueError, match="mask"):
        fused_attention(torch.zeros(1, 2, 6), "bidirectional", 1)


def test_kernel_build_is_keyed_on_source_and_flags():
    # the library name changes with the source digest; nothing is built here
    for name in ("attention_fwd", "attention_bwd", "clip_head", "twophase_attention"):
        path = _cuda.library_path(name)
        assert path == _cuda.library_path(name)
        assert path.startswith(_cuda.BUILD_DIR) and f"lib{name}-" in path
