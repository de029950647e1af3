"""The port's kernel modules (menghini_neurips23_tpu_torch.ops) against the
JAX package's, on the CPU.

On a CPU tensor each port wrapper computes its plain PyTorch version; the JAX
side runs its Pallas kernels as its own tests do off-TPU (interpreted).  The
same numpy inputs, made from a seed, go to both.

Tolerances: attention 1e-5 in fp32 and 2e-2 in bf16 (both sides round the
probabilities and the output to bf16; summation order differs); the CLIP
head rtol 1e-5 / atol 1e-6 (fp32 math on both sides).
"""

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
from menghini_neurips23_tpu_torch.ops.attention import attention_reference, fused_attention
from menghini_neurips23_tpu_torch.ops.clip_head import fused_probs, fused_probs_reference
from menghini_neurips23_tpu_torch.ops.patch_embed import fold_normalization, patch_tokens

torch.set_num_threads(2)

_DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5), "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
@pytest.mark.parametrize("T", [17, 24])
@pytest.mark.parametrize("mask", [None, "causal"], ids=["unmasked", "causal"])
def test_attention_plain_matches_jax_kernel(mask, T, dtype):
    jdt, tdt, tol = _DTYPES[dtype]
    B, H, D = 8, 2, 16
    qkv = np.random.default_rng(T).normal(0, 1, (B, T, 3 * H * D)).astype(np.float32)
    want = np.asarray(jax_fused_attention(jnp.asarray(qkv).astype(jdt), mask, H).astype(jnp.float32))
    got = fused_attention(torch.from_numpy(qkv).to(tdt), mask, H)
    assert got.dtype == tdt and got.shape == (B, T, H * D)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def test_clip_head_plain_matches_jax_kernel():
    rng = np.random.default_rng(3)
    B, E, C = 12, 24, 7
    img = rng.normal(0, 1, (B, E)).astype(np.float32)
    txt = rng.normal(0, 1, (C, E)).astype(np.float32)
    scale = float(np.exp(np.float32(np.log(1 / 0.07))))
    want = np.asarray(
        jax_fused_probs(
            jnp.asarray(img).astype(jnp.bfloat16), jnp.asarray(txt).astype(jnp.bfloat16),
            scale, force_pallas=True, interpret=True,
        )
    )
    got = fused_probs(
        torch.from_numpy(img).bfloat16(), torch.from_numpy(txt).bfloat16(), scale
    )
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
    for name in ("attention_fwd", "clip_head"):
        path = _cuda.library_path(name)
        assert path == _cuda.library_path(name)
        assert path.startswith(_cuda.BUILD_DIR) and f"lib{name}-" in path
