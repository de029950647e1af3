"""K1's fp32 forward above 128 tokens on warpgroup MMA as 3xTF32
(`attention_fwd_tf32` in csrc/attention_fwd.cu), its schedule emulated in
plain torch, against the JAX package's fused attention on the CPU and the
port's plain version.

The kernel runs only on a card (tests/test_torch_port_gpu.py holds it
against `attention_reference` there, at every length around its 64-row
tiles and 64-key chunks).  What these tests pin is its arithmetic, tile by
tile as the kernel takes it (tests/torch_port_fixtures.py's
`k1_wgmma_tf32`): a warpgroup per 64 query rows (rows past T zero-filled),
64-key chunks of K and V (keys past T zero-filled) in both sweeps, a causal
tile's chunks only up to its diagonal; sweep 1 keeps each row's online max
m of the raw scores and sum l of 2^((s - m) D^-0.5 log2(e)) (-inf past T
and the diagonal), leaving out the 8-key groups past the tile's keys; sweep
2 recomputes the scores, forms P = 2^((s - m) D^-0.5 log2(e)) * (1 / l) in
fp32 (0 in the 8-key groups past the tile's keys) and adds each chunk's
P . V to O over its two halves of 32 keys (the second only where the
tile's keys reach it), each half in a zeroed tile of its own.  Every
product is 3xTF32 as the kernel chains its wgmma k-steps: each operand x
split into hi (x rounded to TF32 as cvt.rna.tf32.f32 rounds,
tests/torch_port_fixtures.py's `_split`) and lo (x - hi, of which the
tensor cores read the TF32 cut), the small terms first, lo.hi and hi.lo,
then hi.hi.  The JAX side runs its Pallas kernel as its own tests do
off-TPU (interpreted); the same numpy inputs, made from a seed, go to both.

Tolerance: fp32 1e-5, as in tests/test_torch_port_ops.py and on the card
(sums run in another order; the split leaves out lo.lo and the bits below
lo, about 2^-21 of a product).  One TF32 product alone misses it on the
same inputs, which is why the kernel takes three.  The chain comparison
runs the schedule on `acc_truncating`, a model of the tensor cores'
truncating adders, to show which chain carries the error the card shows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from menghini_neurips23_tpu.ops.attention import fused_attention as jax_fused_attention
from menghini_neurips23_tpu_torch.ops.attention import attention_reference
from tests.torch_port_fixtures import acc_truncating, k1_wgmma_tf32

torch.set_num_threads(2)

TOL = 1e-5
B, H = 2, 2
ROWS = 64  # query rows a warpgroup
KEYS = 64  # keys a chunk, in both sweeps


def _inputs(T, D, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(0, 1, (B, T, 3 * H * D)).astype(np.float32)


def _jax_forward(qkv, mask):
    return np.asarray(jax_fused_attention(jnp.asarray(qkv), mask, H))


# T = 129: one key past the short kernel; 257: ViT-L/14's frozen passes
# (one key in the last chunk); 261: UPT's 4-token prompt; 273: a 16-token
# VPT prompt; 320: five whole tiles and chunks; 321: one past; 337: an
# 80-token VPT prompt; 577: ViT-L/14@336; 1024: the longest chain of chunks
# (16) the card's cases run.  D = 64 (ViT-L/14: two 128-byte swizzle atoms
# a row), 32 (one) and 16 (one of 64 bytes).
@pytest.mark.parametrize("D", [64, 32, 16])
@pytest.mark.parametrize("T", [129, 257, 261, 273, 320, 321, 337, 577, 1024])
@pytest.mark.parametrize("mask", [None, "causal"], ids=["unmasked", "causal"])
def test_k1_tf32_schedule_matches_jax(mask, T, D):
    """The warpgroup schedule on 3xTF32 (64-row tiles, 64-key chunks in
    both sweeps, each 32-key half of a chunk's P.V in a zeroed tile) against
    the JAX package's fused attention (its Pallas forward, interpreted
    off-TPU) and the port's plain version, at 1e-5."""
    qkv = _inputs(T, D, 900 + T + D)
    qkv_t = torch.from_numpy(qkv)
    got = k1_wgmma_tf32(qkv_t, mask, H)
    assert got.dtype == torch.float32 and got.shape == (B, T, H * D)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), _jax_forward(qkv, mask), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), attention_reference(qkv_t, mask, H).numpy(),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("T", [337, 1024])
@pytest.mark.parametrize("mask", [None, "causal"], ids=["unmasked", "causal"])
def test_k1_tf32_needs_three_tf32_products(mask, T):
    """At D = 64 the schedule on one TF32 product (the kernel's hi parts
    alone) errs by more than the kernel's 1e-5 against the JAX package's
    forward, and on the kernel's 3xTF32 by less than half of it: the kernel
    takes three."""
    qkv = _inputs(T, 64, 900 + T + 64)
    qkv_t = torch.from_numpy(qkv)
    want = _jax_forward(qkv, mask)
    err = {name: float(np.abs(k1_wgmma_tf32(qkv_t, mask, H, three=three).numpy() - want).max())
           for name, three in (("one", False), ("three", True))}
    assert err["one"] > 1e-5, err
    assert err["three"] < 5e-6, err


def test_k1_tf32_chains_under_truncating_adders():
    """With the tensor cores' adders modelled as truncating
    (`acc_truncating`), at T = 512, causal, V 4x larger (one head of 64):
    each 32-key half of a chunk's P.V in a zeroed tile of its own, as the
    kernel takes it, errs well under half of what one tile a chunk (16 of
    its 24 k-steps adding into a full-size sum) errs against the exact
    result, where a second tile for S's hi.hi over the second half of d
    does not help.  On the card (PERF.md) the same change lowered
    the mean error over 12 inputs at (8, 1024) by a tenth, not the largest:
    the model shows the chains' share of the error, not the card's whole
    error."""
    T, Dh = 512, 64
    rng = np.random.default_rng(7)
    qkv = rng.normal(0, 1, (1, T, 3 * Dh)).astype(np.float32)
    qkv[..., 2 * Dh:] *= 4
    x = torch.from_numpy(qkv).double()
    q, k, v = (t[0] for t in x.split(Dh, dim=-1))
    s = (q @ k.T * Dh**-0.5).masked_fill(torch.ones(T, T, dtype=torch.bool).triu(1),
                                          float("-inf"))
    want = (torch.softmax(s, -1) @ v)[None]
    err = {(st, pt): (k1_wgmma_tf32(torch.from_numpy(qkv), "causal", 1, acc=acc_truncating,
                                    s_tiles=st, pv_tiles=pt).double() - want).abs().max().item()
           for st, pt in ((1, 1), (2, 1), (1, 2))}
    assert err[(1, 2)] < 0.5 * err[(1, 1)], err
    assert err[(2, 1)] > 0.9 * err[(1, 1)], err


def _v_transposed_order():
    """The key each position of an 8-key group of V^T's rows holds, as the
    kernel's transpose writes it: piece h of the group holds keys h, h + 2,
    h + 4, h + 6."""
    return [2 * p if p < 4 else 2 * (p - 4) + 1 for p in range(8)]


def test_k1_tf32_v_order_is_the_a_fragment_order():
    """P's A fragment taken from the scores' accumulators (lane quad q holds
    keys 2q, 2q + 1 of an 8-key group, and gives them as the fragment's k =
    q, q + 4, mma.sync's m16n8k8 A layout) reads key 8j + order[k] at k,
    and the transpose writes V's key 8j + order[p] at position p: a P.V
    k-step multiplies each key's P by its own V."""
    order = _v_transposed_order()
    for q in range(4):
        assert order[q] == 2 * q and order[q + 4] == 2 * q + 1
    # the transpose's pieces: piece 2j + h, 16 bytes, positions 4h .. 4h + 3
    for piece in range(16):
        j, h = piece >> 1, piece & 1
        keys = [8 * j + h + 2 * i for i in range(4)]
        assert keys == [8 * j + order[4 * h + i] for i in range(4)]


def _swizzle(off, row_bytes):
    """The kernel's `swizzle<kRowBytes>`: bits 4.. XOR bits 7.."""
    return off ^ (((off >> 7) & (row_bytes // 16 - 1)) << 4)


def _tf_offset(r, c, D):
    """The kernel's `tf_offset<D>`: (row, 16-byte piece) of a 64-row fp32
    tile, cut along d into sub-tiles of min(D, 32) floats."""
    sub = min(D, 32)
    row_bytes, pieces = 4 * sub, sub // 4
    return (c // pieces) * ROWS * row_bytes + _swizzle(r * row_bytes + (c % pieces) * 16, row_bytes)


@pytest.mark.parametrize("D", [64, 32, 16])
def test_k1_tf32_tile_layout(D):
    """A 64-row fp32 tile in the kernel's layout is a permutation of its
    16-byte pieces within the tile, each sub-tile row holds one row's pieces
    of that sub-tile, and a k-step's descriptor offset (its sub-tile, then
    32 bytes a k-step within the row) lands on the row's pieces of floats
    8kk .. 8kk + 7 in row 0 (rows 1.. follow the swizzle the descriptor
    names)."""
    tile = 64 * 4 * D
    offs = [_tf_offset(r, c, D) for r in range(ROWS) for c in range(D // 4)]
    assert sorted(offs) == list(range(0, tile, 16))
    sub = min(D, 32)
    for r in range(ROWS):
        for c in range(D // 4):
            s, within = divmod(_tf_offset(r, c, D), ROWS * 4 * sub)
            assert s == c // (sub // 4) and within // (4 * sub) == r
    steps_sub = sub // 8
    for kk in range(D // 8):
        start = (kk // steps_sub) * ROWS * 4 * sub + (kk % steps_sub) * 32
        assert start == _tf_offset(0, 2 * kk, D)
    assert tf32_smem_bytes(64) == 198656 <= 227 * 1024


def tf32_smem_bytes(D, groups=3):
    """The kernel's `tf32_smem`: 1 KB of alignment, q's two planes a
    warpgroup, K's chunk in two stages and its lo plane, V^T's two planes,
    V's landing rows (D + 4 floats)."""
    tile = 64 * 4 * D
    return 1024 + (2 * groups + 3) * tile + 2 * D * 4 * KEYS + KEYS * (D + 4) * 4
