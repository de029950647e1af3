"""K2's fp32 pair above 128 tokens on warpgroup MMA as 3xTF32
(`attention_bwd_q_tf32` and `attention_bwd_kv_tf32` in
csrc/attention_bwd.cu), its schedule emulated in plain torch, against the
JAX package's custom VJP on the CPU and the port's plain version.

The kernels run only on a card (tests/test_torch_port_gpu.py and the
smoke's phase 3 hold them against `attention_bwd_reference` there, at every
length around their 64-row tiles and 32-row chunks).  What these tests pin
is their arithmetic, tile by tile as the kernels take it
(tests/torch_port_fixtures.py's `k2_wgmma_tf32`): 64-row tiles of the
resident side, 32-row chunks of the streamed side (rows past T
zero-filled), the query side's two sweeps with their online base-2
statistics handed to the key side as the workspace holds them (lse and r *
D^-0.5, +inf and 0 past T), the rounding points, and every product as the
kernels chain their wgmma k-steps: each operand x split into hi (x rounded
to TF32 as cvt.rna.tf32.f32 rounds) and lo (x - hi, of which the tensor
cores read the TF32 cut), lo.hi and hi.lo first, then hi.hi, k-step by
k-step into a zeroed tile; the query side's S and dP with their hi.hi over
each half of d in a tile of its own, the key side's in one; each chunk's
dq, dv and dk in a zeroed tile added to the running sum in fp32.  The JAX
side runs its Pallas kernels as its own tests do off-TPU (interpreted); the
same numpy inputs, made from a seed, go to both.

Tolerance: fp32 1e-5 + 1e-5 |ref|, as on the card (sums run in another
order; the split leaves out lo.lo and the bits below lo, about 2^-21 of a
product).  One TF32 product alone misses it on the same inputs, which is why
the kernels take three.  The layout tests mirror the kernels' index
arithmetic (the staging pieces, the transposed planes' row order, the
shared-memory budget) in Python.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from menghini_neurips23_tpu.ops.attention import fused_attention as jax_fused_attention
from menghini_neurips23_tpu_torch.ops.attention import attention_bwd_reference
from tests.torch_port_fixtures import k2_wgmma_tf32

torch.set_num_threads(2)

TOL = 1e-5
B, H, D = 2, 2, 64
ROWS, CHUNK, THREADS = 64, 32, 128  # a block's resident rows, streamed rows a step, threads


def _inputs(T, seed):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(0, 1, (B, T, 3 * H * D)).astype(np.float32)
    g = rng.normal(0, 1, (B, T, H * D)).astype(np.float32)
    return qkv, g


def _jax_vjp(qkv, g, mask):
    _, vjp = jax.vjp(lambda x: jax_fused_attention(x, mask, H), jnp.asarray(qkv))
    (want,) = vjp(jnp.asarray(g))
    return np.asarray(want)


# T = 129: one past the single-kernel form, a 64-row tile and a 32-row chunk
# with one row each; 200: ragged tiles and chunks (8 rows past the last
# whole chunk); 273: ViT-L/14 with a 16-token VPT prompt, the fp32 step's
# length; 337: with an 80-token prompt
@pytest.mark.parametrize("T", [129, 200, 273, 337])
@pytest.mark.parametrize("mask", [None, "causal"], ids=["unmasked", "causal"])
def test_k2_wgmma_tf32_schedule_matches_jax_vjp(mask, T):
    """The pair's schedule on 3xTF32 wgmma chains against the JAX package's
    custom VJP (its Pallas backward, interpreted off-TPU) and the port's
    plain version, at 1e-5 + 1e-5 |ref|."""
    qkv, g = _inputs(T, 700 + T)
    qkv_t, g_t = torch.from_numpy(qkv), torch.from_numpy(g)
    got = k2_wgmma_tf32(qkv_t, g_t, mask, H)
    assert got.dtype == torch.float32 and got.shape == (B, T, 3 * H * D)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), _jax_vjp(qkv, g, mask), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(),
                               attention_bwd_reference(qkv_t, g_t, mask, H).numpy(),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("mask", [None, "causal"], ids=["unmasked", "causal"])
def test_k2_wgmma_tf32_needs_three_tf32_products(mask):
    """At T = 273 the schedule on one TF32 product a product (the hi parts)
    misses 1e-5 + 1e-5 |ref| against the JAX package's custom VJP, and on
    3xTF32 meets it: the kernels take three."""
    T = 273
    qkv, g = _inputs(T, 700 + T)
    qkv_t, g_t = torch.from_numpy(qkv), torch.from_numpy(g)
    want = _jax_vjp(qkv, g, mask)
    excess = {name: float((np.abs(k2_wgmma_tf32(qkv_t, g_t, mask, H, three=three).numpy()
                                  - want) - TOL * np.abs(want)).max())
              for name, three in (("one", False), ("three", True))}
    assert excess["one"] > TOL, excess
    assert excess["three"] <= TOL, excess


def _swizzle(off, row_bytes):
    """The kernels' `swizzle<kRowBytes>`: bits 4.. XOR bits 7.."""
    return off ^ (((off >> 7) & (row_bytes // 16 - 1)) << 4)


def _tf_offset(r, c, Dh, rows):
    """`tf_offset<D, kRows>`: (row, 16-byte piece) of a K-major fp32 tile of
    `rows` rows, cut along d into sub-tiles of min(D, 32) floats."""
    sub = min(Dh, 32)
    row_bytes, pieces = 4 * sub, sub // 4
    return (c // pieces) * rows * row_bytes + _swizzle(r * row_bytes + (c % pieces) * 16,
                                                       row_bytes)


@pytest.mark.parametrize("Dh", [64, 32, 16])
def test_k2_wgmma_tf32_chunk_pieces(Dh):
    """`ChunkPieces<D>`: each of the block's 128 threads stages the piece
    tid % (D / 4) of rows tid / (D / 4) + kRowsPass k at its first row's
    offset plus k passes of kRowsPass rows, which is `tf_offset`'s place for
    that row (a pass is whole periods of the swizzle), and the threads'
    pieces fill the chunk's tile once each."""
    pieces = Dh // 4
    rows_pass = THREADS // pieces
    assert rows_pass % 8 == 0 and CHUNK % rows_pass == 0
    row_bytes = 4 * min(Dh, 32)
    placed = []
    for tid in range(THREADS):
        row, c = tid // pieces, tid % pieces
        off = _tf_offset(row, c, Dh, CHUNK)
        for k in range(CHUNK // rows_pass):
            at = off + k * rows_pass * row_bytes
            assert at == _tf_offset(row + rows_pass * k, c, Dh, CHUNK)
            placed.append(at)
    assert sorted(placed) == list(range(0, CHUNK * 4 * Dh, 16))


@pytest.mark.parametrize("Dh", [64, 32, 16])
def test_k2_wgmma_tf32_transposed_planes(Dh):
    """`transpose_split<D>`: thread tid writes, for d = tid % D, the pieces
    2j + h (h = tid / D % 2) of the transposed planes, rows 8j + h + (0, 2,
    4, 6) of the chunk: the threads write each (d, piece) once, and a
    piece's four rows are the k = q or q + 4 (h = 0 or 1) of an 8-row group
    that an A fragment taken from the accumulators holds (rows 2q, 2q + 1
    as k = q, q + 4)."""
    passes = THREADS // Dh  # pieces a pass
    written = set()
    for tid in range(THREADS):
        d, p0 = tid % Dh, tid // Dh
        for k in range(CHUNK // 4 // passes):
            piece = p0 + passes * k
            assert (piece & 1) == (p0 & 1)
            j, h = piece >> 1, piece & 1
            rows = [8 * j + h + 2 * i for i in range(4)]
            order = [2 * p if p < 4 else 2 * (p - 4) + 1 for p in range(8)]
            assert rows == [8 * j + order[4 * h + i] for i in range(4)]
            written.add((d, piece))
    assert written == {(d, p) for d in range(Dh) for p in range(CHUNK // 4)}


def tf32_pair_smem(Dh):
    """The kernels' `tf32_smem`: 1 KB of alignment, the lo planes of the
    two resident operands (64 rows), the chunk's two operands' hi and lo
    planes, four transposed planes (D rows of 32) and the two landing
    tiles."""
    return 1024 + 2 * ROWS * 4 * Dh + 6 * CHUNK * 4 * Dh + 4 * Dh * 4 * CHUNK


def test_k2_wgmma_tf32_two_blocks_an_sm():
    """At D = 64 a block takes 115,712 bytes, so two blocks fit an SM's
    233,472 with the 1 KB each block reserves; D = 32 and 16 take less."""
    assert tf32_pair_smem(64) == 115712
    assert 2 * (tf32_pair_smem(64) + 1024) <= 233472
    assert tf32_pair_smem(16) < tf32_pair_smem(32) < tf32_pair_smem(64)
