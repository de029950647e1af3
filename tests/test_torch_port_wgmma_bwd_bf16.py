"""K2's bf16 pair above 320 tokens on warpgroup MMA
(`attention_bwd_q_wgmma_bf16` and `attention_bwd_kv_wgmma_bf16` in
csrc/attention_bwd.cu): the kernels' index arithmetic mirrored in Python.

The kernels run only on a card (tests/test_torch_port_gpu.py and the
smoke's phase 3 hold them against `attention_bwd_reference` there, at every
length around their 64-row tiles and 64-row chunks, at D = 16, 32 and 64).
Their arithmetic, the 64-key chunks of the query side's statistics and the
rounding points, is emulated in tests/test_torch_port_streamed.py
(`_k2_pair`) against the JAX package's custom VJP.  What these tests pin
is the layout the kernels and wgmma agree on: the staging pieces' swizzled
offsets (`stage_swizzled<D>`: rows of 2D bytes, the 128-, 64- or 32-byte
swizzle), the descriptors of the K-major operands' k-steps and of the
transposed B operands' 16-row k-steps, the A fragments taken from the
accumulators (`pack_frag`), the key side's statistics pieces, and the
shared-memory budget (`bf16_wgmma_smem`) with its blocks an SM.
"""

import json
import os

import pytest

ROWS = 64      # kTile: rows a block (one warpgroup), and kChunk: rows a chunk
THREADS = 128  # kTileThreads
STAGES = 3     # kStages: the key side's ring
Q_STAGES = 2   # kQStages: the query side's
SM_SMEM = 233472  # an H100 SM's shared memory, of which a block reserves 1 KB
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _swizzled(off, D):
    """`swizzled<D>` (`swizzle<2D>`): bits 4.. of the byte offset XOR bits
    7.. (3, 2 or 1 of them at D = 64, 32, 16)."""
    return off ^ (((off >> 7) & (2 * D // 16 - 1)) << 4)


def _desc(addr, D):
    """`smem_desc<2D>`: start address >> 4, both 8-row group offsets (8 rows
    of 2D bytes, in 16-byte units) and the swizzle mode (1: 128 bytes, 2:
    64, 3: 32)."""
    mode = {64: 1, 32: 2, 16: 3}[D]
    group = (8 * 2 * D) >> 4
    return ((addr & 0x3FFFF) >> 4) | (group << 16) | (group << 32) | (mode << 62)


def _staged(D, rows=ROWS):
    """{(row, 16-byte piece): byte offset} of `stage_swizzled<D>` over a
    tile of `rows` rows, idx = tid + THREADS k: row idx / (D / 8), piece
    idx % (D / 8)."""
    pieces = D // 8
    out = {}
    for tid in range(THREADS):
        for idx in range(tid, rows * pieces, THREADS):
            r, c = idx // pieces, idx % pieces
            out[(r, c)] = _swizzled(r * 2 * D + c * 16, D)
    return out


@pytest.mark.parametrize("D", [64, 32, 16])
def test_k2_wgmma_bf16_staging_pieces(D):
    """The block's 128 threads stage every 16-byte piece of a 64-row tile
    once, each into its own row's 2D bytes (so rows stay 2D bytes apart, as
    the descriptors' 8-row strides say), and a K-major operand's k-step kk
    (d = 16 kk .. 16 kk + 15: the row's pieces 2 kk and 2 kk + 1) starts
    32 kk bytes into the tile, which is the descriptor plus 2 kk."""
    placed = _staged(D)
    assert len(placed) == ROWS * D // 8
    assert sorted(placed.values()) == list(range(0, ROWS * 2 * D, 16))
    for (r, c), off in placed.items():
        assert r * 2 * D <= off < (r + 1) * 2 * D
    for kk in range(D // 16):
        assert _desc(1024 + 32 * kk, D) == _desc(1024, D) + 2 * kk
        # the swizzle moves a row's pieces within the row only
        for r in range(8):
            assert {placed[(r, 2 * kk)], placed[(r, 2 * kk + 1)]} == {
                _swizzled(r * 2 * D + 32 * kk, D), _swizzled(r * 2 * D + 32 * kk + 16, D)}


@pytest.mark.parametrize("D", [64, 32, 16])
def test_k2_wgmma_bf16_transposed_b_steps(D):
    """dq += dS . K, dv += P^T . g and dk += dS^T . q read the chunk's rows
    (rows [row][d], d along the row) with the transpose bit, 16 rows a
    k-step: step j starts j * 16 * 2D bytes into the tile, a whole number of
    the swizzle's 8-row periods (so its pattern starts where the
    descriptor's does), and its descriptor differs from the tile's in the
    start address alone, the 8-row group stride staying 8 * 2D bytes."""
    tile = 4096
    period = 8 * 2 * D
    for j in range(4):
        start = tile + j * 16 * 2 * D
        assert (start - tile) % period == 0
        diff = _desc(start, D) - _desc(tile, D)
        assert diff == (j * 16 * 2 * D) >> 4 and diff < (1 << 14)
    assert (_desc(tile, D) >> 16) & 0x3FFF == period >> 4
    assert (_desc(tile, D) >> 32) & 0x3FFF == period >> 4


def test_k2_wgmma_bf16_fragments_from_the_accumulators():
    """`pack_frag`: the m64nNk16 accumulator puts lane (g, q)'s d[4i + e] at
    row g + 8 (e >> 1), column 8i + 2q + (e & 1); tiles 2j and 2j + 1,
    packed as a[2t] = (d[8j + 4t], d[8j + 4t + 1]) and a[2t + 1] = (d[8j +
    4t + 2], d[8j + 4t + 3]), are mma.sync's m16n8k16 A fragment of k-step
    j: a[0] (row g, k 2q, 2q + 1), a[1] (g + 8, same k), a[2] (g, k 8 + 2q,
    ..), a[3] (g + 8, 8 + 2q, ..)."""
    for lane in range(32):
        g, q = lane // 4, lane % 4

        def acc(i, e):
            return (g + 8 * (e >> 1), 8 * i + 2 * q + (e & 1))

        for j in range(4):
            frag = []
            for t in range(2):
                frag.append((acc(2 * j + t, 0), acc(2 * j + t, 1)))
                frag.append((acc(2 * j + t, 2), acc(2 * j + t, 3)))
            want = [((g, 2 * q), (g, 2 * q + 1)), ((g + 8, 2 * q), (g + 8, 2 * q + 1)),
                    ((g, 8 + 2 * q), (g, 9 + 2 * q)), ((g + 8, 8 + 2 * q), (g + 8, 9 + 2 * q))]
            got = [tuple((row, col - 16 * j) for row, col in half) for half in frag]
            assert got == want, (lane, j)


def test_k2_wgmma_bf16_statistics_pieces():
    """The key side stages a chunk's statistics, lse then r * D^-0.5 (64
    floats each, from the workspace's two rows), with threads 0-31 taking
    one 16-byte piece each: every float once, and each thread of the
    warpgroup reads its columns' pairs (8i + 2q, 8i + 2q + 1) inside them."""
    floats = []
    for tid in range(2 * ROWS // 4):
        a, o = tid // (ROWS // 4), 4 * (tid % (ROWS // 4))
        floats += [a * ROWS + o + k for k in range(4)]
    assert sorted(floats) == list(range(2 * ROWS))
    cols = {8 * i + 2 * q + e for i in range(8) for q in range(4) for e in range(2)}
    assert cols == set(range(ROWS))


def bf16_wgmma_smem(D):
    """The key side's `bf16_wgmma_smem`: 1 KB of alignment, the two resident
    tiles, kStages stages of two chunk tiles (64 rows of 2D bytes each),
    and the statistics of kStages chunks (2 x 64 floats)."""
    return 1024 + (2 + 2 * STAGES) * ROWS * 2 * D + STAGES * 2 * ROWS * 4


def bf16_wgmma_q_smem(D):
    """The query side's `bf16_wgmma_q_smem`: the same without statistics,
    in kQStages stages."""
    return 1024 + (2 + 2 * Q_STAGES) * ROWS * 2 * D


def test_k2_wgmma_bf16_blocks_an_sm():
    """At D = 64 a key-side block takes 68,096 bytes and a query-side block
    50,176, so three and four blocks fit an SM's 233,472 with the 1 KB each
    block reserves, as their __launch_bounds__ ask (the registers of 3 and 4
    warpgroups: 168 and 128 a thread); the ring's tiles, 8 KB at D = 64 and
    2 KB at D = 16, keep the 1024-byte swizzle period; D = 32 and 16 take
    less."""
    assert bf16_wgmma_smem(64) == 68096 and bf16_wgmma_q_smem(64) == 50176
    assert SM_SMEM // (bf16_wgmma_smem(64) + 1024) == 3
    assert SM_SMEM // (bf16_wgmma_q_smem(64) + 1024) == 4
    assert 65536 // (3 * THREADS) >= 168 and 65536 // (4 * THREADS) == 128
    for smem in (bf16_wgmma_smem, bf16_wgmma_q_smem):
        assert smem(16) < smem(32) < smem(64)
    for D in (64, 32, 16):
        assert (ROWS * 2 * D) % 1024 == 0


def test_k2_variant_spec_applies_to_the_shipped_source(tmp_path, monkeypatch):
    """Every variant of scripts/kernel_variants/k2_bf16_pair.json assembles
    from the shipped csrc/: its patches each match a source file, and the
    variant's attention_bwd.cu still holds the pair and the C interface."""
    import importlib.util

    spec_path = os.path.join(HERE, "scripts", "kernel_variants", "k2_bf16_pair.json")
    mod = importlib.util.spec_from_file_location(
        "kernel_variants", os.path.join(HERE, "scripts", "kernel_variants.py"))
    kv = importlib.util.module_from_spec(mod)
    mod.loader.exec_module(kv)
    monkeypatch.setattr(kv, "HERE", str(tmp_path))
    with open(spec_path) as f:
        spec = json.load(f)
    assert spec["library"] == "attention_bwd"
    csrc = os.path.join(HERE, "menghini_neurips23_tpu_torch", "csrc")
    for name, v in spec["variants"].items():
        if v.get("src") == "parent":
            continue
        d = kv.make_source(spec, os.path.dirname(spec_path), name, v, None, csrc)
        with open(os.path.join(d, "attention_bwd.cu")) as f:
            text = f.read()
        assert "mnt_attention_bwd(" in text and "attention_bwd_kv_wgmma_bf16" in text, name


def test_sass_compare_needs_nvcc(capsys, monkeypatch):
    """scripts/sass_compare.py (every entry point's machine code against
    the parent tree's) exits 1 where no nvcc is found, before building
    anything."""
    import importlib.util

    from menghini_neurips23_tpu_torch.ops import _cuda

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_cuda, "nvcc_path", no_nvcc)
    mod = importlib.util.spec_from_file_location(
        "sass_compare", os.path.join(HERE, "scripts", "sass_compare.py"))
    script = importlib.util.module_from_spec(mod)
    mod.loader.exec_module(script)
    assert script.main([]) == 1
    assert "nvcc not found" in capsys.readouterr().err
