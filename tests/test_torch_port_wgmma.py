"""K1's bf16 forward above 128 tokens on warpgroup MMA (`attention_fwd_onesweep`
up to 320 tokens and `attention_fwd_wgmma` past them, in
csrc/attention_fwd.cu), its schedules emulated in plain torch, against the
JAX package's fused attention on the CPU and the port's plain version.

The kernels run only on a card (tests/test_torch_port_gpu.py holds them
against `attention_reference` there).  What these tests pin is their
arithmetic, tile by tile as the kernels take it: a warpgroup per 64 query
rows (rows past T zero-filled), 64-key chunks of K and V (keys past T
zero-filled), -inf past T and past a causal row's diagonal.  Up to 320
tokens, one sweep: every chunk's scores held at once, each row's exact max
m over them, P = 2^(s - m) (s the scores times D^-0.5 * log2(e)) formed
once, its sum l over the 8-key groups up to the tile's keys (the groups
past them are 0), P * (1 / l) rounded to bf16 and P . V added in 16-key
steps up to the tile's keys.  Past 320, two sweeps over the chunks a causal
tile sees: sweep 1 keeps each row's online max m and sum l of 2^(s - m),
sweep 2 recomputes the scores and adds the rounded 2^(s - m) * (1 / l)
times V in 16-key steps.  The products are of bf16 values, which fp32
holds exactly.  The JAX side runs its Pallas kernel as its own tests do
off-TPU (interpreted); the same numpy inputs, made from a seed, go to both.

Tolerance: bf16 2e-2, as in tests/test_torch_port_ops.py and
tests/test_torch_port_streamed.py (both sides round the probabilities and
the outputs to bf16 at the same points; sums run in another order).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from menghini_neurips23_tpu.ops.attention import fused_attention as jax_fused_attention
from menghini_neurips23_tpu_torch.ops.attention import attention_reference

torch.set_num_threads(2)

TOL = 2e-2  # bf16
B, H = 2, 2
ROWS = 64  # query rows a warpgroup
KEYS = 64  # keys a chunk, in both sweeps
LOG2E = 1.4426950408889634


def _inputs(T, D, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(0, 1, (B, T, 3 * H * D)).astype(np.float32)


def _heads(x, rows):
    """(B, T, H*D) -> (B, H, rows, D) fp32, zero past T (the kernel's
    zero-filled loads)."""
    T = x.shape[1]
    h = x.reshape(B, T, H, -1).transpose(1, 2).float()
    return torch.nn.functional.pad(h, (0, 0, 0, rows - T))


RESIDENT_MAX_SEQ = 320  # up to here one sweep (K and V resident), past it two


def _k1_wgmma(qkv, mask):
    """The kernels' schedules on bf16 qkv: (B, T, 3W) -> (B, T, W) bf16."""
    dt = qkv.dtype
    T, W = qkv.shape[1], qkv.shape[2] // 3
    D = W // H
    padded = math.ceil(T / ROWS) * ROWS
    q, k, v = (_heads(t, padded) for t in qkv.split(W, dim=-1))
    scale2 = torch.tensor(D**-0.5, dtype=torch.float32) * torch.tensor(LOG2E, dtype=torch.float32)
    causal = mask == "causal"
    out = torch.zeros(B, H, padded, D)
    for rt in range(0, padded, ROWS):  # a warpgroup's tile
        rows = torch.arange(rt, rt + ROWS)[:, None]
        kend = min(T, rt + ROWS) if causal else T  # the keys the tile's rows see
        seen = 8 * math.ceil(kend / 8)  # keys up to the last 8-key group the tile sees

        def scores(c0, keys=KEYS):
            s = torch.matmul(q[:, :, rt:rt + ROWS], k[:, :, c0:c0 + keys].transpose(-1, -2))
            cols = torch.arange(c0, c0 + keys)[None, :]
            valid = (cols < T) & ((cols <= rows) if causal else True)
            return torch.where(valid, s * scale2, torch.tensor(float("-inf")))

        def p_dot_v(p, c0, keys):  # O += P . V in 16-key steps up to the tile's keys
            o = torch.zeros(B, H, ROWS, D)
            for j in range(keys // 16):
                if c0 + 16 * j < kend:
                    o = o + torch.matmul(p[..., 16 * j:16 * j + 16],
                                         v[:, :, c0 + 16 * j:c0 + 16 * j + 16])
            return o

        if T <= RESIDENT_MAX_SEQ:  # one sweep: every chunk's scores held
            s = scores(0, padded)  # (a causal tile computes its chunks past the diagonal too)
            m = s.amax(-1, keepdim=True)  # exact: key 0 keeps every row's m finite
            p = torch.exp2(s - m)
            p = torch.where(torch.arange(padded) < seen, p, torch.zeros(()))
            inv_l = 1 / p.sum(-1, keepdim=True)
            out[:, :, rt:rt + ROWS] = p_dot_v((p * inv_l).to(dt).float(), 0, padded)
            continue
        chunks = [c0 for c0 in range(0, padded, KEYS) if c0 < kend]
        m = torch.full((B, H, ROWS, 1), float("-inf"))
        l = torch.zeros(B, H, ROWS, 1)
        for c0 in chunks:  # sweep 1: key 0 keeps every row's m finite after chunk 0
            s = scores(c0)
            mn = torch.maximum(m, s.amax(-1, keepdim=True))
            part = torch.exp2(s - mn)[..., : max(0, min(KEYS, seen - c0))]
            l = l * torch.exp2(m - mn) + part.sum(-1, keepdim=True)
            m = mn
        inv_l = 1 / l
        o = torch.zeros(B, H, ROWS, D)
        for c0 in chunks:  # sweep 2
            p = torch.exp2(scores(c0) - m) * inv_l
            p = torch.where(torch.arange(c0, c0 + KEYS) < seen, p, torch.zeros(()))
            o = o + p_dot_v(p.to(dt).float(), c0, KEYS)
        out[:, :, rt:rt + ROWS] = o
    return out[:, :, :T].transpose(1, 2).reshape(B, T, W).to(dt)


def _jax_forward(qkv, mask):
    out = jax_fused_attention(jnp.asarray(qkv).astype(jnp.bfloat16), mask, H)
    return np.asarray(out.astype(jnp.float32))


# T = 129: one key past the short kernels (three chunks); 192 and 193: the
# last length of three chunks and the first of four; 200: a ragged last
# chunk and tile; 256 and 257: the last of four chunks and the first of
# five (ViT-L/14, one key in the last chunk); 261: UPT's 4-token prompt;
# 273: a 16-token VPT prompt; 320: the last length K and V stay resident
# (five whole chunks); 321: the first streamed length; 337: an 80-token VPT
# prompt; 577: ViT-L/14@336.  D = 64 (ViT-L/14), 32 and 16, which take the
# 128-, 64- and 32-byte swizzles.
@pytest.mark.parametrize("D", [64, 32, 16])
@pytest.mark.parametrize("T", [129, 192, 193, 200, 256, 257, 261, 273, 320, 321, 337, 577])
@pytest.mark.parametrize("mask", [None, "causal"], ids=["unmasked", "causal"])
def test_k1_wgmma_schedule_matches_jax(mask, T, D):
    """The warpgroup schedules (64-row tiles, 64-key chunks: one sweep up to
    320 tokens, two past them; 16-key P.V steps) against the JAX package's
    fused attention (its Pallas forward, interpreted off-TPU) and the port's
    plain version, at 2e-2."""
    qkv = _inputs(T, D, 700 + T + D)
    qkv_t = torch.from_numpy(qkv).to(torch.bfloat16)
    got = _k1_wgmma(qkv_t, mask)
    assert got.dtype == torch.bfloat16 and got.shape == (B, T, H * D)
    assert torch.isfinite(got.float()).all()
    np.testing.assert_allclose(got.float().numpy(), _jax_forward(qkv, mask), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.float().numpy(),
                               attention_reference(qkv_t, mask, H).float().numpy(), rtol=TOL,
                               atol=TOL)


def _swizzled(off, D):
    """The kernel's `swizzled<D>`: byte offset in a tile of rows of 2D bytes,
    bits 4.. XOR bits 7.. (3, 2 or 1 of them for D = 64, 32, 16)."""
    return off ^ (((off >> 7) & (D // 8 - 1)) << 4)


@pytest.mark.parametrize("D", [64, 32, 16])
def test_k1_wgmma_swizzle_keeps_rows_and_pieces(D):
    """Staging a 64-row tile in the swizzled layout sends each 16-byte piece
    of a row to a distinct 16-byte slot of the same row (so rows stay 2D
    bytes apart, as the descriptors' 8-row strides say), the pattern repeats
    every 1024 bytes (tiles start on a multiple of 1024), and the 8 rows of a
    group spread the pieces of one column over 8 distinct bank groups (128
    bytes) where a row is 128 bytes."""
    row = 2 * D
    for r in range(ROWS):
        slots = [_swizzled(r * row + 16 * c, D) for c in range(row // 16)]
        assert sorted(slots) == [r * row + 16 * c for c in range(row // 16)]
    tile = [_swizzled(off, D) for off in range(0, ROWS * row, 16)]
    assert sorted(tile) == list(range(0, ROWS * row, 16))
    assert all(_swizzled(off + 1024, D) == _swizzled(off, D) + 1024 for off in range(0, 1024, 16))
    if D == 64:
        for c in range(8):
            assert len({_swizzled(r * row + 16 * c, D) % 128 for r in range(8)}) == 8


def test_resident_compare_script_needs_a_card(capsys):
    """scripts/streamed_attention_compare.py --resident, which times this
    kernel from 129 to 320 tokens on the card, exits 1 without one (here)
    before building anything."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts",
                        "streamed_attention_compare.py")
    spec = importlib.util.spec_from_file_location("streamed_attention_compare", path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    assert not torch.cuda.is_available()
    assert script.main(["--resident"]) == 1
    assert "needs a CUDA card" in capsys.readouterr().err


def _script(name):
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts",
                        f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    return script


@pytest.mark.parametrize("name", ["kernel_variants", "k1_fp32_exp2_check"])
def test_variant_scripts_need_a_card(name, capsys):
    """scripts/kernel_variants.py (K1 bf16 variants timed against each other)
    and scripts/k1_fp32_exp2_check.py (K1 fp32's exponential against fp64)
    exit 1 without a card (here) before building anything."""
    assert not torch.cuda.is_available()
    assert _script(name).main([]) == 1
    assert "needs a CUDA card" in capsys.readouterr().err


def test_kernel_variants_apply_to_the_shipped_source(tmp_path, monkeypatch):
    """Every variant of scripts/kernel_variants/k1_bf16_above_128.json
    assembles from the shipped csrc/: its regions are found and its patches
    each match a source file, so that the measured alternatives stay
    rebuildable."""
    import json
    import os

    kv = _script("kernel_variants")
    monkeypatch.setattr(kv, "HERE", str(tmp_path))
    with open(kv.SPEC) as f:
        spec = json.load(f)
    csrc = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "menghini_neurips23_tpu_torch", "csrc")
    for name, v in spec["variants"].items():
        if v.get("src") == "parent":
            continue
        d = kv.make_source(spec, os.path.dirname(kv.SPEC), name, v, None, csrc)
        with open(os.path.join(d, "attention_fwd.cu")) as f:
            text = f.read()
        assert "mnt_attention_fwd(" in text and "attention_fwd_onesweep" in text, name
