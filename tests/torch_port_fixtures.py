"""Fixtures shared by the port's CPU tests (tests/test_torch_port_*.py).

`native_build_outside_checkout` sends the port's native C++ builds
(menghini_neurips23_tpu_torch/data/_native.py, build/native/ at the
repository root by default) into a temporary directory, so that a test run
writes nothing into the checkout.  A test file takes it by importing it.

`l14_grid_runtimes` is a (JAX, port) pair of CPU runtimes on the same
weights of L14_GRID: ViT-L/14's patch grid (224 px / 14 = 256 patches) at
the tiny-test widths, two vision layers and one text layer, registered in
both packages' ARCHS while the fixture lives.  VPT's 16-token prefix makes
its vision sequence 1 + 256 + 16 = 273 tokens and UPT's 4-token prompt 261:
the lengths the attention backward tiles on the card.

`mm_3xtf32` and `mm_1xtf32` emulate the attention kernels' fp32 products on
the tensor cores (tests/test_torch_port_streamed.py, test_torch_port_twophase.py):
each operand x split on its bit pattern into hi (x rounded to TF32's 10
fraction bits, to nearest, ties away from zero, as cvt.rna.tf32.f32 rounds)
and lo (x - hi cut to TF32), and lo.hi + hi.lo + hi.hi summed in fp32; or
one product of both operands rounded to TF32.

`k1_wgmma_tf32` and `k2_wgmma_tf32` emulate, tile by tile, the schedules of
the attention kernels' fp32 forms above 128 tokens on warpgroup MMA (K1's
`attention_fwd_tf32`, K2's pair `attention_bwd_{q,kv}_tf32`): their tiles
and chunks, rounding points and statistics, and every product as the
kernels chain its wgmma k-steps (8 values of k each): the small terms
first, the k-steps added one by one to the running fp32 sum, each chain
started in a zeroed tile where the kernel starts one and the tiles added in
fp32.  With `three=False` every product is one TF32 product of the hi
parts.  `acc_truncating` adds a k-step as a model of the tensor cores'
adders (below), for the chain comparisons of
tests/test_torch_port_wgmma_tf32.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from menghini_neurips23_tpu_torch.data import _native

L14_GRID = "tiny-l14-grid"


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


def mm_3xtf32(a, b):
    """a @ b as the kernels form it: lo.hi + hi.lo + hi.hi, in fp32."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    return torch.matmul(al, bh) + torch.matmul(ah, bl) + torch.matmul(ah, bh)


def mm_1xtf32(a, b):
    """a @ b from one TF32 product: both operands rounded to TF32."""
    return torch.matmul(_tf32_hi(a), _tf32_hi(b))


LOG2E = 1.4426950408889634


def acc_fp32(c, a, b):
    """c + a @ b, one wgmma k-step added to the running sum in fp32."""
    return c + torch.matmul(a, b)


def acc_truncating(c, a, b, bits=24):
    """c + a @ b as a model of the tensor cores' adders: the k-step's
    products and c, each exact, aligned to the largest of them and cut to
    `bits` bits below its leading one, summed, and the sum cut to fp32
    (rounded toward zero).  A model, not the hardware's documented
    behaviour (there is none): it shows how a chain's order and length
    move the error, not the card's error itself."""
    c = torch.as_tensor(c, dtype=torch.float32).expand(*a.shape[:-1], b.shape[-1])
    terms = torch.cat([c.double().unsqueeze(-2), a.double().unsqueeze(-1) * b.double().unsqueeze(-3)],
                      dim=-2)
    top = torch.frexp(terms.abs().amax(-2, keepdim=True).clamp_min(1e-300))[1]
    ulp = torch.ldexp(torch.ones_like(terms), (top - bits).expand_as(terms))
    total = (torch.trunc(terms / ulp) * ulp).sum(-2)
    out = total.float()
    over = out.double().abs() > total.abs()
    return torch.where(over, torch.nextafter(out, torch.zeros_like(out)), out)


def _k8(x, kk):
    """k-step kk of x: its columns 8kk .. 8kk + 7."""
    return x[..., 8 * kk:8 * kk + 8]


def _chain(c, pairs, acc):
    """c plus each (a, b) of `pairs` in turn: one wgmma k-step each."""
    for a, b in pairs:
        c = acc(c, a, b)
    return c


def wgmma_dots(a, b, split=None, three=True, acc=acc_fp32):
    """a @ b^T over the last axis (K-major operands, both of D), as the
    kernels chain m64nNk8 k-steps: lo.hi, then hi.lo over every k-step,
    then hi.hi, into a zeroed tile; with `split`, hi.hi from k-step
    `split` on goes to a second zeroed tile, added in fp32."""
    ks = a.shape[-1] // 8
    if not three:
        return _chain(0, [(_k8(_tf32_hi(a), k), _k8(_tf32_hi(b), k).transpose(-1, -2))
                          for k in range(ks)], acc)
    (ah, al), (bh, bl) = _split(a), _split(b)
    steps = lambda x, y, kks: [(_k8(x, k), _k8(y, k).transpose(-1, -2)) for k in kks]
    split = ks if split is None else split
    c1 = _chain(0, steps(al, bh, range(ks)) + steps(ah, bl, range(ks))
                + steps(ah, bh, range(split)), acc)
    return c1 + _chain(0, steps(ah, bh, range(split, ks)), acc) if split < ks else c1


def wgmma_times(p, rows, three=True, acc=acc_fp32):
    """p @ rows over a chunk (p's last axis, its keys or queries), as the
    kernels chain the k-steps of an RS product whose A comes from an
    accumulator (P, dS) and whose B is the chunk's rows transposed: lo.hi,
    then hi.lo, then hi.hi over the chunk's k-steps, into a zeroed tile."""
    ks = p.shape[-1] // 8
    rk = lambda x, k: x[..., 8 * k:8 * k + 8, :]
    if not three:
        return _chain(0, [(_k8(_tf32_hi(p), k), rk(_tf32_hi(rows), k)) for k in range(ks)], acc)
    (ph, pl), (bh, bl) = _split(p), _split(rows)
    return _chain(0, [(_k8(pl, k), rk(bh, k)) for k in range(ks)]
                  + [(_k8(ph, k), rk(bl, k)) for k in range(ks)]
                  + [(_k8(ph, k), rk(bh, k)) for k in range(ks)], acc)


def _heads(x, heads, rows):
    """(B, T, H*D) -> (B, H, rows, D) fp32, zero past T (the kernels'
    zero-filled loads)."""
    B, T = x.shape[:2]
    h = x.reshape(B, T, heads, -1).transpose(1, 2).float()
    return torch.nn.functional.pad(h, (0, 0, 0, rows - T))


def _merge(x, T):
    """(B, H, rows, D) -> (B, T, H*D)."""
    B, H, _, D = x.shape
    return x[:, :, :T].transpose(1, 2).reshape(B, T, H * D)


def k1_wgmma_tf32(qkv, mask, heads, three=True, acc=acc_fp32, s_tiles=1, pv_tiles=2):
    """K1's fp32 schedule above 128 tokens (`attention_fwd_tf32`) on fp32
    qkv: (B, T, 3W) -> (B, T, W).  A warpgroup per 64 query rows (rows past
    T zero-filled), 64-key chunks of K and V (keys past T zero-filled) in
    both sweeps, a causal tile's chunks only up to its diagonal; sweep 1
    keeps each row's online max m of the raw scores and sum l of 2^((s - m)
    D^-0.5 log2(e)) (-inf past T and the diagonal), leaving out the 8-key
    groups past the tile's keys; sweep 2 recomputes the scores, forms P =
    2^((s - m) D^-0.5 log2(e)) * (1 / l) in fp32 (0 in the 8-key groups past
    the tile's keys) and adds each chunk's P . V to O over its two halves
    of 32 keys (the second only where the tile's keys reach it), each half
    in a zeroed tile of its own (`pv_tiles` = 2; 1: both halves in one tile
    a chunk, as the kernel chained them before).  S goes to one tile
    (`s_tiles` = 2: its hi.hi over the second half of d to a second one, a
    variant the card measured no better)."""
    T, W = qkv.shape[1], qkv.shape[2] // 3
    D = W // heads
    padded = -(-T // 64) * 64
    q, k, v = (_heads(t, heads, padded) for t in qkv.split(W, dim=-1))
    scale2 = torch.tensor(D**-0.5, dtype=torch.float32) * torch.tensor(LOG2E, dtype=torch.float32)
    causal = mask == "causal"
    out = torch.zeros_like(q)
    for rt in range(0, padded, 64):  # a warpgroup's tile
        rows = torch.arange(rt, rt + 64)[:, None]
        kend = min(T, rt + 64) if causal else T  # the keys the tile's rows see
        chunks = [c0 for c0 in range(0, padded, 64) if c0 < kend]
        qt = q[:, :, rt:rt + 64]

        def scores(c0):
            s = wgmma_dots(qt, k[:, :, c0:c0 + 64], D // 16 if s_tiles == 2 else None, three, acc)
            cols = torch.arange(c0, c0 + 64)[None, :]
            valid = (cols < T) & ((cols <= rows) if causal else True)
            return torch.where(valid, s, torch.tensor(float("-inf")))

        m = torch.full(qt.shape[:-1] + (1,), float("-inf"))
        l = torch.zeros_like(m)
        for c0 in chunks:  # sweep 1: key 0 keeps every row's m finite after chunk 0
            s = scores(c0)
            mn = torch.maximum(m, s.amax(-1, keepdim=True))
            seen = [i for i in range(8) if c0 + 8 * i < kend]  # 8-key groups
            part = torch.exp2(s * scale2 - mn * scale2)[..., : 8 * len(seen)]
            l = l * torch.exp2(m * scale2 - mn * scale2) + part.sum(-1, keepdim=True)
            m = mn
        inv_l = 1 / l
        o = torch.zeros_like(qt)
        for c0 in chunks:  # sweep 2
            p = torch.exp2(scores(c0) * scale2 - m * scale2) * inv_l
            p = torch.where(torch.arange(c0, c0 + 64) < c0 + 8 * -(-(kend - c0) // 8), p,
                            torch.zeros(()))
            halves = [wgmma_times(p[..., 32 * h:32 * h + 32], v[:, :, c0 + 32 * h:c0 + 32 * h + 32],
                                  three, acc) for h in range(2 if c0 + 32 < kend else 1)]
            if pv_tiles == 2:
                for part in halves:
                    o = o + part
            else:  # the chunk's two halves chained in one tile
                ph = [p[..., :32], p[..., 32:]][:len(halves)]
                o = o + _chain_halves(ph, [v[:, :, c0:c0 + 32], v[:, :, c0 + 32:c0 + 64]], three,
                                      acc)
        out[:, :, rt:rt + 64] = o
    return _merge(out, T)


def _chain_halves(ps, vs, three, acc):
    """A chunk's P.V as the parent K1 chained it: both halves' k-steps (each
    half lo.hi, hi.lo, hi.hi) into one zeroed tile."""
    c = 0
    for p, v in zip(ps, vs):
        (ph, pl), (bh, bl) = (_split(p), _split(v)) if three else ((_tf32_hi(p), None),
                                                                  (_tf32_hi(v), None))
        rk = lambda x, k: x[..., 8 * k:8 * k + 8, :]
        pairs = ([(_k8(pl, k), rk(bh, k)) for k in range(4)] + [(_k8(ph, k), rk(bl, k))
                                                                  for k in range(4)]
                 if three else [])
        c = _chain(c, pairs + [(_k8(ph, k), rk(bh, k)) for k in range(4)], acc)
    return c


def k2_wgmma_tf32(qkv, g, mask, heads, three=True):
    """K2's fp32 pair above 128 tokens (`attention_bwd_q_tf32`, then
    `attention_bwd_kv_tf32`) on fp32 qkv and g: (B, T, 3W) dqkv.  Every
    (row, head) at once: a tile's chunks past its diagonal (causal), which
    the kernels skip, add exact zeros here.  Query side, 32-key chunks of K
    and V (keys past T zero-filled): sweep 1 forms S = q . K^T (hi.hi over
    each half of d in its own zeroed tile) and dP = g . V^T, -inf past T and
    the diagonal, and keeps each row's online max m of the raw dots, l =
    sum 2^(s c - m c) and rho = sum 2^(s c - m c) dP (c = D^-0.5 log2(e));
    each row's lse = m c + log2(l) and r D^-0.5 = rho / l D^-0.5 (+inf and 0
    past T) go to the workspace; sweep 2 forms S and dP again, P = 2^(s c -
    lse), dS = P (dP D^-0.5 - r D^-0.5) and dq += dS . K, each chunk's in a
    zeroed tile.  Key side, 32-query chunks of q and g with their lse and r:
    S^T = K . q^T and dP^T = V . g^T (hi.hi in one tile), P^T = 2^(s c -
    lse) (0 for a query before the key, causal), dS^T = P^T (dP^T D^-0.5 -
    r D^-0.5), dv += P^T . g and dk += dS^T . q, each chunk's in a zeroed
    tile."""
    B, T, W3 = qkv.shape
    W = W3 // 3
    D = W // heads
    rows = -(-T // 64) * 64  # the 64-row tiles of both sides
    q, k, v = (_heads(t, heads, rows) for t in qkv.split(W, dim=-1))
    gh = _heads(g, heads, rows)
    scale = torch.tensor(D**-0.5, dtype=torch.float32)
    scale2 = scale * torch.tensor(LOG2E, dtype=torch.float32)
    causal = mask == "causal"
    idx = torch.arange(rows)
    chunks = range(0, -(-T // 32) * 32, 32)

    def masked(s, c0):  # (query, key)
        cols = torch.arange(c0, c0 + 32)[None, :]
        valid = (cols < T) & ((cols <= idx[:, None]) if causal else True)
        return torch.where(valid, s, torch.tensor(float("-inf")))

    # query side, sweep 1
    m = torch.full((B, heads, rows, 1), float("-inf"))
    l = torch.zeros_like(m)
    rho = torch.zeros_like(m)
    for c0 in chunks:
        s = masked(wgmma_dots(q, k[:, :, c0:c0 + 32], D // 16, three), c0)
        dp = wgmma_dots(gh, v[:, :, c0:c0 + 32], D // 16, three)
        mn = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m * scale2 - mn * scale2)
        p = torch.exp2(s * scale2 - mn * scale2)
        l = l * alpha + p.sum(-1, keepdim=True)
        rho = rho * alpha + (p * dp).sum(-1, keepdim=True)
        m = mn
    inside = (idx < T)[:, None]
    lse = torch.where(inside, m * scale2 + torch.log2(l), torch.tensor(float("inf")))
    rs = torch.where(inside, rho / l * scale, torch.zeros(()))
    # query side, sweep 2
    dq = torch.zeros_like(q)
    for c0 in chunks:
        s = masked(wgmma_dots(q, k[:, :, c0:c0 + 32], D // 16, three), c0)
        dp = wgmma_dots(gh, v[:, :, c0:c0 + 32], D // 16, three)
        p = torch.exp2(s * scale2 - lse)
        dq = dq + wgmma_times(p * (dp * scale - rs), k[:, :, c0:c0 + 32], three)
    # key side: the statistics by query, as the workspace holds them
    lse_q, rs_q = lse[..., 0][:, :, None, :], rs[..., 0][:, :, None, :]
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for c0 in chunks:
        qc, gc = q[:, :, c0:c0 + 32], gh[:, :, c0:c0 + 32]
        st = wgmma_dots(k, qc, None, three)  # (key, query)
        dpt = wgmma_dots(v, gc, None, three)
        pt = torch.exp2(st * scale2 - lse_q[..., c0:c0 + 32])
        if causal:
            pt = torch.where(idx[:, None] <= torch.arange(c0, c0 + 32)[None, :], pt,
                             torch.zeros(()))
        dv = dv + wgmma_times(pt, gc, three)
        dk = dk + wgmma_times(pt * (dpt * scale - rs_q[..., c0:c0 + 32]), qc, three)
    return torch.cat([_merge(t, T) for t in (dq, dk, dv)], dim=-1)


@pytest.fixture(scope="module", autouse=True)
def native_build_outside_checkout(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(_native, "_BUILD_DIR", str(tmp_path_factory.mktemp("native")))
        yield


@pytest.fixture(scope="module")
def l14_grid_runtimes(tmp_path_factory):
    from menghini_neurips23_tpu.config import Config as JaxConfig
    from menghini_neurips23_tpu.models import configs as jax_configs
    from menghini_neurips23_tpu.runtime import ClipRuntime as JaxClipRuntime
    from menghini_neurips23_tpu_torch.config import Config
    from menghini_neurips23_tpu_torch.models import configs
    from menghini_neurips23_tpu_torch.runtime import ClipRuntime
    from tests.test_torch_parity import _make_state_dict

    grid = dict(name=L14_GRID, image_resolution=224, vision_patch_size=14, transformer_layers=1)
    jarch = dataclasses.replace(jax_configs.TINY_TEST, **grid)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_configs.ARCHS, L14_GRID, jarch)
        mp.setitem(configs.ARCHS, L14_GRID, dataclasses.replace(configs.TINY_TEST, **grid))
        sd = _make_state_dict(jarch, np.random.default_rng(17))
        path = tmp_path_factory.mktemp("ckpt") / "l14_grid_openai.pt"
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
        jax_rt = JaxClipRuntime(JaxConfig(VIS_ENCODER=L14_GRID, BATCH_SIZE=8, CLIP_CKPT=str(path)))
        port_rt = ClipRuntime(Config(VIS_ENCODER=L14_GRID, BATCH_SIZE=8, CLIP_CKPT=str(path)),
                              device="cpu")
        assert jax_rt.arch.name == port_rt.arch.name == L14_GRID
        assert port_rt.arch.num_patches == 256
        yield jax_rt, port_rt
