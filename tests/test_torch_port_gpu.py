"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Each test decides inside itself whether a card is present and skips with a
reason when it is not (the CPU test run).  On a machine with an H100 run

    python -m pytest --noconftest -m gpu tests/test_torch_port_gpu.py

(`--noconftest`: tests/conftest.py sets up JAX, which this file does not
use).  The kernels build from csrc/ on first use.

Tolerances: fp32 1e-5 (the kernel and the plain version sum in another
order); bf16 2e-2 (the kernel and the plain version may round a probability
or an output to neighbouring bf16 values, one bf16 step being 2^-8 of the
value).  The CLIP head's output is fp32 probabilities from fp32 math: 2e-5.

The attention backward (K2) is held to the same absolute tolerances plus the
same relative one (rtol 1e-5 fp32, 2e-2 bf16): its gradients reach |4| and
more on unit-scale inputs (a causal key 0 collects dS from every query row),
where one bf16 step is 2^-6 = 0.016 and two neighbouring roundings of dS
(taken from fp32 sums in another order) add another step; 2e-2 of the value
covers both.  K4 (the phase-grouped forward) takes K1's tolerances, against
its plain version and against K1.  Its bf16 output is compared with the plain version's bf16
output, never with autograd of the bf16 forward: dS uses the fp32 P.  The
`FusedAttention` gradient is compared with autograd of the plain forward in
fp32 only, where the two agree to rounding (1e-5 + 1e-5 relative).
"""

import pytest
import torch

from menghini_neurips23_tpu_torch.ops.attention import (
    attention_bwd,
    attention_bwd_reference,
    attention_reference,
    fused_attention,
)
from menghini_neurips23_tpu_torch.ops.clip_head import fused_probs, fused_probs_reference
from menghini_neurips23_tpu_torch.ops.twophase_attention import (
    twophase_attention,
    twophase_attention_reference,
)

pytestmark = pytest.mark.gpu

ATTN_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
HEAD_TOL = 2e-5


def _require_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# Ragged lengths around the kernels' 16-row tiles and 128-key chunks, up to
# K2's whole-sequence path's 128, at D = 16 (the tiny-test arch), 32 and 64
# (B = 1), unmasked and causal: (B, T, W, heads, mask); then the lengths K2
# tiles (129 ... 320, around its 64-row tiles and chunks and K1's 64-key
# chunks, ViT-L/14's 257, 261 and 273, and 320, the last length bf16 keeps K
# and V resident); then the lengths both kernels stream (321 on, around
# their 64-key and 64-row chunks, ViT-L/14's 337 with an 80-token prompt,
# ViT-L/14@336's 577)
EDGE_T = (1, 15, 16, 17, 48, 63, 64, 65, 66, 77, 128)
LONG_EDGE_T = (129, 143, 191, 192, 193, 257, 261, 273, 320)
STREAMED_EDGE_T = (321, 337, 383, 384, 385, 577, 1024)
EDGE_CASES, LONG_EDGE_CASES, STREAMED_EDGE_CASES = ([
    (b, t, w, w // d, mask)
    for t in lengths
    for b, w, d in ((3, 32, 16), (2, 64, 32), (1, 128, 64))
    for mask in (None, "causal")
] for lengths in (EDGE_T, LONG_EDGE_T, STREAMED_EDGE_T))

# (B, T, W, heads, mask): tiny-test widths (D=16), D=32, then the main path's
# shapes - ViT-B/32 vision, the text tower truncated, at Flowers102's 48 and
# at full context, ViT-B/32 vision with a 16-token VPT prefix (a training
# batch of 16, a validation batch of 256), UPT's vision tower with its
# 4-token prompt (T = 54, the same two batches) and text tower at the full
# context over 10 classes - ViT-L/14 vision with and without a VPT prefix,
# and the edge lengths (K1 also past 128 keys, where it takes two sweeps)
ATTN_CASES = [
    (4, 17, 32, 2, None),
    (4, 17, 32, 2, "causal"),
    (3, 24, 64, 2, "causal"),
    (256, 50, 768, 12, None),
    (10, 16, 512, 8, "causal"),
    (102, 24, 512, 8, "causal"),
    (102, 48, 512, 8, "causal"),
    (102, 77, 512, 8, "causal"),
    (16, 66, 768, 12, None),
    (256, 66, 768, 12, None),
    (16, 54, 768, 12, None),
    (256, 54, 768, 12, None),
    (10, 77, 512, 8, "causal"),
    (8, 257, 1024, 16, None),
    (8, 273, 1024, 16, None),
    (2, 129, 64, 2, "causal"),
    (1, 200, 128, 2, None),
    (16, 337, 1024, 16, None),
    (4, 577, 1024, 16, None),
] + EDGE_CASES + LONG_EDGE_CASES + STREAMED_EDGE_CASES


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: "x".join(map(str, c)))
def test_attention_kernel_matches_plain(case, dtype):
    _require_card()
    B, T, W, H, mask = case
    g = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn(B, T, 3 * W, generator=g, device="cuda").to(dtype)
    before = fused_attention.launches
    out = fused_attention(qkv, mask, H)
    torch.cuda.synchronize()
    assert fused_attention.launches == before + 1
    ref = attention_reference(qkv, mask, H)
    assert out.shape == (B, T, W) and out.dtype == dtype
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


# K1 streams K and V past these lengths (the wrapper counts those launches
# in `streamed_launches`); up to them, above 128 tokens, bf16 holds the head
# resident in shared memory (counted in `resident_launches`)
K1_RESIDENT_MAX_SEQ = {torch.float32: 128, torch.bfloat16: 320}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", [(16, 337, 1024, 16, None), (2, 1024, 128, 2, "causal"),
                                  (16, 273, 1024, 16, None), (2, 320, 128, 2, "causal"),
                                  (2, 129, 128, 2, None)],
                         ids=lambda c: "x".join(map(str, c)))
def test_attention_streamed_kernel_is_deterministic(case, dtype):
    """K1 above 128 tokens, streamed (fp32 from 129, bf16 past 320) or
    resident (bf16 up to 320): every output has one owner, summed in a fixed
    order, so two launches on the same inputs give the same bits; a launch
    counts as streamed exactly when the streamed kernel runs, and as
    resident exactly when the resident one does."""
    _require_card()
    B, T, W, H, mask = case
    g = torch.Generator(device="cuda").manual_seed(6)
    qkv = torch.randn(B, T, 3 * W, generator=g, device="cuda").to(dtype)
    before = fused_attention.streamed_launches, fused_attention.resident_launches
    first = fused_attention(qkv, mask, H)
    second = fused_attention(qkv, mask, H)
    torch.cuda.synchronize()
    streamed = T > K1_RESIDENT_MAX_SEQ[dtype]
    assert fused_attention.streamed_launches == before[0] + (2 if streamed else 0)
    assert fused_attention.resident_launches == before[1] + (0 if streamed else 2)
    assert torch.equal(first.view(torch.uint8), second.view(torch.uint8))


# (B, T, W, heads, mask): tiny-test widths, then the CoOp text tower (C = 10
# or 102 classes, truncated to 24 or at the full 77; UPT's text tower is the
# (10, 77) case) and the ViT-B/32 vision tower with and without a 16-token
# VPT prefix (the VPT training batch of 16), then UPT's training batch with
# its 4-token prompt; ViT-L/14's VPT (T = 273) and UPT (T = 261) training
# batches and its plain vision tower (T = 257), which K2 takes above 128
# tokens; then 288 and 319 at D = 64, around the bf16 kernel's 16-row pad;
# one (row, head), so that one block has the card to itself; T = 320 at
# ViT-L/14's width and a causal 305, whose last 32-row chunk of the fp32
# kernels' ring is short
BWD_CASES = [
    (4, 12, 32, 2, None),
    (4, 17, 32, 2, "causal"),
    (3, 24, 64, 2, "causal"),
    (10, 24, 512, 8, "causal"),
    (10, 77, 512, 8, "causal"),
    (102, 24, 512, 8, "causal"),
    (102, 48, 512, 8, "causal"),
    (102, 77, 512, 8, "causal"),
    (256, 50, 768, 12, None),
    (256, 66, 768, 12, None),
    (16, 66, 768, 12, None),
    (16, 54, 768, 12, None),
    (16, 273, 1024, 16, None),
    (16, 261, 1024, 16, None),
    (4, 257, 1024, 16, None),
    (1, 288, 128, 2, None),
    (1, 288, 128, 2, "causal"),
    (1, 319, 128, 2, None),
    (1, 319, 128, 2, "causal"),
    (1, 273, 64, 1, None),
    (1, 273, 64, 1, "causal"),
    (16, 320, 1024, 16, None),
    (2, 305, 128, 2, "causal"),
    (16, 337, 1024, 16, None),
    (4, 577, 1024, 16, None),
    (2, 1024, 128, 2, "causal"),
] + EDGE_CASES + LONG_EDGE_CASES + STREAMED_EDGE_CASES


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", BWD_CASES, ids=lambda c: "x".join(map(str, c)))
def test_attention_bwd_kernel_matches_plain(case, dtype):
    _require_card()
    B, T, W, H, mask = case
    g = torch.Generator(device="cuda").manual_seed(2)
    qkv = torch.randn(B, T, 3 * W, generator=g, device="cuda").to(dtype)
    grad = torch.randn(B, T, W, generator=g, device="cuda").to(dtype)
    before = attention_bwd.launches
    out = attention_bwd(qkv, grad, mask, H)
    torch.cuda.synchronize()
    assert attention_bwd.launches == before + 1
    ref = attention_bwd_reference(qkv, grad, mask, H)
    assert out.shape == (B, T, 3 * W) and out.dtype == dtype
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("case", [BWD_CASES[1], BWD_CASES[3], BWD_CASES[7], BWD_CASES[9],
                                  BWD_CASES[10], BWD_CASES[4], BWD_CASES[11], BWD_CASES[12],
                                  (2, 200, 128, 2, "causal")],
                         ids=lambda c: "x".join(map(str, c)))
def test_fused_attention_gradient_on_card_matches_autograd_of_plain(case):
    """fp32: K1 forward + K2 backward through `FusedAttention` against
    autograd of the plain forward, both on the card."""
    _require_card()
    B, T, W, H, mask = case
    g = torch.Generator(device="cuda").manual_seed(3)
    qkv = torch.randn(B, T, 3 * W, generator=g, device="cuda")
    grad = torch.randn(B, T, W, generator=g, device="cuda")
    f0, b0 = fused_attention.launches, attention_bwd.launches
    a = qkv.clone().requires_grad_(True)
    (got,) = torch.autograd.grad(fused_attention(a, mask, H), a, grad)
    torch.cuda.synchronize()
    assert (fused_attention.launches, attention_bwd.launches) == (f0 + 1, b0 + 1)
    b = qkv.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(attention_reference(b, mask, H), b, grad)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", [(256, 66, 768, 12, None), (102, 77, 512, 8, "causal"),
                                  (16, 273, 1024, 16, None), (2, 200, 128, 2, "causal"),
                                  (16, 320, 1024, 16, None), (1, 273, 64, 1, "causal"),
                                  (16, 337, 1024, 16, None), (2, 1024, 128, 2, "causal")],
                         ids=lambda c: "x".join(map(str, c)))
def test_attention_bwd_kernel_is_deterministic(case, dtype):
    """No atomics: two launches on the same inputs give the same bits."""
    _require_card()
    B, T, W, H, mask = case
    g = torch.Generator(device="cuda").manual_seed(4)
    qkv = torch.randn(B, T, 3 * W, generator=g, device="cuda").to(dtype)
    grad = torch.randn(B, T, W, generator=g, device="cuda").to(dtype)
    first = attention_bwd(qkv, grad, mask, H)
    second = attention_bwd(qkv, grad, mask, H)
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.uint8), second.view(torch.uint8))


def test_attention_bwd_reports_its_warps_and_workspace():
    """Above 128 tokens bf16 runs in one launch with no workspace up to 320
    tokens, its warps sized so that each takes the same number of 16-row
    tiles (T = 273: 18 tiles, 9 warps of 2); fp32, and bf16 above 320, in
    two launches of 4 warps, on 12 bytes (fp32: m, 1/l, r) or 8 bytes
    (bf16: lse, r * D^-0.5) per (row, head, query), queries rounded up to
    64, with shared memory that no longer grows with T."""
    _require_card()
    from menghini_neurips23_tpu_torch.ops import _cuda
    from menghini_neurips23_tpu_torch.ops.attention import _BWD_SIGNATURES

    lib = _cuda.library("attention_bwd", _BWD_SIGNATURES)
    assert lib.mnt_attention_bwd_workspace(16, 273, 16, 1) == 0
    assert lib.mnt_attention_bwd_workspace(16, 273, 16, 0) == 12 * 16 * 16 * 320
    assert lib.mnt_attention_bwd_workspace(16, 128, 16, 0) == 0
    assert lib.mnt_attention_bwd_warps(273, 64, 0) == 4
    for T in (129, 193, 257, 261, 273, 288, 320):
        tiles, warps = -(-T // 16), lib.mnt_attention_bwd_warps(T, 64, 1)
        rounds = -(-tiles // warps)
        assert 1 <= warps <= 16 and -(-tiles // rounds) == warps, (T, warps)
    assert lib.mnt_attention_bwd_warps(273, 64, 1) == 9
    assert lib.mnt_attention_bwd_warps(66, 64, 1) == 5
    assert lib.mnt_attention_bwd_smem(320, 64) <= 227 * 1024
    assert lib.mnt_attention_bwd_workspace(16, 320, 16, 1) == 0
    assert lib.mnt_attention_bwd_workspace(16, 321, 16, 1) == 8 * 16 * 16 * 384
    assert lib.mnt_attention_bwd_workspace(16, 321, 16, 0) == 12 * 16 * 16 * 384
    assert lib.mnt_attention_bwd_warps(321, 64, 1) == 4
    assert lib.mnt_attention_bwd_smem(321, 64) == lib.mnt_attention_bwd_smem(4096, 64)
    assert lib.mnt_attention_bwd_smem(4096, 64) <= 227 * 1024


# (B, E, C): tiny-test, the slice's ViT-B/32 head, a ragged batch, ViT-L/14;
# row counts that no row tile (16, 32, 64, 128) divides; one class and the
# largest class counts (C > 128 sweeps the classes through shared memory);
# widths that are not a multiple of the kernel's E-chunk or of 16 bytes
# (staged without cp.async); a pool that takes the 32-row tile
HEAD_CASES = [
    (12, 16, 7), (256, 512, 10), (256, 512, 102), (13, 512, 102), (256, 768, 102),
    (129, 512, 10), (513, 512, 102), (64, 512, 1), (64, 512, 1024), (33, 16, 1024),
    (40, 768, 2048), (129, 16, 130), (17, 20, 5), (9, 7, 3), (16384, 512, 102),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", HEAD_CASES, ids=lambda c: "x".join(map(str, c)))
def test_clip_head_kernel_matches_plain(case, dtype):
    _require_card()
    B, E, C = case
    g = torch.Generator(device="cuda").manual_seed(1)
    img = torch.randn(B, E, generator=g, device="cuda").to(dtype)
    txt = torch.randn(C, E, generator=g, device="cuda").to(dtype)
    before = fused_probs.launches
    out = fused_probs(img, txt, 100.0)
    torch.cuda.synchronize()
    assert fused_probs.launches == before + 1
    ref = fused_probs_reference(img, txt, 100.0)
    assert out.shape == (B, C) and out.dtype == torch.float32
    torch.testing.assert_close(out, ref, rtol=HEAD_TOL, atol=HEAD_TOL)
    torch.testing.assert_close(out.sum(-1), torch.ones(B, device="cuda"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_clip_head_kernel_takes_unaligned_rows(dtype):
    """Rows that start off a 16-byte boundary are staged without cp.async."""
    _require_card()
    g = torch.Generator(device="cuda").manual_seed(5)
    img = torch.randn(70 * 512 + 1, generator=g, device="cuda").to(dtype)[1:].view(70, 512)
    txt = torch.randn(10 * 512 + 1, generator=g, device="cuda").to(dtype)[1:].view(10, 512)
    out = fused_probs(img, txt, 100.0)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, fused_probs_reference(img, txt, 100.0), rtol=HEAD_TOL,
                               atol=HEAD_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", [(640, 512, 10), (16384, 512, 102), (40, 512, 300)],
                         ids=lambda c: "x".join(map(str, c)))
def test_clip_head_kernel_is_deterministic(case, dtype):
    """No atomics: two launches on the same inputs give the same bits."""
    _require_card()
    B, E, C = case
    g = torch.Generator(device="cuda").manual_seed(6)
    img = torch.randn(B, E, generator=g, device="cuda").to(dtype)
    txt = torch.randn(C, E, generator=g, device="cuda").to(dtype)
    first = fused_probs(img, txt, 100.0)
    second = fused_probs(img, txt, 100.0)
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int32), second.view(torch.int32))


def test_clip_head_raises_above_its_limits():
    """K3 takes E <= 1024 and C <= 2048 (HEAD_CASES reach both); one more raises."""
    _require_card()
    with pytest.raises(ValueError, match="C=2049 exceeds the kernel's limit of 2048"):
        fused_probs(torch.randn(4, 64, device="cuda"), torch.randn(2049, 64, device="cuda"), 1.0)
    with pytest.raises(ValueError, match="E=1025 exceeds the kernel's limit of 1024"):
        fused_probs(torch.randn(4, 1025, device="cuda"), torch.randn(3, 1025, device="cuda"), 1.0)


# K4, the phase-grouped forward: (B, T, W, heads).  The experiment's shape
# (VPT's ViT-B/32 validation batch), ViT-B/32 vision, UPT's 4-token prompt,
# VPT's training batch, a ragged (8, 17) at D = 64, D = 16 and 32 (one and
# several head groups), short and ragged lengths; then the longest T one
# block takes at D = 64 (G = 1), by type: 176 in bf16, 144 in fp32
TWOPHASE_CASES = [
    (256, 66, 768, 12), (256, 50, 768, 12), (256, 54, 768, 12), (16, 66, 768, 12),
    (8, 17, 256, 4), (4, 33, 64, 4), (3, 66, 128, 4), (2, 1, 128, 2), (2, 16, 128, 2),
    (2, 100, 64, 4), (3, 129, 192, 3),
]
TWOPHASE_MAX_T = {torch.float32: 144, torch.bfloat16: 176}


def _check_twophase(B, T, W, H, dtype, seed=7):
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(B, T, 3 * W, generator=g, device="cuda").to(dtype)
    before = twophase_attention.launches
    out = twophase_attention(qkv, H)
    torch.cuda.synchronize()
    assert twophase_attention.launches == before + 1
    assert out.shape == (B, T, W) and out.dtype == dtype
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(out.float(), twophase_attention_reference(qkv, H).float(),
                               rtol=tol, atol=tol)
    torch.testing.assert_close(out.float(), fused_attention(qkv, None, H).float(), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", TWOPHASE_CASES, ids=lambda c: "x".join(map(str, c)))
def test_twophase_kernel_matches_plain_and_k1(case, dtype):
    _require_card()
    _check_twophase(*case, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_twophase_kernel_takes_its_longest_sequence(dtype):
    _require_card()
    _check_twophase(4, TWOPHASE_MAX_T[dtype], 768, 12, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", [(256, 66, 768, 12), (8, 17, 256, 4), (3, 66, 128, 4)],
                         ids=lambda c: "x".join(map(str, c)))
def test_twophase_kernel_is_deterministic(case, dtype):
    """No atomics: two launches on the same inputs give the same bits."""
    _require_card()
    B, T, W, H = case
    g = torch.Generator(device="cuda").manual_seed(8)
    qkv = torch.randn(B, T, 3 * W, generator=g, device="cuda").to(dtype)
    first = twophase_attention(qkv, H)
    second = twophase_attention(qkv, H)
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.uint8), second.view(torch.uint8))


def test_twophase_groups_and_shared_memory_limit():
    """G is the largest divisor of the heads whose block fits: at the
    experiment's (66, D = 64, 12 heads) 3 in bf16 and 2 in fp32; one token
    past the longest T raises ValueError, in either type."""
    _require_card()
    from menghini_neurips23_tpu_torch.ops import _cuda
    from menghini_neurips23_tpu_torch.ops.twophase_attention import _SIGNATURES

    lib = _cuda.library("twophase_attention", _SIGNATURES)
    assert lib.mnt_twophase_attention_groups(66, 64, 12, 1) == 3
    assert lib.mnt_twophase_attention_groups(66, 64, 12, 0) == 2
    assert lib.mnt_twophase_attention_smem(66, 64, 12, 1) == 3 * (3 * 80 * 72 * 2 + 80 * 88 * 4)
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        longest = TWOPHASE_MAX_T[dtype]
        assert lib.mnt_twophase_attention_groups(longest, 64, 12, code) == 1
        assert lib.mnt_twophase_attention_groups(longest + 1, 64, 12, code) == 0
        assert lib.mnt_twophase_attention_smem(longest, 64, 12, code) <= 227 * 1024
        assert lib.mnt_twophase_attention_smem(longest + 1, 64, 12, code) > 227 * 1024
        with pytest.raises(ValueError, match="shared memory"):
            twophase_attention(torch.zeros(1, longest + 1, 3 * 768, device="cuda", dtype=dtype), 12)
    with pytest.raises(ValueError, match="head width"):
        twophase_attention(torch.zeros(1, 8, 3 * 96, device="cuda"), 1)
    with pytest.raises(ValueError, match="contiguous"):
        twophase_attention(torch.zeros(8, 2, 3 * 64, device="cuda").transpose(0, 1), 2)


def test_wrappers_raise_on_what_the_kernels_do_not_take():
    _require_card()
    qkv = torch.randn(2, 8, 96, device="cuda")
    # with grad, the call goes through FusedAttention: K1 forward, K2 backward
    a = qkv.clone().requires_grad_(True)
    (grad,) = torch.autograd.grad(fused_attention(a, None, 2).sum(), a)
    assert grad.shape == qkv.shape and torch.isfinite(grad).all()
    # ViT-L/14's T = 257 takes K2's tiled path, 321 the streamed pair
    for T in (257, 321):
        long = attention_bwd(torch.randn(1, T, 3 * 1024, device="cuda"),
                             torch.randn(1, T, 1024, device="cuda"), None, 16)
        assert long.shape == (1, T, 3 * 1024) and torch.isfinite(long).all()
    with pytest.raises(ValueError, match="contiguous"):
        attention_bwd(qkv, torch.randn(8, 2, 32, device="cuda").transpose(0, 1), None, 2)
    with pytest.raises(ValueError, match="dtype"):
        fused_attention(qkv.half(), None, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fused_attention(qkv.transpose(0, 1), None, 2)
    with pytest.raises(ValueError, match="head width"):
        fused_attention(torch.randn(2, 8, 3 * 96, device="cuda"), None, 1)
    img = torch.randn(4, 16, device="cuda")
    with pytest.raises(ValueError, match="dtype"):
        fused_probs(img, torch.randn(3, 16, device="cuda").bfloat16(), 1.0)
    with pytest.raises(ValueError, match="exceeds"):
        fused_probs(torch.randn(4, 2048, device="cuda"), torch.randn(3, 2048, device="cuda"), 1.0)


def test_deep_vpt_step_on_card_matches_cpu():
    """One visual_fpl step with deep prompts at ViT-B/32 width, fp32: the
    card (K1 + K2 in each of the 12 vision layers) against the CPU (their
    plain versions) from the same weights, prompts, text features and token
    batch.  Updated prompts within 1e-4, the loss within 1e-5 relative."""
    _require_card()
    import numpy as np

    from menghini_neurips23_tpu_torch.config import Config
    from menghini_neurips23_tpu_torch.models import VIT_B32
    from menghini_neurips23_tpu_torch.runtime import ClipRuntime
    from menghini_neurips23_tpu_torch.training import VisualStrategy

    a = VIT_B32
    cfg = Config(VIS_ENCODER="ViT-B/32", MODEL="visual_fpl", COMPUTE_DTYPE="float32",
                 BATCH_SIZE=16, OPTIM_SEED=1, VPT_DEEP=True)
    cpu_rt = ClipRuntime(cfg, device="cpu")
    gpu_rt = ClipRuntime(cfg, device="cuda")
    gpu_rt.model.load_state_dict(cpu_rt.model.state_dict())
    rng = np.random.default_rng(0)
    prompt = [rng.normal(0, 0.02, (16, a.vision_width)).astype(np.float32),
              rng.normal(0, 0.02, (a.vision_layers - 1, 16, a.vision_width)).astype(np.float32)]
    tokens = torch.from_numpy(
        rng.normal(0, 1, (16, 1 + a.num_patches, a.vision_width)).astype(np.float32))
    text = torch.nn.functional.normalize(torch.from_numpy(
        rng.normal(0, 1, (10, a.embed_dim)).astype(np.float32)), dim=1)
    labels = torch.from_numpy(rng.integers(0, 10, 16).astype(np.int32))
    group = torch.arange(16, dtype=torch.int32) % 2
    classes = [str(i) for i in range(10)]
    out = {}
    for rt in (cpu_rt, gpu_rt):
        strat = VisualStrategy(cfg, {c: i for i, c in enumerate(classes)}, classes, classes,
                               classes, runtime=rt)
        strat.load_parameters(prompt)
        strat._w0, strat._w1 = 8.0, 1.0
        dev = rt.device
        f0, b0 = fused_attention.launches, attention_bwd.launches
        loss, correct = strat._apply_step(text.to(dev), 0.1, tokens.to(dev), labels.to(dev),
                                          group.to(dev), torch.ones(16, device=dev))
        launches = (fused_attention.launches - f0, attention_bwd.launches - b0)
        out[dev.type] = (loss, correct, strat.epoch_parameters(), launches)
    (lc, cc, pc, nc), (lg, cg, pg, ng) = out["cpu"], out["cuda"]
    assert nc == (0, 0) and ng == (12, 12)
    assert abs(lg - lc) <= 1e-5 * abs(lc) and cg == cc
    for g, c, p in zip(pg, pc, prompt):
        np.testing.assert_allclose(g, c, rtol=0, atol=1e-4)
        assert not np.array_equal(c, p)


@pytest.mark.parametrize("prefix", [16, 80], ids=["T273", "T337"])
def test_visual_strategy_takes_vit_l14_on_the_card(prefix):
    """ViT-L/14 VPT builds on the card at T = 1 + 256 + 16 = 273 (K2's
    tiled path) and with an 80-token prompt, T = 337 (both kernels
    streamed); building launches nothing."""
    _require_card()
    from types import SimpleNamespace

    from menghini_neurips23_tpu_torch.config import Config
    from menghini_neurips23_tpu_torch.models import VIT_L14
    from menghini_neurips23_tpu_torch.training import VisualStrategy

    rt = SimpleNamespace(arch=VIT_L14, device=torch.device("cuda"))
    cfg = Config(VIS_ENCODER="ViT-L/14", MODEL="visual_fpl", PREFIX_SIZE=prefix)
    launches = (fused_attention.launches, attention_bwd.launches)
    strat = VisualStrategy(cfg, {"0": 0}, ["0"], ["0"], ["0"], runtime=rt)
    assert strat.prefix.shape == (prefix, 1024) and strat.prefix.device.type == "cuda"
    assert (fused_attention.launches, attention_bwd.launches) == launches


def test_upt_step_on_card_matches_cpu():
    """One multimodal_fpl step at ViT-B/32 width, fp32: the card (K1 + K2 in
    each of the 12 text and 12 vision layers; the mixer's attention is plain
    PyTorch) against the CPU (their plain versions) from the same weights,
    UPT prompt, class prompts and token batch.  Every updated parameter
    within 1e-4, the loss within 1e-5 relative."""
    _require_card()
    import numpy as np

    from menghini_neurips23_tpu_torch.config import Config
    from menghini_neurips23_tpu_torch.models import VIT_B32
    from menghini_neurips23_tpu_torch.runtime import ClipRuntime
    from menghini_neurips23_tpu_torch.training import MultimodalStrategy

    a = VIT_B32
    cfg = Config(VIS_ENCODER="ViT-B/32", MODEL="multimodal_fpl", COMPUTE_DTYPE="float32",
                 BATCH_SIZE=16, OPTIM_SEED=1)
    cpu_rt = ClipRuntime(cfg, device="cpu")
    gpu_rt = ClipRuntime(cfg, device="cuda")
    gpu_rt.model.load_state_dict(cpu_rt.model.state_dict())
    classes = [str(i) for i in range(10)]
    l2i = {c: i for i, c in enumerate(classes)}
    prompt = MultimodalStrategy(cfg, l2i, classes, classes, classes,
                                runtime=cpu_rt).epoch_parameters()
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(
        rng.normal(0, 1, (16, 1 + a.num_patches, a.vision_width)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 10, 16).astype(np.int32))
    group = torch.arange(16, dtype=torch.int32) % 2
    out = {}
    for rt in (cpu_rt, gpu_rt):
        strat = MultimodalStrategy(cfg, l2i, classes, classes, classes, runtime=rt)
        strat.load_parameters(prompt)
        strat._w0, strat._w1 = 8.0, 1.0
        dev = rt.device
        ctx = strat._class_context(classes)
        assert tuple(ctx.shape) == (10, 77)
        f0, b0 = fused_attention.launches, attention_bwd.launches
        loss, correct = strat._apply_step(ctx, 0.1, tokens.to(dev), labels.to(dev),
                                          group.to(dev), torch.ones(16, device=dev))
        launches = (fused_attention.launches - f0, attention_bwd.launches - b0)
        out[dev.type] = (loss, correct, strat.epoch_parameters(), launches)
    (lc, cc, pc, nc), (lg, cg, pg, ng) = out["cpu"], out["cuda"]
    assert nc == (0, 0) and ng == (24, 24)
    assert abs(lg - lc) <= 1e-5 * abs(lc) and cg == cc

    def leaves(tree):
        if tree is None:
            return []
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in leaves(tree[k])]
        if isinstance(tree, list):
            return [x for t in tree for x in leaves(t)]
        return [np.asarray(tree)]

    for g, c, p in zip(leaves(pg), leaves(pc), leaves(prompt)):
        np.testing.assert_allclose(g, c, rtol=0, atol=1e-4)
    assert not np.array_equal(leaves(pc)[-1], leaves(prompt)[-1])  # vpt moved


# ------------------------------------------------------- whole-run trainer
FUSED_CLASSES = [str(i) for i in range(5)]


def _fused_strategy(name, eager=False, epochs=3, **cfg_kw):
    """A tiny-test strategy on the card whose frozen features are synthetic
    (numpy, seeded), with a 40-row training set (3 batches of 16, the last
    padded) and 24 validation rows, ready for `_fused_train(*args)`."""
    import numpy as np

    from menghini_neurips23_tpu_torch.config import Config
    from menghini_neurips23_tpu_torch.runtime import ClipRuntime
    from menghini_neurips23_tpu_torch.training import (
        MultimodalStrategy,
        TextualStrategy,
        VisualStrategy,
    )
    from menghini_neurips23_tpu_torch.training.strategy import EpochData

    cls, kw = {
        "coop": (TextualStrategy, dict(MODEL="textual_prompt")),
        "vpt_deep": (VisualStrategy, dict(MODEL="visual_prompt", VPT_DEEP=True)),
        "upt": (MultimodalStrategy, dict(MODEL="multimodal_prompt")),
    }[name]
    cfg = Config(VIS_ENCODER="tiny-test", COMPUTE_DTYPE="float32", BATCH_SIZE=16, EPOCHS=epochs,
                 PREFIX_SIZE=4, TEXT_PREFIX_SIZE=2, VISION_PREFIX_SIZE=2, TRANSFORMER_DIM=16,
                 LR=0.5, MOMENTUM=0.9, OPTIM_SEED=1, WARMUP_EPOCHS=0, **kw, **cfg_kw)
    rt = ClipRuntime(cfg, device="cuda")
    l2i = {c: i for i, c in enumerate(FUSED_CLASSES)}
    strat = cls(cfg, l2i, FUSED_CLASSES, FUSED_CLASSES, FUSED_CLASSES, runtime=rt)
    strat._fused_eager = eager
    a = rt.arch
    rng = np.random.default_rng(3)
    shape = (a.embed_dim,) if name == "coop" else (1 + a.num_patches, a.vision_width)
    table = rng.normal(0, 1, (64,) + shape).astype(np.float32)
    paths = [f"row{i}" for i in range(64)]
    row = {p: i for i, p in enumerate(paths)}
    strat._features_for_paths = lambda ps, **k: table[[row[p] for p in ps]]
    labels = rng.integers(0, len(FUSED_CLASSES), 64)
    epoch = EpochData(table[:40], labels[:40], np.zeros(40, np.int32), paths[:40])
    val = (paths[40:], labels[40:].astype(np.int32), FUSED_CLASSES)
    return strat, (epoch, val, FUSED_CLASSES)


def test_fused_warmup_leaves_the_carry_unchanged():
    """Capturing warms up on the all-padding row: the prompt, momentum,
    accumulator and best-so-far come out bit for bit as they went in."""
    _require_card()
    import numpy as np

    strat, args = _fused_strategy("vpt_deep")
    strat._fused_keep = True
    strat._fused_train(*args)  # a trained carry: nonzero momentum and best
    (prog,) = strat._fused_cache.values()
    before = prog.carry_numpy()
    assert np.abs(before[1]["prefix"]).max() > 0
    prog.capture()
    after = prog.carry_numpy()
    assert prog.graphs is not None
    for b, a in zip(before, after):
        for k in (b if isinstance(b, dict) else [None]):
            x, y = (b[k], a[k]) if k is not None else (b, a)
            np.testing.assert_array_equal(x, y)
    strat._fused_free()


def _fused_leaves(tree):
    import numpy as np

    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _fused_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for t in tree for x in _fused_leaves(t)]
    return [np.asarray(tree)]


def _captured_vs_eager(name, **cfg_kw):
    """One `_fused_train` of `name` captured and one eager, on the card, from
    the same prompt and RNG state: stats and prompts within 1e-6, and the
    launch counts each adds.  Returns the captured run's record."""
    import numpy as np

    out = {}
    for eager in (False, True):
        strat, args = _fused_strategy(name, eager=eager, **cfg_kw)
        strat._ctx_host(FUSED_CLASSES)  # VPT's frozen text features: outside the count
        f0, b0 = fused_attention.launches, attention_bwd.launches
        acc, best = strat._fused_train(*args)
        torch.cuda.synchronize()
        info = strat._fused_info
        out[eager] = (acc, best, strat.epoch_parameters(), info,
                      (fused_attention.launches - f0, attention_bwd.launches - b0))
    (acc_g, best_g, final_g, info_g, n_g), (acc_e, best_e, final_e, info_e, n_e) = (
        out[False], out[True])
    assert info_g["graphs"] and not info_e["graphs"]
    assert acc_g == acc_e
    np.testing.assert_allclose(info_g["stats"], info_e["stats"], rtol=0, atol=1e-6)
    assert info_g["stats"].shape == (3, info_g["epochs"])
    for g, e in zip(_fused_leaves(best_g) + _fused_leaves(final_g),
                    _fused_leaves(best_e) + _fused_leaves(final_e)):
        np.testing.assert_allclose(g, e, rtol=0, atol=1e-6)
    # launches: the eager run counts each launch; the captured one counts
    # its warm-up (2 x one step + one epoch end) and captured x replays;
    # 3 real steps and 3 real epochs are run (a chunked run's padded epoch
    # is not)
    ps, pe = info_g["launches_per_step"], info_g["launches_per_epoch_end"]
    per_epoch = [3 * s + e for s, e in zip(ps, pe)]
    assert all(s > 0 for s in ps) and all(e > 0 for e in pe[:1]) and pe[1] == 0
    assert list(n_e) == [3 * p for p in per_epoch]
    assert list(n_g) == [3 * p + 2 * (s + e) for p, s, e in zip(per_epoch, ps, pe)]
    return info_g


@pytest.mark.parametrize("name", ["coop", "vpt_deep", "upt"])
def test_fused_captured_replay_equals_eager_run(name):
    """The captured graphs replayed against the same two functions run
    eagerly on the card, from the same prompt and RNG state: stats and
    prompts within 1e-6 (the same kernels on the same inputs: 0 expected);
    and the launch counts a replay adds equal what the eager run counts."""
    _require_card()
    _captured_vs_eager(name)


@pytest.mark.parametrize("name,remat,chunk", [
    ("vpt_deep", True, 0), ("upt", True, 0), ("coop", False, 2), ("vpt_deep", True, 2),
])
def test_fused_remat_and_chunks_captured_equal_eager(tmp_path, name, remat, chunk):
    """FUSED_REMAT (torch.utils.checkpoint inside the captured step: the
    vision tower's forward runs again in the backward) and FUSED_EPOCH_CHUNK
    = 2 over 3 epochs (two chunks, one padded epoch, chunk states written and
    cleared) under capture, against the same run eager on the card."""
    _require_card()
    info = _captured_vs_eager(name, FUSED_REMAT=remat, FUSED_EPOCH_CHUNK=chunk,
                              CHECKPOINT_ITER=True, ARTIFACT_DIR=str(tmp_path))
    if remat:  # K1 per step: the forward and its recomputation
        plain, args = _fused_strategy(name)
        plain._ctx_host(FUSED_CLASSES)
        plain._fused_train(*args)
        assert info["launches_per_step"][0] > plain._fused_info["launches_per_step"][0]
    assert not list(tmp_path.glob("checkpoints/*/chunk_*.pt"))


def test_fused_chunk_kill_and_resume_on_the_card(tmp_path, monkeypatch):
    """Deep VPT under capture, FUSED_EPOCH_CHUNK=2 over 4 epochs, killed by
    MNT_FAIL_AFTER_CHUNK=1 after its first chunk's state is saved from the
    card; a fresh strategy resumes it at epoch 2 and ends as an
    uninterrupted captured run (stats and prompts within 1e-6)."""
    _require_card()
    import numpy as np

    kw = dict(epochs=4, FUSED_EPOCH_CHUNK=2, CHECKPOINT_ITER=True, RESUME=True)
    whole, args = _fused_strategy("vpt_deep", ARTIFACT_DIR=str(tmp_path / "a"), **kw)
    acc_a, best_a = whole._fused_train(*args)
    stats_a, final_a = whole._fused_info["stats"], whole.epoch_parameters()
    cut, args = _fused_strategy("vpt_deep", ARTIFACT_DIR=str(tmp_path / "b"), **kw)
    monkeypatch.setenv("MNT_FAIL_AFTER_CHUNK", "1")
    with pytest.raises(RuntimeError, match="MNT_FAIL_AFTER_CHUNK=1"):
        cut._fused_train(*args)
    monkeypatch.delenv("MNT_FAIL_AFTER_CHUNK")
    assert len(list(tmp_path.glob("b/checkpoints/*/chunk_*.pt"))) == 1
    resumed, args = _fused_strategy("vpt_deep", ARTIFACT_DIR=str(tmp_path / "b"), **kw)
    resumed._ctx_host(FUSED_CLASSES)  # VPT's frozen text features: outside the count
    f0 = fused_attention.launches
    acc_c, best_c = resumed._fused_train(*args)
    info = resumed._fused_info
    assert info["graphs"] and acc_c == acc_a
    np.testing.assert_allclose(info["stats"], stats_a, rtol=0, atol=1e-6)
    for c, a in zip(_fused_leaves(best_c) + _fused_leaves(resumed.epoch_parameters()),
                    _fused_leaves(best_a) + _fused_leaves(final_a)):
        np.testing.assert_allclose(c, a, rtol=0, atol=1e-6)
    # the resumed run replays epochs 2 and 3 only (plus its warm-up)
    ps, pe = info["launches_per_step"], info["launches_per_epoch_end"]
    assert fused_attention.launches - f0 == 2 * (3 * ps[0] + pe[0]) + 2 * (ps[0] + pe[0])
    assert not list(tmp_path.glob("b/checkpoints/*/chunk_*.pt"))
