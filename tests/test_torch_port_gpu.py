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
covers both.  Its bf16 output is compared with the plain version's bf16
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

pytestmark = pytest.mark.gpu

ATTN_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
HEAD_TOL = 2e-5


def _require_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# Ragged lengths around the kernels' 16-row tiles and 128-key chunks, up to
# K2's limit of 128, at D = 16 (the tiny-test arch), 32 and 64 (B = 1),
# unmasked and causal: (B, T, W, heads, mask)
EDGE_T = (1, 15, 16, 17, 48, 63, 64, 65, 66, 77, 128)
EDGE_CASES = [
    (b, t, w, w // d, mask)
    for t in EDGE_T
    for b, w, d in ((3, 32, 16), (2, 64, 32), (1, 128, 64))
    for mask in (None, "causal")
]

# (B, T, W, heads, mask): tiny-test widths (D=16), D=32, then the main path's
# shapes - ViT-B/32 vision, the text tower truncated, at Flowers102's 48 and
# at full context, ViT-B/32 vision with a 16-token VPT prefix (a training
# batch of 16, a validation batch of 256) - ViT-L/14 vision with and without
# a VPT prefix, and the edge lengths (K1 also past 128 keys, where it takes
# two sweeps)
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
    (8, 257, 1024, 16, None),
    (8, 273, 1024, 16, None),
    (2, 129, 64, 2, "causal"),
    (1, 200, 128, 2, None),
] + EDGE_CASES


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


# (B, T, W, heads, mask): tiny-test widths, then the CoOp text tower (C = 10
# or 102 classes, truncated to 24 or at the full 77) and the ViT-B/32 vision
# tower with and without a 16-token VPT prefix (the VPT training batch of 16
# last)
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
] + EDGE_CASES


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
                                  BWD_CASES[10]],
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
@pytest.mark.parametrize("case", [(256, 66, 768, 12, None), (102, 77, 512, 8, "causal")],
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_attention_bwd_raises_above_its_limit(dtype):
    """K2 takes T <= 128 (EDGE_T's last length passes above); 129 raises."""
    _require_card()
    qkv = torch.randn(1, 129, 3 * 128, device="cuda").to(dtype)
    g = torch.randn(1, 129, 128, device="cuda").to(dtype)
    with pytest.raises(ValueError, match="T=129 exceeds the kernel's limit of 128"):
        attention_bwd(qkv, g, "causal", 2)


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


def test_wrappers_raise_on_what_the_kernels_do_not_take():
    _require_card()
    qkv = torch.randn(2, 8, 96, device="cuda")
    # with grad, the call goes through FusedAttention: K1 forward, K2 backward
    a = qkv.clone().requires_grad_(True)
    (grad,) = torch.autograd.grad(fused_attention(a, None, 2).sum(), a)
    assert grad.shape == qkv.shape and torch.isfinite(grad).all()
    with pytest.raises(ValueError, match="shared memory"):  # ViT-L/14's T = 257 does not fit K2
        attention_bwd(torch.randn(1, 257, 3 * 1024, device="cuda"),
                      torch.randn(1, 257, 1024, device="cuda"), None, 16)
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


def test_visual_strategy_refuses_vit_l14_on_the_card_at_construction():
    """ViT-L/14 VPT (T = 1 + 256 + 16 = 273) is above the backward kernel's
    128: the strategy raises when it is built on the card, before any launch,
    against the same limit the kernel library reports."""
    _require_card()
    from types import SimpleNamespace

    from menghini_neurips23_tpu_torch.config import Config
    from menghini_neurips23_tpu_torch.models import VIT_L14
    from menghini_neurips23_tpu_torch.ops import _cuda
    from menghini_neurips23_tpu_torch.ops.attention import _BWD_SIGNATURES, BWD_MAX_SEQ
    from menghini_neurips23_tpu_torch.training import VisualStrategy

    lib = _cuda.library("attention_bwd", _BWD_SIGNATURES)
    assert lib.mnt_attention_bwd_max_seq() == BWD_MAX_SEQ
    cfg = Config(VIS_ENCODER="ViT-L/14", MODEL="visual_fpl", PREFIX_SIZE=16)
    rt = SimpleNamespace(arch=VIT_L14, device=torch.device("cuda"))
    launches = (fused_attention.launches, attention_bwd.launches)
    with pytest.raises(NotImplementedError, match="= 273 tokens.*ViT-L/14 slice"):
        VisualStrategy(cfg, {"0": 0}, ["0"], ["0"], ["0"], runtime=rt)
    assert (fused_attention.launches, attention_bwd.launches) == launches
