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


# (B, T, W, heads, mask): tiny-test widths (D=16), D=32, then the main path's
# shapes - ViT-B/32 vision, the text tower truncated and at full context -
# and ViT-L/14 vision
ATTN_CASES = [
    (4, 17, 32, 2, None),
    (4, 17, 32, 2, "causal"),
    (3, 24, 64, 2, "causal"),
    (256, 50, 768, 12, None),
    (10, 16, 512, 8, "causal"),
    (102, 24, 512, 8, "causal"),
    (102, 77, 512, 8, "causal"),
    (8, 257, 1024, 16, None),
]


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
# tower with and without a 16-token VPT prefix
BWD_CASES = [
    (4, 12, 32, 2, None),
    (4, 17, 32, 2, "causal"),
    (3, 24, 64, 2, "causal"),
    (10, 24, 512, 8, "causal"),
    (10, 77, 512, 8, "causal"),
    (102, 24, 512, 8, "causal"),
    (102, 77, 512, 8, "causal"),
    (256, 50, 768, 12, None),
    (256, 66, 768, 12, None),
]


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


@pytest.mark.parametrize("case", [BWD_CASES[1], BWD_CASES[3], BWD_CASES[6], BWD_CASES[8]],
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


# (B, E, C): tiny-test, the slice's ViT-B/32 head, a ragged batch, ViT-L/14
HEAD_CASES = [(12, 16, 7), (256, 512, 10), (256, 512, 102), (13, 512, 102), (256, 768, 102)]


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
