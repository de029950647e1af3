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
"""

import pytest
import torch

from menghini_neurips23_tpu_torch.ops.attention import attention_reference, fused_attention
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
    with pytest.raises(NotImplementedError, match="forward-only"):
        fused_attention(qkv.clone().requires_grad_(True), None, 2)
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
