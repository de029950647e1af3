"""K4, the phase-grouped attention forward, on the CPU: the port's plain
version (`twophase_attention_reference`, what `twophase_attention` computes
on a CPU tensor) against the attention experiment's Pallas kernel
(`benchmarks/exp_attn_kernels.py` `twophase_attention`, interpreted off-TPU
as the JAX package's own tests run its kernels) and against K1's plain
version; the wrapper's CPU routing; and the refusals of the experiment's
port, `scripts/exp_attn_kernels.py`, which need no card.

The same numpy inputs, made from a seed, go to both sides.  Tolerances are
the attention tolerances of tests/test_torch_port_ops.py: 1e-5 in fp32 (the
two sides sum in another order) and 2e-2 in bf16 (both round P and the
output to bf16 at the same points, so a value may land on a neighbouring
bf16 step, 2^-8 of the value).
"""

import importlib.util
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from menghini_neurips23_tpu_torch.ops.attention import attention_reference, fused_attention
from menghini_neurips23_tpu_torch.ops.twophase_attention import (
    twophase_attention,
    twophase_attention_reference,
)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
           "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _jax_experiment(monkeypatch, bb):
    """benchmarks/exp_attn_kernels.py as a module: it reads its variant, mode
    and REPS from sys.argv when imported, and its block rows from
    MNT_ATTN_BB when called."""
    monkeypatch.setattr(sys, "argv", ["exp_attn_kernels.py", "twophase", "fwd", "1"])
    monkeypatch.setenv("MNT_ATTN_BB", str(bb))
    spec = importlib.util.spec_from_file_location(
        "exp_attn_kernels_jax", os.path.join(ROOT, "benchmarks", "exp_attn_kernels.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _qkv(seed, B, T, W):
    return np.random.default_rng(seed).normal(0, 1, (B, T, 3 * W)).astype(np.float32)


# T = 17: ragged against every 16-row tile; T = 66: VPT's ViT-B/32 sequence,
# the experiment's; D = 16 (the tiny-test arch) and 32, two heads
@pytest.mark.parametrize("dtype", sorted(_DTYPES))
@pytest.mark.parametrize("T", [17, 66])
@pytest.mark.parametrize("D", [16, 32])
def test_twophase_plain_matches_jax_kernel(monkeypatch, D, T, dtype):
    jdt, tdt, tol = _DTYPES[dtype]
    B, H = 4, 2
    exp = _jax_experiment(monkeypatch, bb=2)
    qkv = _qkv(T + D, B, T, H * D)
    want = np.asarray(exp.twophase_attention(jnp.asarray(qkv).astype(jdt), H).astype(jnp.float32))
    got = twophase_attention_reference(torch.from_numpy(qkv).to(tdt), H)
    assert got.dtype == tdt and got.shape == (B, T, H * D)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
@pytest.mark.parametrize("B, T, W, H", [(4, 17, 32, 2), (3, 66, 192, 3), (2, 50, 256, 4)])
def test_twophase_plain_matches_attention_reference(B, T, W, H, dtype):
    """The same function as K1's unmasked forward, in another order."""
    _, tdt, tol = _DTYPES[dtype]
    qkv = torch.from_numpy(_qkv(B * T, B, T, W)).to(tdt)
    got = twophase_attention_reference(qkv, H)
    want = attention_reference(qkv, None, H)
    assert got.dtype == tdt and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    twophase_attention.launches = 0
    fused_attention.launches = 0
    qkv = torch.randn(2, 9, 3 * 64, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(twophase_attention(qkv, 4), twophase_attention_reference(qkv, 4),
                               rtol=0, atol=0)
    assert twophase_attention.launches == 0 and fused_attention.launches == 0


def test_wrapper_refuses_other_devices_and_gradients():
    with pytest.raises(ValueError, match="unsupported device"):
        twophase_attention(torch.empty(2, 5, 96, device="meta"), 2)
    with pytest.raises(ValueError, match="no backward"):
        twophase_attention(torch.zeros(1, 4, 96, requires_grad=True), 2)
    with torch.no_grad():
        out = twophase_attention(torch.zeros(1, 4, 96, requires_grad=True), 2)
    assert out.shape == (1, 4, 32)


def _experiment_module():
    spec = importlib.util.spec_from_file_location(
        "exp_attn_kernels_torch", os.path.join(ROOT, "scripts", "exp_attn_kernels.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
def test_experiment_variants_compute_one_function(dtype):
    """Every variant of the experiment's port, on CPU tensors (the kernels'
    plain versions), against K1's plain version; xla rounds the logits to
    the input type before its fp32 softmax, as the JAX script's does, so
    bf16 takes two bf16 steps."""
    _, tdt, tol = _DTYPES[dtype]
    exp = _experiment_module()
    qkv = torch.from_numpy(_qkv(5, 4, 17, 64)).to(tdt)
    want = attention_reference(qkv, None, 4).float()
    for variant in exp.VARIANTS:
        got = exp.make_attention(torch, variant, 4)(qkv)
        assert got.dtype == tdt and got.shape == (4, 17, 64), variant
        torch.testing.assert_close(got.float(), want, rtol=2 * tol, atol=2 * tol, msg=variant)
    assert exp.parse([]) == ("ship", "grad", 100)  # the JAX script's defaults


def _script(*args):
    return subprocess.run([sys.executable, os.path.join(ROOT, "scripts", "exp_attn_kernels.py"),
                           *args], capture_output=True, text=True, timeout=120)


@pytest.mark.parametrize("args, says", [
    (("twophase", "grad"), "no backward"),
    (("twophase",), "no backward"),  # the mode defaults to grad, as in the JAX script
    (("bb16",), "MNT_ATTN_BB"),
    (("bb4", "fwd"), "MNT_ATTN_BB"),
    (("flash", "fwd"), "unknown variant"),
    (("ship", "both"), "unknown mode"),
    (("ship", "fwd", "0"), "at least 1"),
], ids=lambda a: "-".join(a) if isinstance(a, tuple) else None)
def test_experiment_script_refuses_what_it_does_not_take(args, says):
    """Arguments are checked before the card is looked for, so these exit 2
    here too."""
    done = _script(*args)
    assert done.returncode == 2 and says in done.stderr and "RESULT" not in done.stdout


def test_experiment_script_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the script would run")
    done = _script("twophase", "fwd", "1")
    assert done.returncode == 1 and "needs a CUDA card" in done.stderr
    assert "RESULT" not in done.stdout
