"""K4, the phase-grouped attention forward, on the CPU: the port's plain
version (`twophase_attention_reference`, what `twophase_attention` computes
on a CPU tensor) against the attention experiment's Pallas kernel
(`benchmarks/exp_attn_kernels.py` `twophase_attention`, interpreted off-TPU
as the JAX package's own tests run its kernels) and against K1's plain
version; the kernel's schedule emulated in torch (the base-2 softmax with
D^-0.5 * log2(e) folded into the logits, and in fp32 both products as
3xTF32 on the tensor cores) against the Pallas kernel up to the longest T
one block takes; the wrapper's CPU routing and its refusals of a group G;
and the refusals of the experiment's port, `scripts/exp_attn_kernels.py`,
and of its sweep, `scripts/streamed_attention_compare.py --twophase`, which
need no card.

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

from menghini_neurips23_tpu_torch.ops.attention import (
    _MAX_SMEM_BYTES,
    attention_reference,
    fused_attention,
)
from menghini_neurips23_tpu_torch.ops.twophase_attention import (
    twophase_attention,
    twophase_attention_reference,
    twophase_smem_bytes,
)
from tests.torch_port_fixtures import mm_1xtf32, mm_3xtf32

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


def _longest_t(dtype, D=64):
    """The longest T one block of one head takes, by the kernel's layout."""
    return max(t for t in range(1, 513) if twophase_smem_bytes(t, D, 1, dtype) <= _MAX_SMEM_BYTES)


LOG2E = 1.4426950408889634


def _k4_schedule(qkv, heads, mm):
    """The kernel's schedule: every head's logits, scaled by D^-0.5 * log2(e)
    (both rounded to fp32 and multiplied in fp32, as the kernel forms its
    scale), into one fp32 scratch; then every row's P = 2^(s - max) * (1 /
    sum) in fp32, rounded to the input type; then every head's P.V.  `mm`
    forms both products (fp32 on the card: 3xTF32)."""
    dt = qkv.dtype
    B, T, three_w = qkv.shape
    W = three_w // 3
    D = W // heads
    q, k, v = (t.reshape(B, T, heads, D).transpose(1, 2).float() for t in qkv.split(W, dim=-1))
    scale2 = torch.tensor(D**-0.5, dtype=torch.float32) * torch.tensor(LOG2E, dtype=torch.float32)
    logits = torch.stack([mm(q[:, h], k[:, h].transpose(-1, -2)) * scale2 for h in range(heads)])
    p = torch.exp2(logits - logits.amax(-1, keepdim=True))
    p = p * (1 / p.sum(-1, keepdim=True))
    out = torch.stack([mm(p[h].to(dt).float(), v[:, h]) for h in range(heads)], dim=2)
    return out.reshape(B, T, W).to(dt)


def _mm_plain(a, b):
    return torch.matmul(a, b)


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


def test_layout_takes_longer_sequences_than_before():
    """At D = 64 one block of one head takes T <= 192 in bf16 and 176 in
    fp32 (the first design took 176 and 144); at the experiment's T = 66 a
    head takes 51,200 bytes in bf16 (four blocks an SM) and 71,680 in fp32
    (three)."""
    assert _longest_t(torch.bfloat16) == 192 and _longest_t(torch.float32) == 176
    assert twophase_smem_bytes(66, 64, 1, torch.bfloat16) == 80 * 88 * 4 + 2 * 80 * 72 * 2
    assert twophase_smem_bytes(66, 64, 1, torch.float32) == 80 * 88 * 4 + 2 * 80 * 68 * 4
    assert 4 * (twophase_smem_bytes(66, 64, 1, torch.bfloat16) + 1024) <= 228 * 1024
    assert 3 * (twophase_smem_bytes(66, 64, 1, torch.float32) + 1024) <= 228 * 1024


# T = 17: ragged against every 16-row tile; 66: the experiment's; then the
# longest T one block takes at D = 64, by type (192 bf16, 176 fp32)
@pytest.mark.parametrize("dtype", sorted(_DTYPES))
@pytest.mark.parametrize("T", [17, 66, "longest"])
def test_twophase_schedule_matches_jax_kernel(monkeypatch, T, dtype):
    jdt, tdt, tol = _DTYPES[dtype]
    B, H, D = 2, 2, 64
    T = _longest_t(tdt) if T == "longest" else T
    exp = _jax_experiment(monkeypatch, bb=2)
    qkv = _qkv(500 + T, B, T, H * D)
    want = np.asarray(exp.twophase_attention(jnp.asarray(qkv).astype(jdt), H).astype(jnp.float32))
    qkv_t = torch.from_numpy(qkv).to(tdt)
    got = _k4_schedule(qkv_t, H, mm_3xtf32 if tdt == torch.float32 else _mm_plain)
    assert got.dtype == tdt and got.shape == (B, T, H * D)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)
    np.testing.assert_allclose(got.float().numpy(),
                               twophase_attention_reference(qkv_t, H).float().numpy(), rtol=tol,
                               atol=tol)


def test_twophase_fp32_needs_three_tf32_products(monkeypatch):
    """At the longest fp32 T, the schedule on one TF32 product a product errs
    by more than the kernel's 1e-5 against the Pallas kernel, and on 3xTF32
    by less than it: the kernel takes three."""
    B, H, D = 2, 2, 64
    T = _longest_t(torch.float32)
    exp = _jax_experiment(monkeypatch, bb=2)
    qkv = _qkv(500 + T, B, T, H * D)
    want = np.asarray(exp.twophase_attention(jnp.asarray(qkv), H))
    err = {name: float(np.abs(_k4_schedule(torch.from_numpy(qkv), H, mm).numpy() - want).max())
           for name, mm in (("one", mm_1xtf32), ("three", mm_3xtf32))}
    assert err["one"] > 1e-5, err
    assert err["three"] < 1e-5, err


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


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
def test_cpu_groups_that_fit_take_the_plain_version(dtype):
    """On the CPU a group G is checked, then ignored: every G whose block
    fits gives the plain version's bits, and so does a T past the kernel's
    longest when no G is named."""
    tdt = _DTYPES[dtype][1]
    qkv = torch.from_numpy(_qkv(3, 2, 66, 768)).to(tdt)
    want = twophase_attention_reference(qkv, 12)
    fits = [g for g in (1, 2, 3, 4, 6, 12)
            if twophase_smem_bytes(66, 64, g, tdt) <= _MAX_SMEM_BYTES]
    assert fits == ([1, 2, 3, 4] if tdt == torch.bfloat16 else [1, 2, 3])
    for g in [None] + fits:
        assert torch.equal(twophase_attention(qkv, 12, group=g), want), g
    long = torch.from_numpy(_qkv(4, 1, _longest_t(tdt) + 1, 128)).to(tdt)
    assert torch.equal(twophase_attention(long, 2), twophase_attention_reference(long, 2))


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
@pytest.mark.parametrize("T, group, says", [
    (66, 5, "does not divide"), (66, 0, "does not divide"), (66, -3, "does not divide"),
    (66, 6, "shared memory"), (66, 12, "shared memory"), ("longest+1", 1, "shared memory"),
], ids=lambda a: str(a))
def test_wrapper_refuses_groups_on_the_cpu(T, group, says, dtype):
    """A G that does not divide the heads, or whose block does not fit 227 KB
    (at T = 66, D = 64: G = 6 in either type; one head one token past the
    longest T), raises before the call is routed, on the CPU too."""
    tdt = _DTYPES[dtype][1]
    T = _longest_t(tdt) + 1 if T == "longest+1" else T
    with pytest.raises(ValueError, match=says):
        twophase_attention(torch.zeros(1, T, 3 * 768, dtype=tdt), 12, group=group)


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


def test_twophase_sweep_needs_a_card():
    """scripts/streamed_attention_compare.py --twophase (K4's G sweep) runs
    only on a card: without one it exits 1 and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the sweep would run")
    done = subprocess.run([sys.executable, os.path.join(ROOT, "scripts",
                                                         "streamed_attention_compare.py"),
                           "--twophase"], capture_output=True, text=True, timeout=120)
    assert done.returncode == 1 and "needs a CUDA card" in done.stderr
    assert done.stdout == ""


def test_experiment_script_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the script would run")
    done = _script("twophase", "fwd", "1")
    assert done.returncode == 1 and "needs a CUDA card" in done.stderr
    assert "RESULT" not in done.stdout
