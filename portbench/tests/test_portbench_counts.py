"""The operation and byte counters against hand counts, and the trace's arithmetic."""

import math

import pytest

from portbench.harness import flops as F, readers
from portbench.harness.trace import HEAD_FILL, Trace, breakdown, read_events, union_seconds


def _matmul(m, n, k):
    return 2 * m * n * k


@pytest.mark.parametrize("width,heads,B,T,causal", [
    (768, 12, 1, 50, False),    # one ViT-B/32 image
    (512, 8, 102, 48, True),    # ViT-B/32's text tower over 102 CoOp prompts
    (1024, 16, 16, 273, False),  # a ViT-L/14 VPT batch
    (768, 12, 45, 24, True),    # ViT-L/14's text tower over 45 templates
])
def test_tower_flops_by_hand(width, heads, B, T, causal):
    D, N = width // heads, B * T
    linear = (_matmul(N, 3 * width, width) + _matmul(N, width, width)
              + _matmul(N, 4 * width, width) + _matmul(N, width, 4 * width))
    pairs = sum(t + 1 for t in range(T)) if causal else T * T
    fwd = linear + B * heads * (2 * 2 * D * pairs)
    bwd = linear + B * heads * (4 * 2 * D * pairs)
    assert F.tower_flops(B, T, width, heads, 1, causal) == pytest.approx(fwd, rel=1e-12)
    assert F.tower_flops(B, T, width, heads, 3, causal, backward=True) == \
        pytest.approx(3 * bwd, rel=1e-12)


def test_bytes_and_bounds_by_hand():
    # K1 fp32 at (16, 273, 16 heads x 64): qkv read, output written
    assert F.attn_fwd_bytes(16, 273, 16, 64, "float32") == 16 * 273 * (3 + 1) * 1024 * 4
    assert F.attn_bwd_bytes(16, 273, 16, 64, "bfloat16") == 16 * 273 * (3 + 1 + 3) * 1024 * 2
    # K3 at a 2048-row pool, 45 classes, E 768, fp32
    assert F.head_bytes(2048, 45, 768, "float32") == 4 * (2048 * 768 + 45 * 768 + 2048 * 45)
    assert F.head_flops(2048, 45, 768) == 2 * 2048 * 45 * 768
    assert F.bound_s(495e12, 0, "float32") == pytest.approx(1.0)
    assert F.bound_s(0, 3.35e12, "bfloat16") == pytest.approx(1.0)


def _events(spin=5):
    ev = [{"ph": "X", "cat": "user_annotation", "name": "portbench.window", "ts": 1000, "dur": 100}]
    ev += [{"ph": "X", "cat": "kernel", "name": "void at::native::spin_kernel", "ts": 990, "dur": 1}
           for _ in range(spin)]
    ev += [
        {"ph": "X", "cat": "kernel", "name": "attention_fwd_tf32<64>", "ts": 1000, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "sm90_xmma_gemm_f32f32", "ts": 1010, "dur": 30},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 1070, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "late", "ts": 1095, "dur": 20},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 1039, "dur": 40},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 1041, "dur": 20},
    ]
    return ev


def test_trace_union_and_gaps():
    tr = read_events(_events())
    assert tr.window_s == pytest.approx(100e-6)
    # [1000,1040] + [1070,1080] + [1095,1100]: 55 us
    assert tr.busy_s == pytest.approx(55e-6)
    assert tr.head_lost == HEAD_FILL - 5
    assert tr.gaps[0] == ("aten::copy_", pytest.approx(30e-6))
    assert tr.gaps[1][0] == "host idle" and tr.gaps[1][1] == pytest.approx(15e-6)
    assert union_seconds([(0, 2), (1, 3), (5, 6)])[0] == 4
    b = breakdown(tr)
    assert b["device_ops"][0][0] == "sm90_xmma_gemm_f32f32" and len(b["idle_gaps"]) == 2


def test_readers_on_a_trace():
    tr = read_events(_events())
    tr.facts = {"dtype": "float32", "flops": 495e12 * 50e-6, "steps": 2,
                "k1": [(1, 64, 1, 64, False, 1)], "k2": [], "counted": {"k1": 1, "k2": 0}}
    assert readers.mfu(tr) == pytest.approx(50.0)
    assert readers.idle_share(tr) == pytest.approx(45.0)
    assert readers.is_gemm("sm90_xmma_gemm_f32f32") and not readers.is_gemm("attention_bwd_q")
    bound = F.bound_s(F.attn_fwd_flops(1, 64, 1, 64, False), F.attn_fwd_bytes(1, 64, 1, 64,
                                                                              "float32"),
                      "float32")
    assert readers.attention_roofline(tr) == pytest.approx(100 * bound / 20e-6)
    tr.facts["counted"]["k1"] = 2  # the counters disagree with the shapes: nothing to read
    assert readers.attention_roofline(tr) is None
    assert not math.isnan(readers.mfu(tr))


def test_a_trace_without_kernels_reads_nothing():
    tr = Trace(kernels=[], window_s=1.0, busy_s=0.0, gaps=[], head_lost=0,
               facts={"dtype": "float32", "flops": 0, "k1": [], "k2": [], "counted": {}})
    assert readers.idle_share(tr) is None and readers.mfu(tr) is None
    assert readers.attention_roofline(tr) is None


@pytest.mark.parametrize("cell,batch,rows,k1_per_epoch", [
    ("vpt_l14_ul_fp32", 16, 16, 36 * 24 + 24), ("vpt_l14_ul_fp32", 64, 64, 9 * 24 + 24),
    ("coop_b32_ssl_fp32", 16, 102, 95 * 12 + 12),
])
def test_launch_shapes(cell, batch, rows, k1_per_epoch):
    """The shapes the K1/K2 launches take, without building the program."""
    import os
    import types

    from portbench.harness.manifest import ROOT, Bench, load_module

    bench = Bench(os.path.join(ROOT, "BENCHMARK.json"))
    c = dict(bench.workload(cell), batch_size=batch)
    ctx = types.SimpleNamespace(cell=c, config=bench.config(c["config"]), seed=9, device="cpu",
                                reference_only=True)
    f = load_module("drivers", "train").Driver(ctx).facts(1, {})
    assert f["k1"][0][0] == rows and f["k2"][0][0] == rows
    assert sum(s[5] for s in f["k1"]) == k1_per_epoch * c["epochs_per_call"]
    assert f["rows"] == c["epochs_per_call"] * (1509 if "coop" in cell else 576)
