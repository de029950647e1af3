#!/usr/bin/env python3
"""Attention-kernel variants on one NVIDIA GPU, op-level timing (one variant
per process run): the port of benchmarks/exp_attn_kernels.py.

    python3 scripts/exp_attn_kernels.py VARIANT [fwd|grad] [REPS]    # from the repository root

Times REPS sequential applications of multi-head attention on a VPT-shaped
bf16 qkv tensor ((B, T, W, H) from ATTN_B/T/W/H, default 256, 66, 768, 12),
captured in one CUDA graph and replayed three times (CUDA-event time of the
fastest replay over REPS).  Each application carries the qkv tensor through
a cheap data dependence, x + 0.001 * ((o @ a) @ b) with a rank-8 (a, b)
drawn after qkv from np.random.default_rng(0) as in the JAX script, so that
no application can be skipped or reordered; grad takes
x - 0.001 * d mean(o^2) / dx instead.  The times include that dependence.

Variants:
  ship      the port's fused_attention (K1; grad: K1 + K2 through FusedAttention)
  twophase  the port's twophase_attention (K4): all heads' logits, then all
            softmaxes, then all P.V; forward only
  xla       the JAX model's head-split semantics in PyTorch operators (bf16
            products, fp32 scores in device memory), for reference
  sdpa      torch's scaled_dot_product_attention on the head-split tensors,
            a yardstick the port never calls

The kernels' launch counters (`fused_attention.launches`, ...) count in
Python, which a graph replay never passes through: the counts the capture
added are undone, and captured x replays are added after each replay, so
after a run they hold the launches that ran (warm-up and replays).

Prints the card's name and power limit, then one line
`RESULT <variant>/<mode>: <us> us/rep  <TFLOPS> TFLOPS-attn (...)`.
Exits 2 on arguments it does not take (twophase grad, the bb variants) and
1 without a card: nothing runs on the CPU.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = ("ship", "twophase", "xla", "sdpa")


def parse(argv):
    """(variant, mode, reps), or an error message for what is not taken."""
    variant = argv[0] if len(argv) > 0 else "ship"
    mode = argv[1] if len(argv) > 1 else "grad"
    try:
        reps = int(argv[2]) if len(argv) > 2 else 100
    except ValueError:
        return f"REPS must be an integer, got {argv[2]!r}"
    if variant.startswith("bb"):
        return (f"variant {variant!r} sets MNT_ATTN_BB, the batch rows of a Pallas block on "
                "the TPU: tuning that does not carry over (K1 picks its own blocks)")
    if variant not in VARIANTS:
        return f"unknown variant {variant!r}; expected one of {', '.join(VARIANTS)}"
    if mode not in ("fwd", "grad"):
        return f"unknown mode {mode!r}; expected fwd or grad"
    if variant == "twophase" and mode == "grad":
        return ("twophase has no backward: neither the Pallas kernel nor its port "
                "(csrc/twophase_attention.cu) computes a gradient; run twophase fwd")
    if reps < 1:
        return f"REPS must be at least 1, got {reps}"
    return variant, mode, reps


def xla_attention(torch, qkv, heads):
    """The JAX model's XLA path: head-split transposes, bf16 products, the
    scores cast to fp32 in device memory, P cast back to the input type."""
    B, T, three_w = qkv.shape
    W = three_w // 3
    D = W // heads
    q, k, v = (t.reshape(B, T, heads, D).transpose(1, 2) for t in qkv.split(W, dim=-1))
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * (D**-0.5)
    attn = torch.softmax(logits, dim=-1).to(qkv.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", attn, v)
    return out.transpose(1, 2).reshape(B, T, W)


def sdpa_attention(torch, qkv, heads):
    B, T, three_w = qkv.shape
    W = three_w // 3
    q, k, v = qkv.view(B, T, 3, heads, W // heads).permute(2, 0, 3, 1, 4).unbind(0)
    out = torch.nn.functional.scaled_dot_product_attention(q, k, v)
    return out.transpose(1, 2).reshape(B, T, W)


def make_attention(torch, variant, heads):
    from menghini_neurips23_tpu_torch.ops.attention import fused_attention
    from menghini_neurips23_tpu_torch.ops.twophase_attention import twophase_attention

    return {
        "ship": lambda x: fused_attention(x, None, heads),
        "twophase": lambda x: twophase_attention(x, heads),
        "xla": lambda x: xla_attention(torch, x, heads),
        "sdpa": lambda x: sdpa_attention(torch, x, heads),
    }[variant]


def kernel_counters():
    """(wrapper, counter) of every hand-written kernel a variant may launch."""
    from menghini_neurips23_tpu_torch.ops.attention import attention_bwd, fused_attention
    from menghini_neurips23_tpu_torch.ops.twophase_attention import twophase_attention

    return ((fused_attention, "launches"), (fused_attention, "streamed_launches"),
            (attention_bwd, "launches"), (attention_bwd, "streamed_launches"),
            (twophase_attention, "launches"))


def main(argv=None) -> int:
    parsed = parse(sys.argv[1:] if argv is None else argv)
    if isinstance(parsed, str):
        print(f"exp_attn_kernels.py: {parsed}", file=sys.stderr)
        return 2
    variant, mode, reps = parsed
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("exp_attn_kernels.py: needs a CUDA card (nothing runs on the CPU)", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    B = int(os.environ.get("ATTN_B", 256))
    T = int(os.environ.get("ATTN_T", 66))
    W = int(os.environ.get("ATTN_W", 768))
    H = int(os.environ.get("ATTN_H", 12))
    D = W // H
    bf = torch.bfloat16
    rng = np.random.default_rng(0)
    qkv0 = torch.from_numpy(rng.normal(0, 1, (B, T, 3 * W)).astype(np.float32)).cuda().to(bf)
    # rank-8 fold keeps the data dependence <1% of attention's FLOPs
    fold_a = torch.from_numpy(rng.normal(0, 0.02, (W, 8)).astype(np.float32)).cuda().to(bf)
    fold_b = torch.from_numpy(rng.normal(0, 0.02, (8, 3 * W)).astype(np.float32)).cuda().to(bf)
    attn = make_attention(torch, variant, H)

    def body(x):
        if mode == "fwd":
            o = attn(x)
            # cheap data dependence to serialize reps (same all variants): one
            # GEMM with the add in its epilogue, as XLA fuses the JAX script's
            y = torch.addmm(x.view(-1, 3 * W), o.view(-1, W) @ fold_a, fold_b, alpha=0.001)
            return y.view_as(x), o.sum()
        leaf = x.detach().requires_grad_(True)
        loss = (attn(leaf).float() ** 2).mean()
        (g,) = torch.autograd.grad(loss, leaf)
        return x - 0.001 * g.to(x.dtype), loss.detach()

    def run():
        x, sums = qkv0, []
        for _ in range(reps):
            x, s = body(x)
            sums.append(s.float())
        return x.sum().float() + torch.stack(sums).sum()

    t0 = time.perf_counter()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()  # builds the kernels, warms the libraries
    torch.cuda.current_stream().wait_stream(side)
    counters = kernel_counters()
    before = [getattr(w, c) for w, c in counters]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        result = run()
    # a capture launches nothing: what it counted is what a replay launches
    per_replay = [getattr(w, c) - n for (w, c), n in zip(counters, before)]
    for (w, c), n in zip(counters, before):
        setattr(w, c, n)

    def replay():
        graph.replay()
        for (w, c), n in zip(counters, per_replay):
            setattr(w, c, getattr(w, c) + n)

    replay()
    value = result.item()
    t_first = time.perf_counter() - t0
    times = []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    if not np.isfinite(value):
        print(f"exp_attn_kernels.py: {variant}/{mode} gave {value}", file=sys.stderr)
        return 1
    dt = min(times) / reps
    # attention FLOPs only (2 dots fwd; grad adds 4 dots = 3x fwd total)
    flops = 2 * 2 * B * H * T * T * D * (3 if mode == "grad" else 1)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed",
          flush=True)
    print(
        f"RESULT {variant}/{mode}: {dt * 1e6:.2f} us/rep  {flops / dt / 1e12:.2f} TFLOPS-attn  "
        f"((B,T,W,H) ({B},{T},{W},{H}) bf16, REPS {reps}, capture+1st {t_first:.1f}s, "
        f"runs s {['%.5f' % t for t in times]}, sum {value:.6g})",
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
