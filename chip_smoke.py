#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (menghini_neurips23_tpu_torch) on one
NVIDIA GPU: builds the port's CUDA kernels from csrc/, holds each against its
plain PyTorch version at the main path's shapes, then drives the zero-shot /
pseudolabel path end to end at ViT-B/32's full width (random weights from a
seed), the SSL CoOp prompt training (textual_prompt, textual_fpl), the UL
and TRZSL visual prompt training (visual_fpl), and the IFPL/GRIP iterations
with their resume and the UPT prompts (grip_visual, grip_multimodal,
iterative_textual_fpl, multimodal_fpl), then zero-shot, VPT and UPT at
ViT-L/14's full width, and checks what they write; beside them, K4 (the
phase-grouped attention forward of the attention experiment) through the
experiment's port, scripts/exp_attn_kernels.py.  Every training run
takes the whole-run trainer (FUSED_TRAIN, the default): the step and the
epoch end as CUDA graphs replayed with K1 and K2 inside them.

    python3 chip_smoke.py            # from the repository root; needs one card

Phases (one or more lines each; any failure raises and exits non-zero):
  1. device: the card's name and power limit, torch/CUDA/nvcc/Triton
     versions, which optional host packages import, whether the native image
     loader builds; fails when torch sees no card
  2. build: compiles every kernel (one nvcc per source, all at once) and
     prints ptxas's register report; fails if any entry point spills
     registers
  3. kernels: each kernel against its plain version on the card, fp32 and
     bf16, at the main path's shapes (K1 and K2 also at ViT-L/14's and up
     to 320 tokens, where neither keeps a T x T tile, K1 also at the frozen
     ViT-L/14 pass's 256-image batch, and past 320 at T = 321, 337, 384,
     577 and 1024, where both stream K and V through shared memory, as K1
     does in fp32 from 129 tokens; K3 also at pseudolabel pools of 65,536
     rows; two K1 launches and two K2 launches must give the same bits;
     each K2 case names its block's warps), with CUDA-event times of the
     kernel, the plain version and, for attention,
     scaled_dot_product_attention as a yardstick (forward alone; forward +
     backward through autograd beside the K1 + K2 pair - the port never
     calls it), and bound_share = bound_ms / ms; the FusedAttention
     gradient against autograd of the plain forward; PSEUDO_TOPK=device on
     a 5.1M-cell pool against the exact leaderboard; K1 and K2 at a model
     rank's head counts under tensor parallelism (SHARD_SHAPES: ViT-L/14
     vision at 8 and 4 heads, its text tower at 6), each to its unsharded
     case's tolerance; one ViT-L/14 residual block cut by the port's shard
     function at m = 2, both shards' partial products summed in the
     process where the model group's all-reduce would sum them, forward
     and input gradient against the unsharded block, fp32 and bf16
     (BLOCK_TOL); K4 at TWOPHASE_SHAPES and the longest T one block
     takes, fp32 and bf16, against its plain version and against K1 on
     the same qkv (ATTN_TOL), two launches the same bits, timed beside K1,
     its plain version and SDPA's forward, and one token more refused
     with ValueError; then the experiment's port, twophase fwd at its
     default (256, 66, 768, 12) bf16, as K4's counted path (its RESULT
     line); a full-width ViT-B/32
     forward on the card against the same weights on the CPU; one CoOp, one
     deep VPT and one UPT training step at ViT-B/32 width, and one deep VPT
     and one UPT step at ViT-L/14 width (2 rows), on the card against the
     same step on the CPU (and one deep VPT step at ViT-L/14 with an 80-token
     prompt, T = 337); the whole-run trainer at ViT-B/32 width, fp32, 3
     epochs (CoOp, deep VPT, UPT on synthetic features, and deep VPT with
     FUSED_REMAT and FUSED_EPOCH_CHUNK=2, UPT with FUSED_REMAT): its captured
     graphs against its functions run eagerly on the card (within 1e-6) and
     against the per-step loop (the same best metric, prompts within 1e-4)
  4. main path: main_clip.workflow on a synthetic 10-class MNIST-layout
     dataset (224x224 PNGs, 64 train + 64 test per class), BATCH_SIZE 256,
     in float32 and in bfloat16
  5. pseudolabels: FPL top-16 per class over the 640-image train pool
  6. serving: predict.main over the 640 test images, top 5
  7. training, with the bundled configs (BATCH_SIZE 16) on the same
     dataset: main_ssl.workflow, MODEL=textual_prompt in float32 for 20
     epochs and MODEL=textual_fpl in bfloat16 for the paper's 150 epochs;
     main_ul.workflow, MODEL=visual_fpl in bfloat16 for 150 epochs, and
     main_trzsl.workflow, MODEL=visual_fpl in float32 for 20 epochs; then
     main_ul grip_visual bf16 (the paper's 10 GRIP iterations of 5 epochs,
     N_PSEUDOSHOTS 6 ... 64), main_ssl grip_multimodal bf16 (4 iterations
     of 5), main_trzsl iterative_textual_fpl fp32 (2 iterations of 5) and
     main_ssl multimodal_fpl fp32 (20 epochs), and a resume check
     (main_ssl grip_textual bf16 uninterrupted, cut after iteration 1 by
     MNT_FAIL_AFTER_ITER, resumed); then at ViT-L/14 (24 + 12 layers, W
     1024 / 768), bf16: main_clip, main_ul visual_fpl and main_ssl
     multimodal_fpl, 5 epochs each, and main_ul visual_fpl with an 80-token
     prompt (T = 337, K1 and K2 streamed), 3 epochs; each run must log one
     `fused train:` line per training run, with its graphs captured
  8. breakdown: set-up, host decode and device encode of the bf16 pass,
     each timed alone, and the device encode of the same 256-image batch
     by ViT-L/14 (K1's ms in it); one bf16 training step of textual_fpl
     (10 and 102 classes), of visual_fpl and of grip_multimodal (UPT), and
     of ViT-L/14's visual_fpl and multimodal_fpl, in the per-step loop on
     the host clock (with peak device memory) and under torch.profiler (device busy time,
     kernels by name, K2's time and share of the busy time), then in the
     whole-run trainer (10 epochs of 10 steps: wall ms per step with the
     epoch ends, device busy time and idle share, capture seconds,
     graph-pool bytes; the profiler's K1 and K2 kernels must number what
     the counters add, or up to 2% fewer) beside it; one GRIP refresh of
     grip_visual over the 640-image pool, split into its parts; and
     textual_fpl, visual_fpl and grip_visual (bf16) again in the per-step
     loop, their run walls beside the whole-run trainer's
  9. distributed (run between 7 and 8): NCCL at world size 1 (the card is one GPU, and NCCL
     refuses two ranks on one device): main_ssl textual_fpl and visual_fpl
     bf16, 10 epochs, without a process group and in a one-rank NCCL group
     (file:// store), where the frozen passes gather through NCCL and each
     step's graph holds the gradient all-reduce, and in that group again
     with MESH_SHAPE "1,1" (the (data, model) layout); the runs' artifacts
     must be the same bits and their K1/K2 launches the same; the step
     wall with and without the collective, and the NCCL kernels the
     profiler sees in the group's step-graph replays
The experiment's twophase fwd (K4's only path: no model runs K4, nor
does the JAX package run its Pallas kernel), phases 4-6 (the zero-shot
path), the SSL CoOp runs, the UL/TRZSL VPT runs,
the IFPL/GRIP/UPT runs with the resume check, the ViT-L/14 runs and the
ViT-L/14 80-token VPT run of phase 7 (five training paths), and phase 9
each run with every launch count set to 0 just before and read just after;
a kernel the path runs must show a launch (the streamed forms of K1 and K2
and K1's resident bf16 form count apart; the ViT-L/14 path must launch the
resident form, the 80-token path the streamed ones).  A graph replay
passes no Python counter: each capture records what it launched, and every
replay loop adds captured x replays.  Then one JSON line listing each
kernel with its launches (the sum over the paths, and by path), and last
the device line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import pickle
import re
import shutil
import struct
import subprocess
import sys
import time
import zlib

ROOT = os.path.dirname(os.path.abspath(__file__))
PKG = "menghini_neurips23_tpu_torch"

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and FLOP/s by type.
# A bound is the least time for the work by any means.  For bf16 inputs that
# is FLOPs at the bf16 tensor-core rate.  For fp32 inputs it is 3 x FLOPs at
# the TF32 rate: an fp32-accurate product on the tensor cores is three TF32
# products (3xTF32: hi.hi + hi.lo + lo.hi of x = hi + lo), which K3 and K1's
# streamed form run, as does PyTorch's own fp32 attention; 3 x FLOPs at 494
# TFLOP/s is less time than FLOPs at the FMA units' 67, and against the FMA
# rate a tensor-core kernel would read above 100% of its bound.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 494e12}

# kernel vs plain tolerances (max abs error), with the reason in the test
# file tests/test_torch_port_gpu.py: sums in another order; bf16 outputs may
# land on neighbouring bf16 values
ATTN_TOL = {"float32": 1e-5, "bfloat16": 2e-2}  # the backward: tol + tol * |ref| (see
# the test file: its gradients exceed 1 on unit-scale inputs, where one bf16 step is larger)
HEAD_TOL = 2e-5
MODEL_TOL = 1e-3  # ViT-B/32 features, card vs CPU, fp32 through 12 layers
STEP_PREFIX_TOL = 1e-4  # one CoOp, VPT or UPT step, card vs CPU: updated prompts (abs)
STEP_LOSS_RTOL = 1e-5  # ... and the loss (relative)
# the whole-run trainer's CUDA graphs replayed vs the same functions run
# eagerly on the card: the same kernels on the same inputs, so 0 is expected
FUSED_FORM_TOL = 1e-6

N_CLASSES, N_PER_CLASS, RES = 10, 64, 224
# K2 streams K and V through shared memory past RESIDENT_MAX_SEQ tokens, and
# so does K1 in bf16; K1 in fp32 streams past K1_RESIDENT_MAX_SEQ["float32"]
# (the wrappers count those launches in `streamed_launches`).  The kernel
# phase holds the streamed forms at ViT-L/14's width (16 heads of 64): 321,
# ViT-L/14 with an 80-token prompt (337, the main path's), 384,
# ViT-L/14@336's 577 and 1024, with B chosen so that each case's plain
# version takes a millisecond or more (337 keeps the training batch of 16)
RESIDENT_MAX_SEQ = 320
K1_RESIDENT_MAX_SEQ = {"float32": 128, "bfloat16": RESIDENT_MAX_SEQ}
# up to here K1 keeps a warp's scores in registers; from here to 320 bf16
# takes its resident kernel (counted in `resident_launches`)
K1_SHORT_MAX_SEQ = 128
LONG_SHAPES = [(48, 321, 1024, 16, None), (16, 337, 1024, 16, None),
               (32, 384, 1024, 16, None), (16, 577, 1024, 16, None),
               (8, 1024, 1024, 16, None)]
VPT_LONG_PREFIX = 80  # ViT-L/14: T = 1 + 256 + 80 = 337
# K1 and K2 at a model rank's head counts under tensor parallelism (the
# shard of MESH_SHAPE "d,m" is H/m whole heads of 64): ViT-L/14's VPT vision
# tower (16, 273) at m = 2 (8 heads) and m = 4 (4 heads), and the text tower
# over Flowers102's 102 classes at full length (102, 77) at m = 2 (6 of its
# 12 heads); each held to its unsharded case's tolerance
# K1 from 129 to 320 tokens, ViT-L/14's vision tower: the frozen pass over
# 8 images and over a 256-image batch (T = 257), VPT's training batch with a
# 16-token prompt (273, and 8 rows of it), UPT's with its 4-token prompt (261)
RESIDENT_SHAPES = [(8, 257, 1024, 16, None), (8, 273, 1024, 16, None),
                   (16, 273, 1024, 16, None), (16, 261, 1024, 16, None),
                   (256, 257, 1024, 16, None)]
SHARD_SHAPES = [(16, 273, 512, 8, None, "ViT-L/14 vision, m=2"),
                (16, 273, 256, 4, None, "ViT-L/14 vision, m=4"),
                (102, 77, 384, 6, "causal", "ViT-L/14 text, m=2")]
# the m = 2 ViT-L/14 block (sharded partials summed in the process) against
# the unsharded block: max abs error over the largest |unsharded| value;
# fp32 sums in another order, bf16 rounds each shard's partial product once
# more (two bf16 steps of the largest value)
BLOCK_TOL = {"float32": 1e-5, "bfloat16": 1.6e-2}
# K4, the attention experiment's phase-grouped forward, at the experiment's
# shape (VPT's ViT-B/32 validation batch), ViT-B/32 vision, UPT's 4-token
# prompt, VPT's training batch and a ragged (8, 17) at D = 64; phase 3 adds
# the longest T one block takes (by type, from the kernel's own query)
TWOPHASE_SHAPES = [(256, 66, 768, 12), (256, 50, 768, 12), (256, 54, 768, 12),
                   (16, 66, 768, 12), (8, 17, 256, 4)]
EXPERIMENT_REPS = 20  # scripts/exp_attn_kernels.py twophase fwd on its counted path
# GRIP over UL's 640-image pool and 10 classes: N(k) = int(k * 64 / 10)
GRIP_SCHEDULE = [6, 12, 19, 25, 32, 38, 44, 51, 57, 64]


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise RuntimeError(msg)


# ---------------------------------------------------------------- phase 1
def phase_device(torch):
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    log(smi.stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import importlib.metadata as md
    import importlib.util

    from menghini_neurips23_tpu_torch.ops import _cuda

    nvcc = subprocess.run([_cuda.nvcc_path(), "--version"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[-1]
    try:
        triton = md.version("triton")
    except md.PackageNotFoundError:
        triton = "absent"
    log(json.dumps({
        "python": sys.version.split()[0], "torch": torch.__version__,
        "cuda": torch.version.cuda, "nvcc": nvcc, "triton": triton,
        "device": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }))
    from menghini_neurips23_tpu_torch.data._native import get_fastloader

    found = {m: importlib.util.find_spec(m) is not None for m in ("yaml", "regex", "pandas", "PIL")}
    found["native_fastloader"] = get_fastloader() is not None
    log("host packages: " + json.dumps(found))
    for m in ("yaml", "pandas", "PIL", "regex"):
        if not found[m]:
            fail(f"host package {m} is missing")


# ---------------------------------------------------------------- phase 2
def phase_build():
    from menghini_neurips23_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    secs = _cuda.build(["attention_fwd", "attention_bwd", "clip_head", "twophase_attention"])
    log(f"build: {json.dumps({k: round(v, 2) for k, v in secs.items()})} "
        f"wall {time.perf_counter() - t0:.2f} s")
    for name in secs:
        report = _cuda.build_log(name)
        regs = [l.strip() for l in report.splitlines() if "registers" in l]
        log(f"  {name}: {len(regs)} entry points; " + ("; ".join(sorted(set(regs))) or "no report"))
        # every entry point's spill stores, by function (ptxas names the function first)
        spills = dict(re.findall(r"Function properties for (\S+)\s+\d+ bytes stack frame, "
                                 r"(\d+) bytes spill stores", report))
        spilled = {f: int(n) for f, n in spills.items() if int(n) > 0}
        if not spills or spilled:
            fail(f"{name}: the ptxas report shows spill stores {spilled or 'nowhere (no report)'}")


# ---------------------------------------------------------------- phase 3
def eager_ms(torch, fn, reps: int = 50) -> float:
    """CUDA-event time per call of an eager loop: for small kernels this is
    the host's issue rate (the Python wrapper), not the device's time."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(torch, fn, reps: int = 20) -> float:
    """Device time per call: `reps` calls captured in one CUDA graph and
    replayed back to back, timed with CUDA events, so host overhead drops
    out.  Inputs stay resident in L2 between calls when they fit (50 MB)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (3 * reps)
    del graph
    return ms


def bound(bytes_moved: float, flops: float, dtype: str):
    """(ms, "bytes" or "operations"): the larger of the bytes over the HBM
    rate and the operations over the peak for `dtype` (fp32 as 3xTF32)."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = (3 * flops / PEAK_FLOPS["tf32"] if dtype == "float32"
             else flops / PEAK_FLOPS[dtype]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(torch):
    import torch.nn.functional as F

    from menghini_neurips23_tpu_torch.ops.attention import attention_reference, fused_attention
    from menghini_neurips23_tpu_torch.ops.clip_head import fused_probs, fused_probs_reference

    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    g = torch.Generator(device="cuda").manual_seed(0)
    attn_cases, head_cases = [], []
    # vision (ViT-B/32, the main path's batch), the text tower: C = 10 or
    # 102 classes at the truncated lengths 16 and 24 and the full 77 (UPT's
    # text tower is the (10, 77) case), and Flowers102's (102, 48); ViT-B/32
    # vision with a 16-token VPT prefix and with UPT's 4-token prompt (a
    # training batch of 16, a validation and refresh batch of 256); ViT-L/14
    # vision without and with a VPT prefix
    shapes = [(256, 50, 768, 12, None)] + [
        (b, t, 512, 8, "causal") for b in (10, 102) for t in (16, 24, 77)
    ] + [(102, 48, 512, 8, "causal"), (16, 66, 768, 12, None), (256, 66, 768, 12, None),
         (16, 54, 768, 12, None), (256, 54, 768, 12, None)] + RESIDENT_SHAPES + LONG_SHAPES
    shapes = [s + (None,) for s in shapes] + SHARD_SHAPES
    for dname, dt in dtypes.items():
        for B, T, W, H, mask, shard in shapes:
            D = W // H
            qkv = torch.randn(B, T, 3 * W, generator=g, device="cuda").to(dt)
            out = fused_attention(qkv, mask, H)
            again = fused_attention(qkv, mask, H)
            torch.cuda.synchronize()
            same = torch.equal(out.view(torch.uint8), again.view(torch.uint8))
            err = (out.float() - attention_reference(qkv, mask, H).float()).abs().max().item()
            ok = err <= ATTN_TOL[dname]
            q, k, v = (t.contiguous() for t in qkv.view(B, T, 3, H, D).permute(2, 0, 3, 1, 4))
            causal = mask == "causal"
            ms = device_ms(torch, lambda: fused_attention(qkv, mask, H))
            eager = eager_ms(torch, lambda: fused_attention(qkv, mask, H))
            plain = device_ms(torch, lambda: attention_reference(qkv, mask, H))
            lib = device_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal))
            size = qkv.element_size()
            pairs = T * (T + 1) // 2 if causal else T * T  # key/query pairs computed
            b_ms, b_by = bound(B * T * 4 * W * size, 4 * B * H * D * pairs, dname)
            case = dict(shape=[B, T, W, H], mask=mask, dtype=dname, max_abs_err=err,
                        tol=ATTN_TOL[dname], bit_identical=same, ms=ms, eager_ms=eager,
                        plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                        bound_share=b_ms / ms,
                        streamed=T > K1_RESIDENT_MAX_SEQ[dname],
                        resident=K1_SHORT_MAX_SEQ < T <= K1_RESIDENT_MAX_SEQ[dname], shard=shard)
            attn_cases.append(case)
            log("  attention_fwd " + json.dumps(case))
            if not ok:
                fail(f"attention_fwd disagrees with its plain version: {case}")
            if not same:
                fail(f"attention_fwd: two launches on the same inputs differ: {case}")
    # (640, 512, 10): the pseudolabel pool of phase 5 in one call; then
    # pools of 65,536 rows (137 MB of fp32 features, above L2): MNIST's 10
    # classes, Flowers102's 102 (fp32 and bf16), and ViT-L/14's width
    head_shapes = [(B, E, C, d) for d in dtypes
                   for B, E, C in ((256, 512, 10), (256, 512, 102), (640, 512, 10))]
    head_shapes += [(65536, 512, 10, "float32"), (65536, 512, 102, "float32"),
                    (65536, 512, 102, "bfloat16"), (65536, 768, 102, "float32")]
    for B, E, C, dname in head_shapes:
        dt = dtypes[dname]
        img = torch.randn(B, E, generator=g, device="cuda").to(dt)
        txt = torch.randn(C, E, generator=g, device="cuda").to(dt)
        out = fused_probs(img, txt, 100.0)
        torch.cuda.synchronize()
        err = (out - fused_probs_reference(img, txt, 100.0)).abs().max().item()
        row_err = (out.sum(-1) - 1).abs().max().item()
        ms = device_ms(torch, lambda: fused_probs(img, txt, 100.0))
        eager = eager_ms(torch, lambda: fused_probs(img, txt, 100.0))
        plain = device_ms(torch, lambda: fused_probs_reference(img, txt, 100.0))
        size = img.element_size()
        flops = 2 * B * C * E + 2 * (B + C) * E
        b_ms, b_by = bound((B + C) * E * size + B * C * 4, flops, dname)
        case = dict(shape=[B, E, C], dtype=dname, max_abs_err=err, tol=HEAD_TOL,
                    row_sum_err=row_err, ms=ms,
                    eager_ms=eager, plain_ms=plain, library_ms=None, bound_ms=b_ms,
                    bound_by=b_by, bound_share=b_ms / ms)
        head_cases.append(case)
        log("  clip_head " + json.dumps(case))
        if err > HEAD_TOL or row_err > HEAD_TOL:
            fail(f"clip_head disagrees with its plain version: {case}")
    return attn_cases, head_cases


def phase_kernels_twophase(torch):
    """K4 against its plain version and against K1 on the same qkv, fp32
    and bf16, with two launches giving the same bits; its time beside K1's,
    the plain version's and SDPA's forward; one token past the longest T
    must raise ValueError."""
    import torch.nn.functional as F

    from menghini_neurips23_tpu_torch.ops import _cuda
    from menghini_neurips23_tpu_torch.ops.attention import _DTYPE_CODES, fused_attention
    from menghini_neurips23_tpu_torch.ops.twophase_attention import (
        _SIGNATURES,
        twophase_attention,
        twophase_attention_reference,
    )

    t0 = time.perf_counter()
    lib = _cuda.library("twophase_attention", _SIGNATURES)
    g = torch.Generator(device="cuda").manual_seed(2)
    cases = []
    for dname, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        code = _DTYPE_CODES[dt]
        longest = max(t for t in range(1, 513) if lib.mnt_twophase_attention_groups(t, 64, 12, code))
        for B, T, W, H in TWOPHASE_SHAPES + [(8, longest, 768, 12)]:
            D = W // H
            qkv = torch.randn(B, T, 3 * W, generator=g, device="cuda").to(dt)
            out = twophase_attention(qkv, H)
            again = twophase_attention(qkv, H)
            k1 = fused_attention(qkv, None, H)
            torch.cuda.synchronize()
            same = torch.equal(out.view(torch.uint8), again.view(torch.uint8))
            err = (out.float() - twophase_attention_reference(qkv, H).float()).abs().max().item()
            err_k1 = (out.float() - k1.float()).abs().max().item()
            q, k, v = (t.contiguous() for t in qkv.view(B, T, 3, H, D).permute(2, 0, 3, 1, 4))
            ms = device_ms(torch, lambda: twophase_attention(qkv, H))
            eager = eager_ms(torch, lambda: twophase_attention(qkv, H))
            plain = device_ms(torch, lambda: twophase_attention_reference(qkv, H))
            k1_ms = device_ms(torch, lambda: fused_attention(qkv, None, H))
            sdpa = device_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v))
            # K1's unmasked bound: qkv read, the output written; 4 H D T^2 a row
            b_ms, b_by = bound(B * T * 4 * W * qkv.element_size(), 4 * B * H * D * T * T, dname)
            case = dict(shape=[B, T, W, H], dtype=dname,
                        groups=lib.mnt_twophase_attention_groups(T, D, H, code),
                        smem_bytes=lib.mnt_twophase_attention_smem(T, D, H, code),
                        max_abs_err=err, max_abs_err_vs_k1=err_k1, tol=ATTN_TOL[dname],
                        bit_identical=same, ms=ms, eager_ms=eager, plain_ms=plain, k1_ms=k1_ms,
                        over_k1=ms / k1_ms, library_ms=sdpa,
                        library="scaled_dot_product_attention (forward, head-split)",
                        bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / ms)
            cases.append(case)
            log("  twophase_attention " + json.dumps(case))
            if err > ATTN_TOL[dname] or err_k1 > ATTN_TOL[dname]:
                fail(f"twophase_attention disagrees with its plain version or K1: {case}")
            if not same:
                fail(f"twophase_attention: two launches on the same inputs differ: {case}")
        over = torch.zeros(2, longest + 1, 3 * 768, dtype=dt, device="cuda")
        try:
            twophase_attention(over, 12)
        except ValueError as e:
            log(f"  twophase_attention {dname}: T={longest} is the longest; T={longest + 1} "
                f"refused ({e})")
        else:
            fail(f"twophase_attention {dname} took T={longest + 1}, past its shared memory")
    log(f"  twophase_attention phase wall {time.perf_counter() - t0:.1f} s")
    return cases


def phase_experiment(torch):
    """The attention experiment's port, twophase fwd at its default shape
    ((256, 66, 768, 12) bf16), as a user runs it: K4's counted path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "exp_attn_kernels", os.path.join(ROOT, "scripts", "exp_attn_kernels.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    t0 = time.perf_counter()
    code = script.main(["twophase", "fwd", str(EXPERIMENT_REPS)])
    if code != 0:
        fail(f"scripts/exp_attn_kernels.py twophase fwd exited {code}")
    log(f"  attention experiment wall {time.perf_counter() - t0:.1f} s")


def phase_model_reference(torch):
    """The whole ViT-B/32 forward on the card (through the kernels) against
    the same weights on the CPU (through the plain versions)."""
    import numpy as np

    from menghini_neurips23_tpu_torch.models import VIT_B32, build_clip, init_clip_params

    sd = init_clip_params(VIT_B32, seed=0, device="cpu")
    cpu = build_clip(VIT_B32, sd, device="cpu")
    gpu = build_clip(VIT_B32, sd, device="cuda")
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.normal(0, 1, (4, RES, RES, 3)).astype(np.float32))
    ids = torch.zeros(3, 16, dtype=torch.long)
    ids[:, 0] = VIT_B32.vocab_size - 2
    ids[:, 1:6] = torch.from_numpy(rng.integers(1, 40000, (3, 5)))
    ids[:, 6] = VIT_B32.vocab_size - 1
    with torch.inference_mode():
        errs = {
            "encode_image": (gpu.encode_image(images.cuda()).cpu() - cpu.encode_image(images)).abs().max().item(),
            "encode_text": (gpu.encode_text(ids.cuda()).cpu() - cpu.encode_text(ids)).abs().max().item(),
        }
    log(f"  ViT-B/32 card vs CPU, fp32: {json.dumps(errs)} (tol {MODEL_TOL})")
    if max(errs.values()) > MODEL_TOL:
        fail(f"ViT-B/32 forward on the card disagrees with the CPU: {errs}")


def phase_kernels_bwd(torch):
    """K2 against its plain version; its time beside the K1 + K2 pair through
    autograd and SDPA's forward + backward through autograd."""
    import torch.nn.functional as F

    from menghini_neurips23_tpu_torch.ops import _cuda
    from menghini_neurips23_tpu_torch.ops.attention import (
        _BWD_SIGNATURES,
        _DTYPE_CODES,
        attention_bwd,
        attention_bwd_reference,
        fused_attention,
    )

    lib = _cuda.library("attention_bwd", _BWD_SIGNATURES)
    g = torch.Generator(device="cuda").manual_seed(1)
    cases = []
    # the CoOp text tower (C = 10 or 102 classes, truncated 24 or full 77;
    # UPT's text tower is the (10, 77) case; Flowers102's (102, 48)), the VPT
    # vision tower (16 prompt tokens; the training batch of 16 and a batch of
    # 256), UPT's vision tower (4 prompt tokens, the training batch) and the
    # plain ViT-B/32 one; then the lengths above 128 tokens: ViT-L/14's VPT
    # (T = 273) and UPT (T = 261) training batches, a ragged T = 129, and
    # 288 and 320 (the last length bf16 holds resident), where T pads to no
    # extra 16-row tile; then LONG_SHAPES, which both kernels stream
    shapes = [(b, t, 512, 8, "causal") for b in (10, 102) for t in (24, 77)] + [
        (102, 48, 512, 8, "causal"), (16, 66, 768, 12, None), (256, 66, 768, 12, None),
        (16, 54, 768, 12, None), (256, 50, 768, 12, None),
        (16, 273, 1024, 16, None), (16, 261, 1024, 16, None), (16, 129, 1024, 16, None),
        (16, 288, 1024, 16, None), (16, 320, 1024, 16, None),
    ] + LONG_SHAPES
    shapes = [s + (None,) for s in shapes] + SHARD_SHAPES
    for dname, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        for B, T, W, H, mask, shard in shapes:
            D = W // H
            causal = mask == "causal"
            qkv = torch.randn(B, T, 3 * W, generator=g, device="cuda").to(dt)
            grad = torch.randn(B, T, W, generator=g, device="cuda").to(dt)
            out = attention_bwd(qkv, grad, mask, H)
            again = attention_bwd(qkv, grad, mask, H)
            torch.cuda.synchronize()
            same = torch.equal(out.view(torch.uint8), again.view(torch.uint8))
            ref = attention_bwd_reference(qkv, grad, mask, H).float()
            diff = (out.float() - ref).abs()
            err = diff.max().item()
            tol = ATTN_TOL[dname]
            ok = bool((diff <= tol + tol * ref.abs()).all())
            leaf = qkv.detach().requires_grad_(True)
            heads = [t.detach().contiguous().requires_grad_(True)
                     for t in qkv.view(B, T, 3, H, D).permute(2, 0, 3, 1, 4)]
            g_heads = grad.view(B, T, H, D).transpose(1, 2).contiguous()
            ms = device_ms(torch, lambda: attention_bwd(qkv, grad, mask, H))
            plain = device_ms(torch, lambda: attention_bwd_reference(qkv, grad, mask, H))
            pair = device_ms(torch, lambda: torch.autograd.grad(
                fused_attention(leaf, mask, H), leaf, grad))
            sdpa = device_ms(torch, lambda: torch.autograd.grad(
                F.scaled_dot_product_attention(*heads, is_causal=causal), heads, g_heads))
            size = qkv.element_size()
            pairs = T * (T + 1) // 2 if causal else T * T  # key/query pairs computed
            # reads qkv (3W) and g (W), writes dqkv (3W); five T x T x D products
            b_ms, b_by = bound(B * T * 7 * W * size, 10 * B * H * D * pairs, dname)
            case = dict(shape=[B, T, W, H], mask=mask, dtype=dname,
                        warps=lib.mnt_attention_bwd_warps(T, D, _DTYPE_CODES[dt]),
                        max_abs_err=err, tol=tol, rtol=tol, bit_identical=same, ms=ms,
                        plain_ms=plain, pair_ms=pair, library_ms=sdpa,
                        library="autograd.grad of scaled_dot_product_attention "
                        "(forward + backward)", sdpa_ratio=ms / sdpa, bound_ms=b_ms,
                        bound_by=b_by, bound_share=b_ms / ms, streamed=T > RESIDENT_MAX_SEQ,
                        shard=shard)
            cases.append(case)
            log("  attention_bwd " + json.dumps(case))
            if not ok:
                fail(f"attention_bwd disagrees with its plain version: {case}")
            if not same:
                fail(f"attention_bwd: two launches on the same inputs differ: {case}")
    # the FusedAttention gradient (K1 forward + K2 backward) against autograd
    # of the plain forward, both on the card, fp32
    from menghini_neurips23_tpu_torch.ops.attention import attention_reference

    for B, T, W, H, mask in ((10, 24, 512, 8, "causal"), (256, 66, 768, 12, None),
                             (10, 77, 512, 8, "causal"), (16, 54, 768, 12, None),
                             (4, 273, 1024, 16, None)):
        qkv = torch.randn(B, T, 3 * W, generator=g, device="cuda")
        grad = torch.randn(B, T, W, generator=g, device="cuda")
        a = qkv.clone().requires_grad_(True)
        (got,) = torch.autograd.grad(fused_attention(a, mask, H), a, grad)
        b = qkv.clone().requires_grad_(True)
        (want,) = torch.autograd.grad(attention_reference(b, mask, H), b, grad)
        diff = (got - want).abs()
        err = diff.max().item()
        log(f"  FusedAttention gradient vs autograd of the plain forward {[B, T, W, H]} "
            f"{mask}: max abs err {err:.3g} (tol 1e-5 + 1e-5 relative)")
        if not bool((diff <= 1e-5 + 1e-5 * want.abs()).all()):
            fail(f"FusedAttention gradient disagrees with autograd: {err}")
    return cases


def phase_sharded_block(torch, B: int = 16, T: int = 273, W: int = 1024, H: int = 16):
    """Tensor parallelism's shard arithmetic on the card (not a runtime
    path: one card cannot hold a model group, NCCL refuses two ranks on one
    device).  One ViT-L/14 residual block with random weights from a seed
    is cut by the port's shard function at m = 2; both shards' partial
    products (`partial`, `mlp_partial`: K1 and, for the gradient, K2 at
    8 heads) are summed here in fp32, where the model group's all-reduce
    would sum them, and the output biases added once after the sum, as
    parallel/tensor.py does.  The forward and the input gradient, fp32 and
    bf16, against the unsharded block (16 heads) on the same input: max abs
    error within BLOCK_TOL of the largest |unsharded| value.  bf16 also
    prints both blocks' distance from the fp32 block."""
    from menghini_neurips23_tpu_torch.models.clip import ResidualAttentionBlock
    from menghini_neurips23_tpu_torch.parallel import tensor

    g = torch.Generator().manual_seed(12)
    shapes = {k: v.shape for k, v in ResidualAttentionBlock(W, H, torch.float32).state_dict().items()}
    sd = {}
    for k, shape in shapes.items():
        if k.endswith("weight") and k.startswith("ln_"):
            sd[k] = 1 + 0.02 * torch.randn(shape, generator=g)
        elif k.endswith("bias"):
            sd[k] = 0.02 * torch.randn(shape, generator=g)
        else:  # (out, in): 1/sqrt(fan_in)
            sd[k] = torch.randn(shape, generator=g) * shape[1] ** -0.5
    pre = "visual.transformer.resblocks.0."
    shards = [{k[len(pre):]: v for k, v in tensor.shard_state_dict(
        {pre + k: v for k, v in sd.items()}, 2, r).items()} for r in range(2)]
    x0 = torch.randn(B, T, W, generator=g).cuda()
    g0 = torch.randn(B, T, W, generator=g).cuda()

    def block(dt, state, tp=None):
        blk = ResidualAttentionBlock(W, H, dt, tp=tp).cuda()
        blk.load_state_dict(state)
        return blk.requires_grad_(False)

    def sharded(blocks, x):
        b0, dt = blocks[0], blocks[0].dtype
        h = b0.ln_1(x)
        total = sum(b.attn.partial(h).float() for b in blocks)
        x = x + (total + b0.attn.out_proj.bias.float()).to(dt)
        h = b0.ln_2(x)
        total = sum(b.mlp_partial(h).float() for b in blocks)
        return x + (total + b0.mlp["c_proj"].bias.float()).to(dt)

    def fwd_grad(fn, x, gy):
        leaf = x.detach().requires_grad_(True)
        y = fn(leaf)
        (dx,) = torch.autograd.grad(y, leaf, gy)
        return y.detach().float(), dx.float()

    out = {}
    ref32 = None
    for dname, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        full = block(dt, sd)
        parts = [block(dt, shards[r], tensor.TensorParallel(2, r, None)) for r in range(2)]
        x, gy = x0.to(dt), g0.to(dt)
        y_full, dx_full = fwd_grad(full, x, gy)
        y_tp, dx_tp = fwd_grad(lambda v: sharded(parts, v), x, gy)
        torch.cuda.synchronize()
        rec = {"shape": [B, T, W, H], "m": 2, "dtype": dname, "tol": BLOCK_TOL[dname],
               "forward_max_abs_err": (y_tp - y_full).abs().max().item(),
               "forward_max_abs_ref": y_full.abs().max().item(),
               "input_grad_max_abs_err": (dx_tp - dx_full).abs().max().item(),
               "input_grad_max_abs_ref": dx_full.abs().max().item()}
        rec["forward_rel_err"] = rec["forward_max_abs_err"] / rec["forward_max_abs_ref"]
        rec["input_grad_rel_err"] = rec["input_grad_max_abs_err"] / rec["input_grad_max_abs_ref"]
        if dname == "float32":
            ref32 = (block(torch.float32, sd), y_full, dx_full)
        else:  # both bf16 blocks against the fp32 block on the same bf16 input
            y32, dx32 = fwd_grad(ref32[0], x.float(), gy.float())
            rec["vs_fp32_block"] = {
                "unsharded": [(y_full - y32).abs().max().item(), (dx_full - dx32).abs().max().item()],
                "sharded": [(y_tp - y32).abs().max().item(), (dx_tp - dx32).abs().max().item()]}
        out[dname] = rec
        log("  sharded ViT-L/14 block (m=2) vs unsharded: " + json.dumps(rec))
        if max(rec["forward_rel_err"], rec["input_grad_rel_err"]) > BLOCK_TOL[dname] or \
                not (torch.isfinite(y_tp).all() and torch.isfinite(dx_tp).all()):
            fail(f"the m = 2 sharded block disagrees with the unsharded one: {rec}")
    return out


def phase_device_topk(torch):
    """PSEUDO_TOPK='device' on the card: a 50,000 x 102 pool (5.1M cells,
    above the host delegation's 5M) with no board overflowing at k = 700,
    against the exact host leaderboard (byte-identical lists), each timed
    on the host clock (the device path's copies included)."""
    import numpy as np

    from menghini_neurips23_tpu_torch.pseudo import leaderboard_top_k
    from menghini_neurips23_tpu_torch.pseudo import device_topk as mod

    n, c, k = 50_000, 102, 700
    rng = np.random.default_rng(11)
    logits = rng.normal(0, 2, (n, c))
    probs = np.exp(logits - logits.max(1, keepdims=True))
    probs /= probs.sum(1, keepdims=True)
    paths = [f"pool/img_{i:05d}.png" for i in range(n)]
    ids = list(range(c))
    ranked, inner = [], mod._segmented_topk_scores
    mod._segmented_topk_scores = lambda *a: ranked.append(a[-1]) or inner(*a)
    try:
        mod.device_topk(probs, paths, k, ids, device="cuda")  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = mod.device_topk(probs, paths, k, ids, device="cuda")
        dev_ms = (time.perf_counter() - t0) * 1e3
    finally:
        mod._segmented_topk_scores = inner
    t0 = time.perf_counter()
    want = leaderboard_top_k(probs, paths, k, ids)
    host_ms = (time.perf_counter() - t0) * 1e3
    rec = {"pool": [n, c], "k": k, "selected": len(got[0]),
           "ranked_on": sorted({str(d) for d in ranked}), "equal": got == want,
           "device_topk_ms": dev_ms, "host_leaderboard_ms": host_ms}
    log("  device top-k vs the exact leaderboard: " + json.dumps(rec))
    if got != want or not ranked or any(d.type != "cuda" for d in ranked):
        fail(f"device top-k: not the exact leaderboard's selection, or not ranked on the card: "
             f"{rec}")


def step_runtimes(torch, encoder: str = "ViT-B/32"):
    """fp32 runtimes of `encoder` on the CPU and on the card, with the same
    (random, seeded) weights."""
    from menghini_neurips23_tpu_torch.config import Config
    from menghini_neurips23_tpu_torch.runtime import ClipRuntime

    cfg = Config(VIS_ENCODER=encoder, COMPUTE_DTYPE="float32", BATCH_SIZE=16, OPTIM_SEED=1)
    cpu_rt = ClipRuntime(cfg, device="cpu")
    gpu_rt = ClipRuntime(cfg, device="cuda")
    gpu_rt.model.load_state_dict(cpu_rt.model.state_dict())
    return {"cpu": cpu_rt, "cuda": gpu_rt}


def leaves(tree):
    """The arrays of a prompt parameter list in a fixed order: lists in
    order, the UPT mixer's parameter dicts by key, None skipped."""
    import numpy as np

    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in leaves(t)]
    return [np.asarray(tree)]


def one_step_card_vs_cpu(torch, runtimes, what, cls, cfg, prompt, feats, ctx=None,
                         launches=(12, 12)):
    """One training step of strategy `cls` (two loss groups at textual_fpl's
    balance, 128 pseudo / 16 labeled) from the same weights, prompt, class
    context and batch of `feats` rows: on the card through K1 + K2, on the
    CPU through the plain versions.  `ctx` None takes the strategy's own
    class context; `launches` is the (K1, K2) count the step makes on the
    card."""
    import numpy as np

    from menghini_neurips23_tpu_torch.ops.attention import attention_bwd, fused_attention

    classes = [str(i) for i in range(N_CLASSES)]
    l2i = {c: i for i, c in enumerate(classes)}
    rows = feats.shape[0]
    rng = np.random.default_rng(0)
    labels = torch.from_numpy(rng.integers(0, N_CLASSES, rows).astype(np.int32))
    group = torch.from_numpy((np.arange(rows) % 2).astype(np.int32))
    valid = torch.ones(rows)
    out = {}
    for name, rt in runtimes.items():
        strat = cls(cfg, l2i, classes, classes, classes, runtime=rt)
        strat.load_parameters(prompt)
        strat._w0, strat._w1 = 8.0, 1.0
        dev = rt.device
        c = strat._class_context(classes) if ctx is None else ctx.to(dev)
        f0, b0 = fused_attention.launches, attention_bwd.launches
        loss, correct = strat._apply_step(c, 0.1, feats.to(dev), labels.to(dev), group.to(dev),
                                          valid.to(dev))
        n = (fused_attention.launches - f0, attention_bwd.launches - b0)
        out[name] = (loss, correct, leaves(strat.epoch_parameters()), n, tuple(c.shape))
    (lc, cc, pc, nc, shape), (lg, cg, pg, ng, _) = out["cpu"], out["cuda"]
    start = leaves(prompt)
    p_err = max(float(np.abs(g - c).max()) for g, c in zip(pg, pc))
    moved = min(float(np.abs(c - p).max()) for c, p in zip(pc, start))
    l_rel = abs(lg - lc) / abs(lc)
    rec = {"class_context": list(shape), "batch": list(feats.shape),
           "prompt_arrays": len(start), "prompt_values": int(sum(p.size for p in start)),
           "loss_cpu": lc, "loss_card": lg,
           "loss_rel_err": l_rel, "correct": [cc, cg], "prompt_max_abs_err": p_err,
           "prompt_moved_min": moved, "card_launches_k1_k2": list(ng),
           "cpu_launches_k1_k2": list(nc)}
    log(f"  one {what} step, {runtimes['cuda'].arch.name} fp32, card vs CPU: {json.dumps(rec)} "
        f"(tol {STEP_PREFIX_TOL} abs prompt, {STEP_LOSS_RTOL} rel loss)")
    if not (len(pg) == len(pc) == len(start) and p_err <= STEP_PREFIX_TOL
            and l_rel <= STEP_LOSS_RTOL and cc == cg and moved > 0):
        fail(f"one {what} step on the card disagrees with the CPU: {rec}")
    if ng != tuple(launches) or nc != (0, 0):
        fail(f"one {what} step: K1/K2 launches card {ng}, CPU {nc}; expected "
             f"{tuple(launches)} and (0, 0)")


def phase_one_step(torch, runtimes):
    """One CoOp step (textual_fpl) at ViT-B/32 width, fp32, card vs CPU: the
    text tower over the 10 class prompts, a batch of 16 image features."""
    import numpy as np

    from menghini_neurips23_tpu_torch.config import Config
    from menghini_neurips23_tpu_torch.models.prompts import init_prefix
    from menghini_neurips23_tpu_torch.training import TextualStrategy

    cfg = Config(VIS_ENCODER="ViT-B/32", MODEL="textual_fpl", COMPUTE_DTYPE="float32",
                 BATCH_SIZE=16, OPTIM_SEED=1)
    prefix = init_prefix(torch.Generator().manual_seed(7), 16, 512).numpy()
    feats = np.random.default_rng(1).normal(0, 1, (16, 512)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    one_step_card_vs_cpu(torch, runtimes, "CoOp", TextualStrategy, cfg, [prefix],
                         torch.from_numpy(feats))


def phase_one_vpt_step(torch, runtimes, rows: int = 16, prefix: int = 16):
    """One deep VPT step (visual_fpl, VPT_DEEP on) at the runtimes' full
    width, fp32, card vs CPU: the vision tower over a batch of `rows` token
    sequences with a `prefix`-token prompt (16: T = 66 at ViT-B/32, 273 at
    ViT-L/14; 80 at ViT-L/14: T = 337, which K1 and K2 stream) and every
    later layer's deep prompts, against 10 frozen text features."""
    import numpy as np

    from menghini_neurips23_tpu_torch.config import Config
    from menghini_neurips23_tpu_torch.models.prompts import init_deep_prefix, init_prefix
    from menghini_neurips23_tpu_torch.training import VisualStrategy

    a = runtimes["cuda"].arch
    cfg = Config(VIS_ENCODER=a.name, MODEL="visual_fpl", COMPUTE_DTYPE="float32",
                 BATCH_SIZE=16, OPTIM_SEED=1, VPT_DEEP=True, PREFIX_SIZE=prefix)
    gen = torch.Generator().manual_seed(7)
    prompt = [init_prefix(gen, prefix, a.vision_width).numpy(),
              init_deep_prefix(gen, a.vision_layers - 1, prefix, a.vision_width).numpy()]
    rng = np.random.default_rng(1)
    tokens = rng.normal(0, 1, (rows, 1 + a.num_patches, a.vision_width)).astype(np.float32)
    text = rng.normal(0, 1, (N_CLASSES, a.embed_dim)).astype(np.float32)
    text /= np.linalg.norm(text, axis=1, keepdims=True)
    one_step_card_vs_cpu(torch, runtimes, f"deep VPT (T = {1 + a.num_patches + prefix})",
                         VisualStrategy, cfg, prompt, torch.from_numpy(tokens),
                         torch.from_numpy(text), launches=(a.vision_layers,) * 2)


def phase_one_upt_step(torch, runtimes, rows: int = 16):
    """One UPT step (multimodal_fpl) at the runtimes' full width, fp32, card
    vs CPU: the mixer (plain fp32 attention, no kernel), the text tower over
    the 10 class prompts at the full 77 tokens and the vision tower over a
    batch of `rows` token sequences with the 4-token prompt (T = 54 at
    ViT-B/32, 261 at ViT-L/14); a K1 and a K2 in every layer of both towers.
    The UPT prompt (coop, vpt and every mixer parameter) is one
    torch.Generator draw."""
    import numpy as np

    from menghini_neurips23_tpu_torch.config import Config
    from menghini_neurips23_tpu_torch.models.prompts import (
        build_upt_mixer,
        init_upt_params,
        mixer_parts,
    )
    from menghini_neurips23_tpu_torch.training import MultimodalStrategy

    a = runtimes["cuda"].arch
    cfg = Config(VIS_ENCODER=a.name, MODEL="multimodal_fpl", COMPUTE_DTYPE="float32",
                 BATCH_SIZE=16, OPTIM_SEED=1)
    p = init_upt_params(torch.Generator().manual_seed(7), cfg, a)
    mixer = build_upt_mixer(a, cfg, p["mixer"], "cpu")
    prompt = mixer_parts(mixer) + [p["coop"].numpy(), None, p["vpt"].numpy()]
    rng = np.random.default_rng(1)
    tokens = rng.normal(0, 1, (rows, 1 + a.num_patches, a.vision_width)).astype(np.float32)
    one_step_card_vs_cpu(torch, runtimes, "UPT", MultimodalStrategy, cfg, prompt,
                         torch.from_numpy(tokens),
                         launches=(a.transformer_layers + a.vision_layers,) * 2)


class Rows:
    """A training or validation set of synthetic rows: what `train()` reads
    of a dataset.  Its file paths name rows of a feature table that stands
    in for the frozen towers' output."""

    transform = None
    label_id = True

    def __init__(self, paths, labels):
        self.filepaths, self.labels = list(paths), [int(x) for x in labels]

    def label_ids(self):
        return list(self.labels)


def fused_form_run(torch, rt, cls, cfg, table, labels, form: str):
    """One `train()` of strategy `cls` on the runtime `rt` over rows of
    `table` (40 training rows: 3 batches of 16, the last padded; 24
    validation rows), in `form`: "captured" (the whole-run trainer's CUDA
    graphs, the default), "eager" (its two functions run on the card without
    capture) or "per-step" (FUSED_TRAIN off).  Returns (best metric, best
    prompt arrays, final prompt arrays, the trainer's record or None)."""
    import copy

    classes = [str(i) for i in range(N_CLASSES)]
    cfg = copy.copy(cfg)
    cfg.FUSED_TRAIN = form != "per-step"
    strat = cls(cfg, {c: i for i, c in enumerate(classes)}, classes, classes, classes,
                runtime=rt)
    strat._fused_eager = form == "eager"
    paths = [f"row{i}" for i in range(len(table))]
    row = {p: i for i, p in enumerate(paths)}
    strat._features_for_paths = lambda ps, **k: table[[row[p] for p in ps]]
    best, params = strat.train(Rows(paths[:40], labels[:40]), Rows(paths[40:], labels[40:]),
                               only_seen=True)
    torch.cuda.synchronize()
    return best, leaves(params), leaves(strat.epoch_parameters()), strat.__dict__.get(
        "_fused_info")


def phase_fused_forms(torch, runtimes):
    """The whole-run trainer at ViT-B/32 width, fp32, 3 epochs, for CoOp,
    deep VPT and UPT, then deep VPT with FUSED_REMAT (the vision tower under
    torch.utils.checkpoint inside the captured step) and FUSED_EPOCH_CHUNK=2
    (two chunks, a chunk state saved from the card and cleared) and UPT with
    FUSED_REMAT, each from the same initial prompt and RNG state: its
    captured graphs replayed against the same two functions run eagerly on
    the card (prompts and per-epoch stats within FUSED_FORM_TOL), and
    against the per-step loop (the same best metric, prompts within
    STEP_PREFIX_TOL).  Synthetic frozen features: unit image features for
    CoOp, normal(0, 1) patch tokens for VPT and UPT."""
    import numpy as np

    from menghini_neurips23_tpu_torch.config import Config
    from menghini_neurips23_tpu_torch.training import (
        MultimodalStrategy,
        TextualStrategy,
        VisualStrategy,
    )

    import tempfile

    rt = runtimes["cuda"]
    a = rt.arch
    rng = np.random.default_rng(5)
    labels = rng.integers(0, N_CLASSES, 64)
    ckpt = tempfile.mkdtemp(prefix="smoke_chunks_")
    for what, cls, kw in (
            ("CoOp", TextualStrategy, dict(MODEL="textual_fpl")),
            ("deep VPT", VisualStrategy, dict(MODEL="visual_fpl", VPT_DEEP=True)),
            ("UPT", MultimodalStrategy, dict(MODEL="multimodal_fpl")),
            ("deep VPT, FUSED_REMAT, FUSED_EPOCH_CHUNK=2", VisualStrategy,
             dict(MODEL="visual_fpl", VPT_DEEP=True, FUSED_REMAT=True, FUSED_EPOCH_CHUNK=2,
                  CHECKPOINT_ITER=True, ARTIFACT_DIR=ckpt)),
            ("UPT, FUSED_REMAT", MultimodalStrategy,
             dict(MODEL="multimodal_fpl", FUSED_REMAT=True))):
        cfg = Config(VIS_ENCODER=a.name, COMPUTE_DTYPE="float32", BATCH_SIZE=16, EPOCHS=3,
                     OPTIM_SEED=1, LR=0.5, WARMUP_EPOCHS=0, MOMENTUM=0.9, **kw)
        if cls is TextualStrategy:
            table = rng.normal(0, 1, (64, a.embed_dim)).astype(np.float32)
            table /= np.linalg.norm(table, axis=1, keepdims=True)
        else:
            table = rng.normal(0, 1, (64, 1 + a.num_patches, a.vision_width)).astype(np.float32)
        runs = {form: fused_form_run(torch, rt, cls, cfg, table, labels, form)
                for form in ("captured", "eager", "per-step")}
        (bg, pg, fg, ig), (be, pe, fe, ie), (bl, pl, fl, il) = (
            runs["captured"], runs["eager"], runs["per-step"])

        def diff(x, y):
            return max(float(np.abs(u - v).max()) for u, v in zip(x, y))

        rec = {
            "best_metric": {"captured": bg, "eager": be, "per_step": bl},
            "captured_vs_eager_prompt_max_abs": diff(pg + fg, pe + fe),
            "captured_vs_eager_stats_max_abs": float(np.abs(ig["stats"] - ie["stats"]).max()),
            "captured_vs_per_step_prompt_max_abs": diff(pg + fg, pl + fl),
            "stats": ig["stats"].tolist(), "launches_per_step_k1_k2": ig["launches_per_step"],
            "launches_per_epoch_end_k1_k2": ig["launches_per_epoch_end"],
            "capture_s": ig["capture_s"], "graph_pool_bytes": ig["pool_bytes"],
        }
        log(f"  whole-run trainer, {what}, {a.name} fp32, captured / eager / per-step: "
            f"{json.dumps(rec)} (tol {FUSED_FORM_TOL} captured vs eager, {STEP_PREFIX_TOL} "
            "vs the per-step loop)")
        # the per-step loop's metric is a float64 mean, the trainer's fp32
        if not (ig["graphs"] and not ie["graphs"] and il is None and bg == be
                and abs(bg - bl) <= 1e-6
                and rec["captured_vs_eager_prompt_max_abs"] <= FUSED_FORM_TOL
                and rec["captured_vs_eager_stats_max_abs"] <= FUSED_FORM_TOL
                and rec["captured_vs_per_step_prompt_max_abs"] <= STEP_PREFIX_TOL
                and ig["stats"].shape == (3, 3) and np.isfinite(ig["stats"]).all()):
            fail(f"whole-run trainer, {what}: the forms disagree: {rec}")
    left = [f for _, _, fs in os.walk(ckpt) for f in fs]
    shutil.rmtree(ckpt, ignore_errors=True)
    if left:
        fail(f"whole-run trainer: chunk states left after the chunked runs: {left}")


# ---------------------------------------------------------------- phase 4
def _png(path: str, rgb) -> None:
    """Minimal PNG writer (8-bit RGB, no filtering), standard library only."""
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[r].tobytes() for r in range(h))

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 1)))
        f.write(chunk(b"IEND", b""))


def make_dataset(root: str):
    """MNIST layout: labels.txt, train.txt/test.txt ("c/c_imgN.png id"),
    images under train/<c>/ and test/<c>/, class-coloured with noise."""
    import numpy as np

    classes = [str(i) for i in range(N_CLASSES)]
    rng = np.random.default_rng(0)
    os.makedirs(root)
    with open(f"{root}/labels.txt", "w") as f:
        f.write("\n".join(classes) + "\n")
    lines = {"train": [], "test": []}
    for ci, c in enumerate(classes):
        for split in ("train", "test"):
            os.makedirs(f"{root}/{split}/{c}")
            for i in range(N_PER_CLASS):
                img = np.zeros((RES, RES, 3), np.uint8)
                img[..., ci % 3] = 120 + 12 * ci
                # 28x28 noise blown up 8x: MNIST-like blocks, cheap to compress
                noise = rng.integers(0, 40, (RES // 8, RES // 8, 3), dtype=np.uint8)
                img += np.repeat(np.repeat(noise, 8, axis=0), 8, axis=1)
                name = f"{c}/{c}_img{i}.png"
                _png(f"{root}/{split}/{name}", img)
                lines[split].append(f"{name} {ci}")
    for split, ls in lines.items():
        with open(f"{root}/{split}.txt", "w") as f:
            f.write("\n".join(ls) + "\n")
    return classes


def _config(data_dir: str, artifacts: str, dtype: str, model: str = "clip_baseline",
            encoder: str = "ViT-B/32"):
    from menghini_neurips23_tpu_torch.config import Config

    return Config(
        DATASET_NAME="MNIST", DATASET_DIR=data_dir, MODEL=model, VIS_ENCODER=encoder,
        LEARNING_PARADIGM="ssl", PROMPT_TEMPLATE="a photo of a {}", BATCH_SIZE=256,
        COMPUTE_DTYPE=dtype, OPTIM_SEED=1, SPLIT_SEED=500, ARTIFACT_DIR=artifacts,
    )


def phase_main_clip(torch, data_dir: str, work: str, dtype: str, encoder: str = "ViT-B/32"):
    import numpy as np

    from menghini_neurips23_tpu_torch.runners import main_clip

    enc = encoder.replace("/", "")
    artifacts = f"{work}/artifacts_{dtype}_{enc}"
    cfg = _config(data_dir, artifacts, dtype, encoder=encoder)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    resp = main_clip.workflow(cfg.DATASET_DIR, cfg, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = N_CLASSES * N_PER_CLASS
    with open(f"{artifacts}/results_model_clip_baseline.json") as f:
        rec = json.loads(f.readline())
    stem = f"MNIST_ssl_clip_baseline_{enc}_opt_1_spl_500.pickle"
    with open(f"{artifacts}/evaluation/{stem}", "rb") as f:
        pred = pickle.load(f)
    logits = np.asarray(pred["logits"])
    what = f"main_clip[{encoder}, {dtype}]"
    if rec["model"] != "clip_baseline" or not 0.0 <= rec["accuracy"] <= 1.0:
        fail(f"{what}: bad results line {rec}")
    if logits.shape != (n, N_CLASSES) or not np.isfinite(logits).all():
        fail(f"{what}: logits {logits.shape}, finite={np.isfinite(logits).all()}")
    if len(pred["predictions"]) != n or len(pred["images"]) != n:
        fail(f"{what}: {len(pred['predictions'])} predictions for {n} images")
    log(f"  {what}: accuracy {resp[0]:.4f}, {n} test images, wall {wall:.3f} s "
        f"({n / wall:.1f} img/s end to end, runtime set-up and decode included)")
    return wall


# ---------------------------------------------------------------- phase 5
def phase_pseudolabels(torch, data_dir: str, work: str):
    import numpy as np

    from menghini_neurips23_tpu_torch.data import dataset_object, get_class_names
    from menghini_neurips23_tpu_torch.pseudo import leaderboard_top_k, pseudolabel_top_k
    from menghini_neurips23_tpu_torch.training import TrainingStrategy

    k = 16
    artifacts = f"{work}/artifacts_pseudo"
    cfg = _config(data_dir, artifacts, "float32", model="textual_fpl")
    classes, _, _ = get_class_names("MNIST", data_dir, cfg.SPLIT_SEED)
    l2i = {c: i for i, c in enumerate(classes)}
    with open(f"{data_dir}/MNIST/train.txt") as f:
        pool = [f"train/{l.split()[0]}" for l in f if l.strip()]
    ds = dataset_object("MNIST")(pool, f"{data_dir}/MNIST", train=True, labels=None,
                                 label_map=l2i)
    paths = list(ds.filepaths)
    t0 = time.perf_counter()
    strategy = TrainingStrategy(cfg, l2i, classes, classes, classes, device="cuda")
    probs = {}

    def probs_fn():
        probs["p"] = strategy._zero_shot_probs(paths, classes)
        return probs["p"]

    pseudolabel_top_k(cfg, "MNIST", k, ds, classes, l2i, probs_fn)
    wall = time.perf_counter() - t0
    p = probs["p"]
    if p.shape != (len(pool), N_CLASSES) or not np.isfinite(p).all():
        fail(f"pseudolabels: probabilities {p.shape}")
    if not np.allclose(p.sum(1), 1.0, atol=1e-4):
        fail("pseudolabels: probability rows do not sum to 1")
    want_f, want_l = leaderboard_top_k(p, paths, k, [l2i[c] for c in classes])
    n_sel = len(ds.filepaths)
    counts = np.bincount(np.asarray(ds.labels, int), minlength=N_CLASSES)
    cache = (f"{artifacts}/pseudolabels/MNIST_ViT-B32_ssl_textual_fpl_{k}"
             f"_pseudolabels_split_500.pickle")
    with open(cache, "rb") as f:
        cached = pickle.load(f)
    # (one image may sit on several boards: the reference's cascade offers a
    # rejected image to every other class without stopping at the first)
    if not (0 < n_sel <= k * N_CLASSES and counts.max() <= k
            and ds.filepaths == want_f and ds.labels == want_l
            and cached == {"filepaths": want_f, "labels": want_l}):
        fail(f"pseudolabels: selection of {n_sel} (per class {counts.tolist()}) is not the "
             "leaderboard's, or the cache differs")
    log(f"  pseudolabels: {n_sel} of {len(pool)} selected (K={k}, per class "
        f"{counts.tolist()}), cache written, wall {wall:.3f} s")
    return wall


# ---------------------------------------------------------------- phase 6
def phase_serving(torch, data_dir: str, work: str):
    import math

    from menghini_neurips23_tpu_torch import predict

    yml = f"{work}/predict.yml"
    with open(yml, "w") as f:
        f.write(f"BATCH_SIZE: 256\nARTIFACT_DIR: {work}/artifacts_predict\n")
    env = dict(DATASET_NAME="MNIST", DATASET_DIR=data_dir, MODEL="clip_baseline",
               VIS_ENCODER="ViT-B/32", OPTIM_SEED="1", SPLIT_SEED="500")
    out_json = f"{work}/predictions.json"
    t0 = time.perf_counter()
    preds = predict.main(
        ["--model_config", yml, "--learning_paradigm", "ssl",
         "--images", f"{data_dir}/MNIST/test", "--top_k", "5", "--output", out_json],
        env=env, device="cuda",
    )
    wall = time.perf_counter() - t0
    n = N_CLASSES * N_PER_CLASS
    good = all(
        len(p["top_k"]) == 5 and all(0.0 <= t["confidence"] <= 1.0 and math.isfinite(t["confidence"])
                                     for t in p["top_k"])
        for p in preds
    )
    if len(preds) != n or not good or not os.path.exists(out_json):
        fail(f"serving: {len(preds)} predictions for {n} images (well-formed: {good})")
    log(f"  serving: {len(preds)} predictions, top 5 each, wall {wall:.3f} s "
        f"({n / wall:.1f} img/s end to end)")
    return wall


# ---------------------------------------------------------------- phase 7
def train_config(data_dir: str, artifacts: str, paradigm: str, model: str, dtype: str,
                 epochs: int, step_quantile=None, encoder: str = "ViT-B/32"):
    """The bundled configs/<model>_config.yml with the launcher's environment
    (VIS_ENCODER `encoder`), `epochs` epochs in `dtype`, artifacts under
    `artifacts`; for IFPL/GRIP 100 / `step_quantile` iterations."""
    import argparse

    from menghini_neurips23_tpu_torch.runners import common

    env = dict(DATASET_NAME="MNIST", DATASET_DIR=data_dir, MODEL=model,
               VIS_ENCODER=encoder, OPTIM_SEED="1", SPLIT_SEED="500")
    args = argparse.Namespace(model_config=f"{model}_config.yml", learning_paradigm=paradigm)
    cfg = common.load_config(args, env=env)
    cfg.EPOCHS, cfg.COMPUTE_DTYPE, cfg.ARTIFACT_DIR = epochs, dtype, artifacts
    if step_quantile is not None:
        cfg.STEP_QUANTILE = step_quantile
    return cfg


def initial_prompt(torch, cfg, arch, reinit: int):
    """The prompt a strategy draws at re-init `reinit` (the generator seeded
    OPTIM_SEED * 1000 + reinit), as the arrays its saved parameters hold:
    [prefix] for CoOp and VPT, [coop, vpt] for UPT."""
    from menghini_neurips23_tpu_torch.models.prompts import init_prefix, init_upt_params

    gen = torch.Generator().manual_seed(cfg.OPTIM_SEED * 1000 + reinit)
    if cfg.MODALITY == "multi":
        p = init_upt_params(gen, cfg, arch)
        return [p["coop"].numpy(), p["vpt"].numpy()]
    width = arch.transformer_width if cfg.MODALITY == "text" else arch.vision_width
    return [init_prefix(gen, cfg.PREFIX_SIZE, width, cfg.VIS_PREFIX_INIT, cfg.MEAN_INIT,
                        cfg.VAR_INIT).numpy()]


def saved_prompt(cfg, params):
    """The arrays of saved prompt parameters that `initial_prompt` draws."""
    return [params[5], params[7]] if cfg.MODALITY == "multi" else [params[0]]


class RunLog:
    """Collects a training run's epoch and iteration log records from the
    strategy module's logger, which stops propagating meanwhile: one summary
    line per run instead of one per epoch."""

    def __init__(self):
        import logging

        self.epochs, self.iterations, self.fused = [], [], []
        outer = self

        class Handler(logging.Handler):
            def emit(self, record):
                if isinstance(record.msg, str) and record.msg.startswith("epoch %d"):
                    outer.epochs.append(record.args)
                elif isinstance(record.msg, str) and record.msg.startswith("iteration %d/%d"):
                    outer.iterations.append(record.args)
                elif isinstance(record.msg, str) and record.msg.startswith("fused train:"):
                    outer.fused.append(record.args)

        self.handler = Handler(logging.INFO)
        self.logger = logging.getLogger("menghini_neurips23_tpu_torch.training.strategy")

    def __enter__(self):
        import logging

        self.logger.addHandler(self.handler)
        self.logger.setLevel(logging.INFO)
        self.logger.propagate = False
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)
        self.logger.propagate = True


def phase_train(torch, data_dir: str, work: str, paradigm: str, model: str, dtype: str,
                epochs: int, step_quantile=None, schedule=None, encoder: str = "ViT-B/32",
                fused: bool = True, prefix=None, mesh: str = ""):
    """main_<paradigm>.workflow for one prompt MODEL (CoOp, VPT or UPT; one
    run, FPL, or IFPL/GRIP iterations) with its bundled config (N_LABEL 2,
    PREFIX_SIZE 16 or UPT's 4 + 4 tokens, N_PSEUDOSHOTS 16, BATCH_SIZE 16,
    SGD cosine), `epochs` epochs per run, in `dtype`; checks the artifacts
    (every iteration's prompt, pseudolabels and checkpoint manifest), that
    each saved prompt moved from its draw, that the best metric is the best
    iteration's, the GRIP `schedule` of N_PSEUDOSHOTS when given, the
    training rows the paradigm makes and the losses.  `fused` (FUSED_TRAIN,
    the default) runs every training run as the whole-run trainer's CUDA
    graphs, and the run must log one `fused train:` line per training run
    with its graphs captured; False takes the per-step loop (its artifacts
    go to another directory).  `prefix` sets a CoOp or VPT prompt's
    PREFIX_SIZE (its artifacts go to another directory), `mesh` the
    MESH_SHAPE."""
    import importlib

    import numpy as np

    from menghini_neurips23_tpu_torch.checkpoint import run_key
    from menghini_neurips23_tpu_torch.evaluation.persist import load_saved_parameters
    from menghini_neurips23_tpu_torch.runners import common
    from menghini_neurips23_tpu_torch.training import TrainingStrategy

    runner = importlib.import_module(f"{PKG}.runners.main_{paradigm}")
    artifacts = (f"{work}/artifacts_{paradigm}_{model}_{dtype}_{encoder.replace('/', '')}"
                 + ("" if fused else "_per_step") + ("" if prefix is None else f"_L{prefix}"))
    cfg = train_config(data_dir, artifacts, paradigm, model, dtype, epochs, step_quantile,
                       encoder)
    cfg.FUSED_TRAIN = fused
    cfg.MESH_SHAPE = mesh
    if prefix is not None:
        cfg.PREFIX_SIZE = prefix
    method = common.MODEL_DISPATCH[model][1]
    iterative = method in ("fixed_iterative_train", "grip_train")
    n_iter = int(100 / cfg.STEP_QUANTILE) if iterative else 1
    n_pseudo_cfg = cfg.N_PSEUDOSHOTS

    # what the run reports: the epoch and iteration log lines, one pair of
    # CUDA events around every step of the per-step loop, each whole-run
    # trainer's record, the strategy and its best val metric
    events, seen, trained_last, fused_runs = [], {}, [], []
    step, run, train = TrainingStrategy._apply_step, common.run_strategy, TrainingStrategy.train

    def timed_step(self, *a, **k):
        ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev[0].record()
        out = step(self, *a, **k)
        ev[1].record()
        events.append(ev)
        return out

    def recorded_train(self, *a, **k):
        out = train(self, *a, **k)
        # the final epoch's prompt, which the strategy keeps
        trained_last.append(saved_prompt(cfg, self.epoch_parameters()))
        info = self.__dict__.pop("_fused_info", None)
        if info is not None:
            fused_runs.append(info)
        return out

    def recorded_run(strategy, *a):
        seen["strategy"] = strategy
        t0 = time.perf_counter()
        seen["result"] = run(strategy, *a)
        seen["train_s"] = time.perf_counter() - t0
        return seen["result"]

    TrainingStrategy._apply_step, common.run_strategy = timed_step, recorded_run
    TrainingStrategy.train = recorded_train
    try:
        with RunLog() as runlog:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            resp = runner.workflow(cfg.DATASET_DIR, cfg, device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        TrainingStrategy._apply_step, common.run_strategy = step, run
        TrainingStrategy.train = train

    what = (f"train[{paradigm}, {model}, {encoder}{'' if fused else ', per-step loop'}"
            f"{'' if prefix is None else f', PREFIX_SIZE {prefix}'}]")
    enc = cfg.VIS_ENCODER.replace("/", "")
    stem = f"MNIST_{paradigm}_{model}_{enc}_opt_1_spl_500.pickle"
    strategy = seen["strategy"]
    arch = strategy.runtime.arch
    losses = [a[1] for a in runlog.epochs]
    if len(losses) != epochs * n_iter or not all(np.isfinite(losses)):
        fail(f"{what}: {len(losses)} epoch losses for {n_iter} x {epochs} epochs, or not finite")
    if len(fused_runs) != (n_iter if fused else 0) or len(runlog.fused) != len(fused_runs) \
            or not all(r["graphs"] and r["epochs"] == epochs for r in fused_runs):
        fail(f"{what}: {len(fused_runs)} whole-run trainer runs ({len(runlog.fused)} logged, "
             f"graphs {[r['graphs'] for r in fused_runs]}) for {n_iter} training runs with "
             f"FUSED_TRAIN={fused}")
    sched = [a[2] for a in runlog.iterations]
    if iterative and (len(sched) != n_iter or (schedule is not None and sched != schedule)
                      or (method == "fixed_iterative_train" and set(sched) != {n_pseudo_cfg})):
        fail(f"{what}: N_PSEUDOSHOTS by iteration {sched}, expected "
             f"{schedule or [n_pseudo_cfg] * n_iter}")
    # per iteration: its best validation epoch and metric, and its saved
    # and final-epoch prompts against its own draw (re-init n at iteration
    # n; one run: 0).  Epoch 0 trains at lr 0 (the cosine warm-up), so a best
    # epoch of 0 saves the drawn prompt; any other moved it.  The final
    # epoch's prompt always moved.
    best_epochs, best_metrics, moved, last_moved = [], [], [], []
    if len(trained_last) != n_iter:
        fail(f"{what}: {len(trained_last)} training runs for {n_iter} iterations")
    for it in range(n_iter):
        accs = [a[3] for a in runlog.epochs[it * epochs:(it + 1) * epochs]]
        best_epochs.append(int(np.argmax(accs)))
        best_metrics.append(float(max(accs)))
        params = load_saved_parameters(cfg, it + 1 if iterative else None)
        start = initial_prompt(torch, cfg, arch, it + 1 if iterative else 0)
        diff = max(float(np.abs(np.asarray(p) - s).max())
                   for p, s in zip(saved_prompt(cfg, params), start))
        moved.append(diff)
        last_moved.append(max(float(np.abs(p - s).max())
                              for p, s in zip(trained_last[it], start)))
        if last_moved[-1] == 0:
            fail(f"{what}: iteration {it + 1}'s final-epoch prompt never moved from its draw")
        shapes = [np.asarray(p).shape for p in saved_prompt(cfg, params)]
        want = ([(4, arch.transformer_width), (4, arch.vision_width)] if cfg.MODALITY == "multi"
                else [(cfg.PREFIX_SIZE, arch.transformer_width if cfg.MODALITY == "text"
                       else arch.vision_width)])
        if shapes != want or (diff == 0) != (best_epochs[-1] == 0):
            fail(f"{what}: iteration {it + 1} saved a prompt {shapes} (expected {want}) that "
                 f"moved {diff} from its draw, best epoch {best_epochs[-1]}")
    best = int(np.argmax(best_metrics))
    if seen["result"][0] != max(best_metrics):
        fail(f"{what}: best metric {seen['result'][0]} is not the best iteration's "
             f"{best_metrics}")
    final = load_saved_parameters(cfg)
    best_saved = load_saved_parameters(cfg, best + 1) if iterative else final
    if not all(np.array_equal(a, b) for a, b in zip(leaves(final), leaves(best_saved))):
        fail(f"{what}: the saved prompt is not iteration {best + 1}'s, the best")
    if iterative:
        running = np.maximum.accumulate(best_metrics)
        for it in range(n_iter):
            name = f"MNIST_{paradigm}_{model}_{enc}_iter_{it + 1}_opt_1_spl_500.pickle"
            man_path = f"{artifacts}/checkpoints/{run_key(cfg)}/iter_{it + 1}/manifest.json"
            # (the iteration's prompt loaded above)
            if not (os.path.exists(f"{artifacts}/pseudolabels/{name}")
                    and os.path.exists(man_path)):
                fail(f"{what}: iteration {it + 1} lacks its pseudolabels or checkpoint")
            with open(man_path) as f:
                man = json.load(f)
            if (man["iteration"], man["n_pseudoshots"], man["run"]) != (it + 1, sched[it],
                                                                        run_key(cfg)) \
                    or abs(man["best_metric"] - running[it]) > 1e-9:
                fail(f"{what}: checkpoint manifest {man} for iteration {it + 1}")
    with open(f"{artifacts}/results_model_{model}.json") as f:
        rec = json.loads(f.readline())
    with open(f"{artifacts}/evaluation/{stem}", "rb") as f:
        pred = pickle.load(f)
    n_test = N_CLASSES * N_PER_CLASS
    logits = np.asarray(pred["logits"])
    # TRZSL reports unseen and seen accuracy and their harmonic mean
    keys = (("harmonic_mean", "seen_accuracy", "unseen_accuracy") if paradigm == "trzsl"
            else ("accuracy",))
    if rec["model"] != model or not all(k in rec and 0.0 <= rec[k] <= 1.0 for k in keys):
        fail(f"{what}: bad results line {rec}")
    if logits.shape != (n_test, N_CLASSES) or not np.isfinite(logits).all():
        fail(f"{what}: evaluation logits {logits.shape}")
    rows, n_group1 = len(strategy._train_groups), sum(strategy._train_groups)
    extra = {}
    if method != "train":
        # the last iteration's pseudo rows: the 80% carve of its selection.
        # SSL adds the train share of 2 shots per class, TRZSL the seen
        # classes' labeled train split; UL trains on the pseudolabels alone,
        # in the labeled group 0.  One FPL run reads its selection from the
        # pseudolabel cache, an iterative one from its last iteration's file
        # (the training set it saved)
        n_shots = int(cfg.N_LABEL * N_CLASSES * cfg.ratio_train_val)
        if iterative:
            name = f"MNIST_{paradigm}_{model}_{enc}_iter_{n_iter}_opt_1_spl_500.pickle"
            with open(f"{artifacts}/pseudolabels/{name}", "rb") as f:
                n_saved = len(pickle.load(f)["filepaths"])
            ok = rows == n_saved and {
                "ssl": rows - n_group1 == n_shots, "ul": n_group1 == 0,
                "trzsl": 0 < n_group1 < rows}[paradigm]
            extra = {"last_iteration_rows_saved": n_saved}
        else:
            cache = (f"{artifacts}/pseudolabels/MNIST_{enc}_{paradigm}_{model}_{n_pseudo_cfg}"
                     "_pseudolabels_split_500.pickle")
            with open(cache, "rb") as f:
                n_pseudo = len(pickle.load(f)["filepaths"])
            n_train_pseudo = int(n_pseudo * cfg.ratio_train_val)
            ok = {"ssl": (n_group1, rows) == (n_train_pseudo, n_train_pseudo + n_shots),
                  "ul": (n_group1, rows) == (0, n_train_pseudo),
                  "trzsl": n_group1 == n_train_pseudo and rows > n_train_pseudo}[paradigm]
            extra = {"pseudolabels": n_pseudo}
        if not ok:
            fail(f"{what}: {rows} training rows ({n_group1} in the pseudolabel group), "
                 f"{extra}")
        extra["pseudo_val"] = len(strategy.val_unseen_files)
    steps = len(events) + sum(r["epochs"] * r["steps_per_epoch"] for r in fused_runs)
    torch.cuda.synchronize()
    ev_ms = sorted(a.elapsed_time(b) for a, b in events) or [None]
    out = {
        "paradigm": paradigm, "model": model, "encoder": encoder, "dtype": dtype,
        "form": "whole-run trainer (CUDA graphs)" if fused else "per-step loop",
        "epochs": epochs,
        "iterations": n_iter, "n_pseudoshots_by_iteration": sched if iterative else None,
        "prompt": [list(np.asarray(x).shape) for x in saved_prompt(cfg, final)],
        "training_rows": rows, "pseudolabel_group_rows": n_group1,
        "steps": steps, "steps_per_epoch": steps / (epochs * n_iter), "wall_s": wall,
        "train_s": seen["train_s"], "wall_ms_per_step": 1e3 * seen["train_s"] / steps,
        "event_ms_per_step_median": ev_ms[len(ev_ms) // 2], "event_ms_per_step_min": ev_ms[0],
        "captures": sum(r["captured"] for r in fused_runs),
        "capture_s": sum(r["capture_s"] for r in fused_runs if r["captured"]),
        "graph_pool_bytes_max": max((r["pool_bytes"] for r in fused_runs), default=None),
        "graph_launches_k1_k2": (fused_runs[0]["launches_per_step"],
                                 fused_runs[0]["launches_per_epoch_end"]) if fused_runs else None,
        "best_val_metric": seen["result"][0], "best_by_iteration": best_metrics,
        "best_epoch_by_iteration": best_epochs, "saved_prompt_moved": moved,
        "final_epoch_prompt_moved": last_moved,
        "test_result": list(resp), "first_loss": losses[0], "last_loss": losses[-1], **extra,
    }
    log(f"  {what}, {dtype}: " + json.dumps(out, default=float))
    return wall, strategy


def phase_resume(torch, data_dir: str, work: str):
    """Resume on the card: main_ssl grip_textual, bf16, 2 iterations of 3
    epochs, (a) uninterrupted, (b) with MNT_FAIL_AFTER_ITER=1, which must
    raise its fault-injection error after iteration 1, (c) again over (b)'s
    artifacts with RESUME, which must resume at iteration 2.  (c) must give
    (a)'s best metric and iteration-2 pseudolabels, and its final prompt
    must match (a)'s within STEP_PREFIX_TOL (K2 is deterministic: 0 is
    expected)."""
    import logging

    import numpy as np

    from menghini_neurips23_tpu_torch.evaluation.persist import load_saved_parameters
    from menghini_neurips23_tpu_torch.runners import common, main_ssl

    model, results = "grip_textual", {}
    run = common.run_strategy

    def recorded(strategy, *a):
        results[len(results)] = run(strategy, *a)
        return results[len(results) - 1]

    resumed = []

    class ResumeLog(logging.Handler):
        def emit(self, record):
            if isinstance(record.msg, str) and record.msg.startswith("resuming from"):
                resumed.append(record.args[0])

    handler = ResumeLog(logging.INFO)
    strategy_log = logging.getLogger("menghini_neurips23_tpu_torch.training.strategy")
    strategy_log.addHandler(handler)
    common.run_strategy = recorded
    t0 = time.perf_counter()
    try:
        with RunLog():
            cfgs = {}
            for name in ("a", "b", "c"):
                artifacts = f"{work}/artifacts_resume_{'a' if name == 'a' else 'b'}"
                cfgs[name] = cfg = train_config(data_dir, artifacts, "ssl", model, "bfloat16",
                                                3, step_quantile=50)
                if name == "b":
                    os.environ["MNT_FAIL_AFTER_ITER"] = "1"
                try:
                    main_ssl.workflow(cfg.DATASET_DIR, cfg, device="cuda")
                    if name == "b":
                        fail("resume: MNT_FAIL_AFTER_ITER=1 did not stop the run")
                except RuntimeError as e:
                    if name != "b" or "fault injection: MNT_FAIL_AFTER_ITER=1" not in str(e):
                        raise
                finally:
                    os.environ.pop("MNT_FAIL_AFTER_ITER", None)
    finally:
        common.run_strategy = run
        strategy_log.removeHandler(handler)
    wall = time.perf_counter() - t0
    (best_a, _), (best_c, _) = results[0], results[1]
    enc = cfgs["a"].VIS_ENCODER.replace("/", "")
    name = f"MNIST_ssl_{model}_{enc}_iter_2_opt_1_spl_500.pickle"
    with open(f"{cfgs['a'].ARTIFACT_DIR}/pseudolabels/{name}", "rb") as f:
        pl_a = pickle.load(f)
    with open(f"{cfgs['c'].ARTIFACT_DIR}/pseudolabels/{name}", "rb") as f:
        pl_c = pickle.load(f)
    pa, pc = load_saved_parameters(cfgs["a"]), load_saved_parameters(cfgs["c"])
    diff = max(float(np.abs(np.asarray(x) - np.asarray(y)).max()) for x, y in zip(pa, pc))
    rec = {"resumed_at_iteration": [r + 1 for r in resumed], "best_metric": [best_a, best_c],
           "iteration2_pseudolabels_equal": pl_a == pl_c, "final_prompt_max_abs_diff": diff,
           "wall_s": wall}
    log("  resume (main_ssl grip_textual bf16, a / cut after 1 / resumed): " + json.dumps(rec))
    if not (resumed == [1] and best_a == best_c and pl_a == pl_c and diff <= STEP_PREFIX_TOL):
        fail(f"resume: the resumed run differs from the uninterrupted one: {rec}")
    return wall


def phase_refresh_profile(torch, strategy, data_dir: str):
    """One GRIP refresh (`get_pseudo_labels`) of the trained grip_visual
    strategy over the 640-image train pool, on the host clock, split into
    the frozen tokens (decode, from the decode cache after the run's earlier
    refreshes, and the patch embedding), the prompted vision tower and the
    leaderboard; and the host decode of the pool alone, uncached."""
    from menghini_neurips23_tpu_torch.data import dataset_object
    from menghini_neurips23_tpu_torch.data.loader import ImageLoader
    from menghini_neurips23_tpu_torch.training import strategy as strategy_mod

    with open(f"{data_dir}/MNIST/train.txt") as f:
        files = [f"train/{l.split()[0]}" for l in f if l.strip()]
    pool = dataset_object("MNIST")(files, f"{data_dir}/MNIST", train=True, labels=None,
                                   label_map=strategy.label_to_idx)
    spent = {"tokens": 0.0, "scoring": 0.0, "leaderboard": 0.0}
    feats, predict, board = (strategy._features_for_paths, strategy._predict_logits,
                             strategy_mod.compute_pseudo_labels)

    def timed(key, fn):
        def wrapped(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spent[key] += time.perf_counter() - t0
            return out
        return wrapped

    strategy._features_for_paths = timed("tokens", feats)
    strategy._predict_logits = timed("scoring", predict)
    strategy_mod.compute_pseudo_labels = timed("leaderboard", board)
    try:
        strategy._img_feats_memo = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = strategy.get_pseudo_labels(pool)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        del strategy._features_for_paths, strategy._predict_logits
        strategy_mod.compute_pseudo_labels = board
    t0 = time.perf_counter()
    ImageLoader(RES).load_all([f"{data_dir}/MNIST/{p}" for p in files])
    decode = time.perf_counter() - t0
    rec = {"pool": len(files), "n_pseudoshots": strategy.config.N_PSEUDOSHOTS,
           "selected": len(out.filepaths), "wall_s": wall,
           "frozen_tokens_s": spent["tokens"],
           "prompted_tower_s": spent["scoring"] - spent["tokens"],
           "leaderboard_s": spent["leaderboard"],
           "rest_s": wall - spent["scoring"] - spent["leaderboard"],
           "decode_uncached_s": decode}
    log("  GRIP refresh (grip_visual, bf16): " + json.dumps(rec))
    if not 0 < len(out.filepaths) <= len(files):
        fail(f"GRIP refresh selected {len(out.filepaths)} of {len(files)}")


def phase_step_profile(torch, strategy, files, n: int = 20):
    """Where one training step's time goes: `n` steps of the trained strategy
    (lr 0, a fixed batch of the first 16 of `files`) timed on the host clock
    alone, with the peak device memory they allocate, then again under
    torch.profiler for the device's busy time and the kernels by name."""
    from torch.profiler import ProfilerActivity, profile

    dev = strategy.device
    n_cls = len(strategy.classes)
    ctx = strategy._class_context(strategy.classes)
    # the frozen representation of 16 images: image features for CoOp, the
    # pos-embedded patch tokens for VPT
    feats = torch.tensor(strategy._features_for_paths(files[:16]), device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    labels = torch.randint(0, n_cls, (16,), generator=g, device=dev).int()
    group = (torch.arange(16, device=dev) % 2).int()
    valid = torch.ones(16, device=dev)

    def steps():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            strategy._apply_step(ctx, 0.0, feats, labels, group, valid)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    steps()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    wall_ms = steps()
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prof_wall_ms = steps()
    kernels, launched, _ = profiled_kernels(prof, n)
    busy = sum(kernels.values())
    k2 = sum(ms for name, ms in kernels.items() if "attention_bwd" in name)
    out = {
        "model": strategy.config.MODEL, "encoder": strategy.config.VIS_ENCODER,
        "dtype": strategy.config.COMPUTE_DTYPE,
        "class_context": list(ctx.shape), "batch": list(feats.shape), "steps": n,
        "wall_ms_per_step": wall_ms, "resident_bytes": resident,
        "peak_allocated_bytes": peak,
        "profiled_wall_ms_per_step": prof_wall_ms,
        "device_ops_per_step": launched if kernels else None,
        "device_busy_ms_per_step": busy if kernels else None,
        # the busy time against the wall without the profiler's overhead
        "device_idle_share": 1 - busy / wall_ms if kernels else None,
        # K2's kernels (every launch of attention_bwd.cu), by the same sums
        "attention_bwd_ms_per_step": k2 if kernels else None,
        "attention_bwd_share_of_busy": k2 / busy if kernels else None,
        "top_kernels_ms_per_step": dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:8]),
    }
    log("  training step profile: " + json.dumps(out))
    return out


def profiled_kernels(prof, n: int):
    """Device-side events of a torch.profiler run (a CPU op's entry repeats
    its kernels' time): ms per unit of `n` summed by the first 70 characters
    of the kernel's name, the device ops per unit, and the count of each
    name over the whole run."""
    from torch.autograd import DeviceType

    kernels, counts, launched = {}, {}, 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            kernels[e.key[:70]] = kernels.get(e.key[:70], 0.0) + us / 1e3 / n
            counts[e.key[:70]] = counts.get(e.key[:70], 0) + e.count
            launched += e.count
    return kernels, launched / n, counts


def phase_fused_profile(torch, strategy, files, per_step, epochs: int = 10):
    """The whole-run trainer on the trained strategy: `epochs` epochs over
    the first 160 of `files` (10 batches of 16) validating on the next 32
    (and the strategy's pseudo-val rows), three times - once to capture its
    graphs, once on the host clock (ms per step = the run's wall / its
    steps, epoch ends included), once under torch.profiler (device busy
    time, idle share against the unprofiled wall) - beside `per_step`, the
    per-step loop's numbers from phase_step_profile on the same strategy.
    The profiled run's K1 and K2 kernels, as the profiler sees them, must
    number what the wrappers' counters add for it (captured x replays; in
    bf16 every counted launch is one kernel, but a K2 call above 320 tokens
    two), within the profiler's drops."""
    import copy

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from menghini_neurips23_tpu_torch.ops.attention import attention_bwd, fused_attention

    cfg = strategy.config
    saved = cfg.EPOCHS, cfg.FUSED_TRAIN, cfg.FUSED_EPOCH_CHUNK
    cfg.EPOCHS, cfg.FUSED_TRAIN, cfg.FUSED_EPOCH_CHUNK = epochs, True, 0
    labels = np.random.default_rng(0).choice(
        [strategy.label_to_idx[c] for c in strategy.classes], 192)
    train, val = Rows(files[:160], labels[:160]), Rows(files[160:192], labels[160:192])

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        strategy.train(copy.deepcopy(train), copy.deepcopy(val))
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    strategy._fused_keep = True  # the graphs of the first run serve the next two
    try:
        first_s = run()
        info = dict(strategy._fused_info)
        wall_s = run()
        c0 = [fused_attention.launches, attention_bwd.launches, attention_bwd.streamed_launches]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            prof_s = run()
        counted = [fused_attention.launches - c0[0], attention_bwd.launches - c0[1]]
        # a streamed K2 call (T > 320) is two kernels, the query and key sides
        kernels_counted = [counted[0], counted[1] + attention_bwd.streamed_launches - c0[2]]
    finally:
        strategy._fused_keep = False
        strategy._fused_free()
        cfg.EPOCHS, cfg.FUSED_TRAIN, cfg.FUSED_EPOCH_CHUNK = saved
    steps = epochs * info["steps_per_epoch"]
    kernels, ops, counts = profiled_kernels(prof, steps)
    busy = sum(kernels.values())
    wall_ms = wall_s * 1e3 / steps
    seen = [sum(c for k, c in counts.items() if name in k)
            for name in ("attention_fwd", "attention_bwd")]
    replays = [epochs * (info["steps_per_epoch"] * s + e)
               for s, e in zip(info["launches_per_step"], info["launches_per_epoch_end"])]
    out = {
        "model": cfg.MODEL, "encoder": cfg.VIS_ENCODER, "dtype": cfg.COMPUTE_DTYPE,
        "classes": len(strategy.classes), "epochs": epochs,
        "steps_per_epoch": info["steps_per_epoch"], "first_run_s": first_s,
        "capture_s": info["capture_s"], "graph_pool_bytes": info["pool_bytes"],
        "run_s": wall_s, "wall_ms_per_step": wall_ms,
        "profiled_wall_ms_per_step": prof_s * 1e3 / steps,
        "device_ops_per_step": ops if kernels else None,
        "device_busy_ms_per_step": busy if kernels else None,
        "device_idle_share": 1 - busy / wall_ms if kernels else None,
        "k1_k2_profiled": seen, "k1_k2_counted": counted,
        "k1_k2_kernels_counted": kernels_counted, "k1_k2_captured_x_replays": replays,
        "per_step_loop": {k: per_step[k] for k in (
            "wall_ms_per_step", "device_busy_ms_per_step", "device_idle_share",
            "device_ops_per_step")},
        "top_kernels_ms_per_step": dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:6]),
    }
    log("  whole-run trainer profile: " + json.dumps(out))
    if not (info["graphs"] and info["captured"] and np.isfinite(info["stats"]).all()):
        fail(f"whole-run trainer profile: no graphs, or non-finite stats: {info}")
    # the profiler can drop a few of the graphs' kernel records (1,308 of
    # 1,320 K1 launches have been seen): it may see fewer, down to 98%,
    # never more
    if kernels and cfg.COMPUTE_DTYPE == "bfloat16" and not all(
            0.98 * c <= n <= c for n, c in zip(seen, kernels_counted)):
        fail(f"whole-run trainer profile: the profiler saw {seen} K1/K2 kernels where the "
             f"counters added {kernels_counted}")


# ---------------------------------------------------------------- phase 9
def fused_step_wall(torch, strategy, files, epochs: int = 10, profiled: bool = False):
    """The whole-run trainer on a trained strategy: `epochs` epochs over the
    first 160 of `files` (10 batches of 16), validating on the next 32,
    twice (the first run captures, the second is timed on the host clock)
    and, `profiled`, a third time under torch.profiler.  Returns the second
    run's wall ms per step (epoch ends included), the step replays, the
    all-reduces the step graph captured, and the profiled run's all-reduces
    (captured x replays) and NCCL kernels by name."""
    import copy

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    cfg = strategy.config
    saved = cfg.EPOCHS, cfg.FUSED_TRAIN, cfg.FUSED_EPOCH_CHUNK
    cfg.EPOCHS, cfg.FUSED_TRAIN, cfg.FUSED_EPOCH_CHUNK = epochs, True, 0
    labels = np.random.default_rng(0).choice(
        [strategy.label_to_idx[c] for c in strategy.classes], 192)
    train, val = Rows(files[:160], labels[:160]), Rows(files[160:192], labels[160:192])

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        strategy.train(copy.deepcopy(train), copy.deepcopy(val))
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    from menghini_neurips23_tpu_torch.parallel import multihost

    strategy._fused_keep = True  # the graphs of the first run serve the next ones
    nccl = calls = None
    try:
        run()
        info = dict(strategy._fused_info)
        wall_s = run()
        if profiled:
            c0 = multihost.all_reduce_sum_.calls
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                run()
            calls = multihost.all_reduce_sum_.calls - c0
            nccl = {k: c for k, c in profiled_kernels(prof, 1)[2].items()
                    if "nccl" in k.lower()}
    finally:
        strategy._fused_keep = False
        strategy._fused_free()
        cfg.EPOCHS, cfg.FUSED_TRAIN, cfg.FUSED_EPOCH_CHUNK = saved
    steps = epochs * info["steps_per_epoch"]
    return {"wall_ms_per_step": wall_s * 1e3 / steps, "step_replays": steps,
            "graphs": info["graphs"], "stats": info["stats"],
            "all_reduces_per_step_graph": info["all_reduces_per_step"],
            "all_reduces_counted": calls, "nccl_kernels": nccl}


def _artifact_files(root: str):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs if "checkpoints" not in d)


def phase_distributed(torch, data_dir: str, work: str, files):
    """Data parallelism on the card through NCCL, at world size 1: the card
    is one GPU, and NCCL refuses two ranks on one device.  main_ssl
    textual_fpl and visual_fpl (bf16, 10 epochs, ViT-B/32 width) run
    through the whole-run trainer without a process group, then again in a
    one-rank NCCL group (a file:// store in the work directory), where the
    frozen passes gather their rows through NCCL and every training step's
    graph holds the gradient all-reduce, and once more in the group with
    MESH_SHAPE "1,1" (the (data, model) layout of parallel/mesh.py with a
    model axis of one).  The runs' artifacts must be the same bits, their
    K1/K2 launches the same; each trained strategy's step is timed with and
    without the collective (not again under "1,1"), and the profiler counts
    the NCCL kernels of the group's step-graph replays."""
    import numpy as np
    import torch.distributed as dist

    from menghini_neurips23_tpu_torch.ops.attention import attention_bwd, fused_attention
    from menghini_neurips23_tpu_torch.parallel import multihost

    log("  NCCL is recorded at world size 1 only: this machine's card is one GPU, and NCCL "
        "refuses two ranks on one device; no run here has two ranks")
    runs = (("ssl", "textual_fpl"), ("ssl", "visual_fpl"))
    # (form, its work directory, MESH_SHAPE)
    forms = (("no group", "dist_none", ""), ("NCCL group", "dist_nccl", ""),
             ("NCCL group, MESH_SHAPE 1,1", "dist_mesh", "1,1"))
    results = {}
    for form, sub, mesh in forms:
        if form != "no group":
            store = f"{work}/nccl_store"
            if os.path.exists(store):
                os.remove(store)
            dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                                    world_size=1, device_id=torch.device("cuda", 0))
        try:
            if form != "no group":
                multihost.warm_collectives()
            for paradigm, model in runs:
                c0 = (fused_attention.launches, attention_bwd.launches)
                wall, strategy = phase_train(torch, data_dir, f"{work}/{sub}", paradigm, model,
                                             "bfloat16", 10, mesh=mesh)
                launched = [fused_attention.launches - c0[0], attention_bwd.launches - c0[1]]
                art = f"{work}/{sub}/artifacts_{paradigm}_{model}_bfloat16_ViT-B32"
                timing = None if mesh else fused_step_wall(
                    torch, strategy, files, profiled=form == "NCCL group")
                results[(form, model)] = (wall, launched, art, timing)
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()

    def differing(aa, ab):
        differ = []
        for rel in _artifact_files(aa):
            with open(os.path.join(aa, rel), "rb") as f:
                a = f.read()
            with open(os.path.join(ab, rel), "rb") as f:
                b = f.read()
            if rel.startswith("results_model_"):  # its config names the directory
                a, b = ({k: v for k, v in json.loads(x).items() if k != "config"}
                        for x in (a, b))
            if a != b:
                differ.append(rel)
        return differ

    for _, model in runs:
        # the "1,1" mesh's run: the same artifacts, bit for bit, and launches
        (_, lb, ab, _), (wm, lm, am, _) = (results[("NCCL group", model)],
                                           results[("NCCL group, MESH_SHAPE 1,1", model)])
        rec = {"model": model, "mesh": "1,1", "artifacts": len(_artifact_files(am)),
               "artifacts_differ": differing(ab, am) if _artifact_files(ab) == _artifact_files(am)
               else "names differ", "k1_k2_launches": lm, "run_wall_s": wm}
        log("  distributed, NCCL world size 1, MESH_SHAPE 1,1 vs the group without it: "
            + json.dumps(rec))
        if rec["artifacts_differ"] or lm != lb:
            fail(f"distributed: MESH_SHAPE 1,1 changed the group's run: {rec}")
    for _, model in runs:
        (wa, la, aa, ta), (wb, lb, ab, tb) = results[("no group", model)],             results[("NCCL group", model)]
        files_a, files_b = _artifact_files(aa), _artifact_files(ab)
        differ = differing(aa, ab) if files_a == files_b else []
        nccl = tb["nccl_kernels"] or {}
        allreduce = sum(c for k, c in nccl.items() if "allreduce" in k.lower())
        rec = {"model": model, "artifacts": len(files_a), "artifacts_differ": differ,
               "k1_k2_launches": {"no_group": la, "nccl_group": lb},
               "run_wall_s": {"no_group": wa, "nccl_group": wb},
               "step_wall_ms": {"no_group": ta["wall_ms_per_step"],
                                "nccl_group": tb["wall_ms_per_step"]},
               "step_wall_ratio": tb["wall_ms_per_step"] / ta["wall_ms_per_step"],
               "step_replays_profiled": tb["step_replays"],
               "all_reduces_per_step_graph": {"no_group": ta["all_reduces_per_step_graph"],
                                              "nccl_group": tb["all_reduces_per_step_graph"]},
               "all_reduces_in_profiled_replays": tb["all_reduces_counted"],
               "nccl_allreduce_kernels_profiled": allreduce, "nccl_kernels_profiled": nccl,
               "stats_equal": bool(np.array_equal(ta["stats"], tb["stats"]))}
        log("  distributed, NCCL world size 1 vs no group: " + json.dumps(rec))
        if files_a != files_b or differ or la != lb or not rec["stats_equal"]:
            fail(f"distributed: the NCCL group's run is not the run without a group: {rec}")
        if not (ta["graphs"] and tb["graphs"]):
            fail(f"distributed: a run took no graphs: {rec}")
        # one all-reduce in every step graph (none without a group), so one a
        # replay; NCCL turns a one-rank in-place sum into no device work, so
        # the profiler sees no NCCL kernel for it (scripts/nccl_group_check.py
        # counts them across four cards)
        if (ta["all_reduces_per_step_graph"], tb["all_reduces_per_step_graph"]) != (0, 1) \
                or tb["all_reduces_counted"] != tb["step_replays"]:
            fail(f"distributed: not one all-reduce per step-graph replay: {rec}")
        if allreduce > tb["step_replays"]:
            fail(f"distributed: more NCCL all-reduce kernels than step replays: {rec}")
    return results


# ---------------------------------------------------------------- phase 8
def phase_breakdown(torch, data_dir: str, work: str):
    """Where a main_clip run's wall time goes (bf16), measured apart from the
    counted main path: runtime set-up, the host's decode of the 640 test
    PNGs alone, the device's encode of one decoded 256-image batch alone,
    and the prefetching pass that overlaps decode with the device; then the
    same batch's device encode by ViT-L/14's vision tower (T = 257), with
    K1's share of it under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from menghini_neurips23_tpu_torch.data.loader import ImageLoader
    from menghini_neurips23_tpu_torch.runtime import ClipRuntime

    with open(f"{data_dir}/MNIST/test.txt") as f:
        files = [f"{data_dir}/MNIST/test/{l.split()[0]}" for l in f if l.strip()]
    cfg = _config(data_dir, f"{work}/artifacts_breakdown", "bfloat16")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rt = ClipRuntime(cfg, device="cuda")
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    feats = rt.encode_images_from_files(files, batch_size=256)
    pass_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    arr = ImageLoader(RES).load_all(files)
    decode = time.perf_counter() - t0
    batch = torch.from_numpy(arr[:256]).cuda()
    with torch.inference_mode():
        enc_ms = eager_ms(torch, lambda: rt._encode_images(batch), reps=10)
    device_s = len(files) / 256 * enc_ms / 1e3
    out = {
        "setup_s": setup, "decode_640_s": decode, "encode_256_ms": enc_ms,
        "pass_640_s": pass_s, "pass_img_per_s": len(files) / pass_s,
        "device_share_of_pass": device_s / pass_s, "features": list(feats.shape),
    }
    log("  breakdown (bf16): " + json.dumps(out))
    del rt
    rt = ClipRuntime(_config(data_dir, f"{work}/artifacts_breakdown", "bfloat16",
                             encoder="ViT-L/14"), device="cuda")
    with torch.inference_mode():
        enc_ms = eager_ms(torch, lambda: rt._encode_images(batch), reps=5)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                rt._encode_images(batch)
            torch.cuda.synchronize()
    kernels, ops, _ = profiled_kernels(prof, 5)
    k1 = sum(ms for name, ms in kernels.items() if "attention_fwd" in name)
    out = {"encoder": "ViT-L/14", "T": 1 + rt.arch.num_patches, "encode_256_ms": enc_ms,
           "device_busy_ms": sum(kernels.values()), "device_ops": ops, "k1_ms": k1,
           "k1_share": k1 / sum(kernels.values())}
    log("  breakdown (bf16), device encode of the same 256 images: " + json.dumps(out))
    del rt
    torch.cuda.empty_cache()


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, PKG)):
        print(f"chip_smoke.py: {PKG}/ not found beside this script; run it from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    t_start = time.perf_counter()
    import torch

    from menghini_neurips23_tpu_torch.ops.attention import attention_bwd, fused_attention
    from menghini_neurips23_tpu_torch.ops.clip_head import fused_probs
    from menghini_neurips23_tpu_torch.ops.twophase_attention import twophase_attention

    log("[1] device")
    phase_device(torch)
    log("[2] build")
    phase_build()
    log("[3] kernels vs plain versions")
    attn_cases, head_cases = phase_kernels(torch)
    bwd_cases = phase_kernels_bwd(torch)
    twophase_cases = phase_kernels_twophase(torch)
    block_cases = phase_sharded_block(torch)
    phase_device_topk(torch)
    phase_model_reference(torch)
    runtimes = step_runtimes(torch)
    phase_one_step(torch, runtimes)
    phase_one_vpt_step(torch, runtimes)
    phase_one_upt_step(torch, runtimes)
    phase_fused_forms(torch, runtimes)
    # ViT-L/14 at full width, 2 rows: VPT at T = 273 and UPT at T = 261 take
    # K2 above 128 tokens on the card
    runtimes = step_runtimes(torch, "ViT-L/14")
    phase_one_vpt_step(torch, runtimes, rows=2)
    phase_one_upt_step(torch, runtimes, rows=2)
    # and VPT with an 80-token prompt, T = 337: K1 and K2 stream K and V
    phase_one_vpt_step(torch, runtimes, rows=2, prefix=VPT_LONG_PREFIX)
    del runtimes
    torch.cuda.empty_cache()

    work = os.path.join(ROOT, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    data_dir = f"{work}/data"
    t0 = time.perf_counter()
    classes = make_dataset(f"{data_dir}/MNIST")
    log(f"[4] main path: dataset of {len(classes)} classes x {N_PER_CLASS} train + "
        f"{N_PER_CLASS} test {RES}px PNGs written in {time.perf_counter() - t0:.2f} s")

    # (wrapper, counter) of each kernel; the streamed forms of K1 and K2
    # and K1's resident bf16 form (129 to 320 tokens) count apart as well
    wrappers = {"attention_fwd": (fused_attention, "launches"),
                "attention_bwd": (attention_bwd, "launches"),
                "clip_head": (fused_probs, "launches"),
                "attention_fwd_resident": (fused_attention, "resident_launches"),
                "attention_fwd_streamed": (fused_attention, "streamed_launches"),
                "attention_bwd_streamed": (attention_bwd, "streamed_launches"),
                "twophase_attention": (twophase_attention, "launches")}
    resident = ("attention_fwd", "attention_bwd", "clip_head")
    # K4 runs on no path of the models (nor does its Pallas kernel on the
    # JAX package's): its own path is the attention experiment
    model_kernels = tuple(n for n in wrappers if n != "twophase_attention")
    # each main path runs with every count set to 0 just before it and read
    # just after; a kernel the path runs must show at least one launch
    by_path = {}

    def counted(path: str, needs, run):
        for w, c in wrappers.values():
            setattr(w, c, 0)
        run()
        by_path[path] = {name: getattr(w, c) for name, (w, c) in wrappers.items()}
        log(f"  launches on the {path} path: {json.dumps(by_path[path])}")
        for name in needs:
            if by_path[path][name] <= 0:
                fail(f"kernel {name} was not launched on the {path} path")

    walls, trained = {}, {}

    def zero_shot_path():
        for dtype in ("float32", "bfloat16"):
            walls[f"main_clip_{dtype}"] = phase_main_clip(torch, data_dir, work, dtype)
        log("[5] pseudolabels")
        walls["pseudolabels"] = phase_pseudolabels(torch, data_dir, work)
        log("[6] serving")
        walls["serving"] = phase_serving(torch, data_dir, work)

    def training_runs(runs, resume=False, encoder="ViT-B/32"):
        # ViT-B/32 runs keep their keys; other encoders' carry their name
        at = "" if encoder == "ViT-B/32" else f"@{encoder}"

        def run():
            for paradigm, model, dtype, epochs, *iterative in runs:
                walls[f"{paradigm}_{model}_{dtype}{at}"], trained[f"{paradigm}_{model}{at}"] = \
                    phase_train(torch, data_dir, work, paradigm, model, dtype, epochs, *iterative,
                                encoder=encoder)
            if resume:
                walls["resume_check"] = phase_resume(torch, data_dir, work)
        return run

    log("[3] the attention experiment (scripts/exp_attn_kernels.py twophase fwd)")
    counted("attention experiment (twophase fwd)", ("twophase_attention",),
            lambda: phase_experiment(torch))
    counted("zero-shot", ("attention_fwd", "clip_head"), zero_shot_path)
    log("[7] training (SSL CoOp)")
    counted("training (SSL CoOp)", resident, training_runs(
        [("ssl", "textual_prompt", "float32", 20), ("ssl", "textual_fpl", "bfloat16", 150)]))
    log("[7] training (UL/TRZSL, VPT)")
    counted("training (UL/TRZSL, VPT)", resident, training_runs(
        [("ul", "visual_fpl", "bfloat16", 150), ("trzsl", "visual_fpl", "float32", 20)]))
    log("[7] training (IFPL/GRIP, UPT)")
    counted("training (IFPL/GRIP, UPT)", resident, training_runs(
        [("ul", "grip_visual", "bfloat16", 5, 10, GRIP_SCHEDULE),
         ("ssl", "grip_multimodal", "bfloat16", 5, 25),
         ("trzsl", "iterative_textual_fpl", "float32", 5, 50),
         ("ssl", "multimodal_fpl", "float32", 20)], resume=True))
    log("[7] ViT-L/14 (zero-shot, UL VPT, SSL UPT)")

    def vit_l14_path():
        walls["main_clip_bfloat16@ViT-L/14"] = phase_main_clip(
            torch, data_dir, work, "bfloat16", encoder="ViT-L/14")
        training_runs([("ul", "visual_fpl", "bfloat16", 5),
                       ("ssl", "multimodal_fpl", "bfloat16", 5)], encoder="ViT-L/14")()

    # full ViT-L/14 width and depth (24 + 12 layers), bf16, the training
    # runs cut to 5 epochs: VPT's vision tower at T = 273, UPT's at 261
    counted("ViT-L/14", resident + ("attention_fwd_resident",), vit_l14_path)
    log("[7] ViT-L/14 VPT with an 80-token prompt (T = 337)")
    # main_ul visual_fpl bf16, 3 epochs: every step and the prompted
    # evaluation stream K and V (the zero-shot pass, T = 257, does not)
    def vit_l14_long_prompt():
        key = "ul_visual_fpl_bfloat16@ViT-L/14-L80"
        walls[key], trained[key] = phase_train(
            torch, data_dir, work, "ul", "visual_fpl", "bfloat16", 3, encoder="ViT-L/14",
            prefix=VPT_LONG_PREFIX)

    counted("ViT-L/14, 80-token VPT prompt",
            tuple(n for n in model_kernels if n != "attention_fwd_resident"), vit_l14_long_prompt)
    with open(f"{data_dir}/MNIST/train.txt") as f:
        train_files = [f"{data_dir}/MNIST/train/{l.split()[0]}" for l in f if l.strip()]
    log("[9] distributed (NCCL, world size 1)")
    counted("distributed (NCCL, world size 1)", resident,
            lambda: phase_distributed(torch, data_dir, work, train_files))
    launches = {name: sum(c[name] for c in by_path.values()) for name in wrappers}
    log("phase wall seconds: " + json.dumps({k: round(v, 3) for k, v in walls.items()}))
    log("[8] breakdown")
    phase_breakdown(torch, data_dir, work)
    fpl = trained["ssl_textual_fpl"]
    # the same step over Flowers102's 102 class prompts (the paper's widest
    # class list), on the same runtime
    from menghini_neurips23_tpu_torch.data import get_class_names
    from menghini_neurips23_tpu_torch.training import TextualStrategy

    flowers = get_class_names("Flowers102", data_dir, 500)[0]
    # each step profiled in the per-step loop, then in the whole-run trainer:
    # CoOp at 10 and 102 classes; one bf16 VPT step (the vision tower over
    # 16 x 66 tokens, forward and backward to the prefix); one bf16 UPT step
    # (the mixer, the text tower over 10 x 77 tokens and the vision tower
    # over 16 x 54); the same VPT and UPT steps at ViT-L/14 (16 x 273 and
    # 16 x 261 vision tokens through 24 layers), and VPT with the 80-token
    # prompt (16 x 337, K1 and K2 streamed)
    for strategy in (fpl, TextualStrategy(
            fpl.config, {c: i for i, c in enumerate(flowers)}, flowers, flowers, flowers,
            runtime=fpl.runtime), trained["ul_visual_fpl"], trained["ssl_grip_multimodal"],
            trained["ul_visual_fpl@ViT-L/14"], trained["ssl_multimodal_fpl@ViT-L/14"],
            trained["ul_visual_fpl_bfloat16@ViT-L/14-L80"]):
        phase_fused_profile(torch, strategy, train_files,
                            phase_step_profile(torch, strategy, train_files))
    phase_refresh_profile(torch, trained["ul_grip_visual"], data_dir)
    log("[8] run walls: the per-step loop (FUSED_TRAIN off) beside the whole-run trainer")
    for paradigm, model, dtype, epochs, *iterative in (
            ("ssl", "textual_fpl", "bfloat16", 150), ("ul", "visual_fpl", "bfloat16", 150),
            ("ul", "grip_visual", "bfloat16", 5, 10, GRIP_SCHEDULE)):
        key = f"{paradigm}_{model}_{dtype}"
        wall, _ = phase_train(torch, data_dir, work, paradigm, model, dtype, epochs, *iterative,
                              fused=False)
        log("  run wall: " + json.dumps({"run": key, "whole_run_trainer_s": walls[key],
                                         "per_step_loop_s": wall,
                                         "per_step_over_whole_run": wall / walls[key]}))

    def entry(name, source, replaces, cases, headline):
        h = next(c for c in cases if headline(c))
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name],
            "launches_by_path": {path: c[name] for path, c in by_path.items()},
            "max_abs_err": h["max_abs_err"], "ms": h["ms"],
            "plain_ms": h["plain_ms"], "bound_ms": h["bound_ms"], "bound_by": h["bound_by"],
            "library_ms": h["library_ms"], "shape": h["shape"], "dtype": h["dtype"],
            "cases": cases,
        }

    short_fwd = [c for c in attn_cases if not c["streamed"] and not c["resident"]]
    short_bwd = [c for c in bwd_cases if not c["streamed"]]
    kernels = [
        entry("attention_fwd", f"{PKG}/csrc/attention_fwd.cu",
              "menghini_neurips23_tpu/ops/attention.py:65", short_fwd,
              lambda c: c["shape"] == [256, 50, 768, 12] and c["dtype"] == "bfloat16"),
        entry("attention_bwd", f"{PKG}/csrc/attention_bwd.cu",
              "menghini_neurips23_tpu/ops/attention.py:96", short_bwd,
              lambda c: c["shape"] == [10, 24, 512, 8] and c["dtype"] == "bfloat16"),
        # K1's resident bf16 form (129 to 320 tokens), headlined at ViT-L/14
        # with a 16-token VPT prompt (T = 273)
        entry("attention_fwd_resident", f"{PKG}/csrc/attention_fwd.cu",
              "menghini_neurips23_tpu/ops/attention.py:65",
              [c for c in attn_cases if c["resident"]],
              lambda c: c["shape"] == [16, 273, 1024, 16] and c["dtype"] == "bfloat16"),
        # the streamed forms (K1: bf16 past 320 tokens, fp32 past 128; K2
        # past 320), headlined at ViT-L/14 with an 80-token VPT prompt (T =
        # 337, bf16)
        entry("attention_fwd_streamed", f"{PKG}/csrc/attention_fwd.cu",
              "menghini_neurips23_tpu/ops/attention.py:65",
              [c for c in attn_cases if c["streamed"]],
              lambda c: c["shape"] == [16, 337, 1024, 16] and c["dtype"] == "bfloat16"),
        entry("attention_bwd_streamed", f"{PKG}/csrc/attention_bwd.cu",
              "menghini_neurips23_tpu/ops/attention.py:96",
              [c for c in bwd_cases if c["streamed"]],
              lambda c: c["shape"] == [16, 337, 1024, 16] and c["dtype"] == "bfloat16"),
        entry("clip_head", f"{PKG}/csrc/clip_head.cu",
              "menghini_neurips23_tpu/ops/clip_head.py:40", head_cases,
              lambda c: c["shape"] == [640, 512, 10] and c["dtype"] == "float32"),
        # the attention experiment's kernel, headlined at its own shape
        entry("twophase_attention", f"{PKG}/csrc/twophase_attention.cu",
              "benchmarks/exp_attn_kernels.py:58", twophase_cases,
              lambda c: c["shape"] == [256, 66, 768, 12] and c["dtype"] == "bfloat16"),
    ]
    for k in kernels[:2]:  # K1 and K2 inside the m = 2 sharded block
        k["sharded_block"] = block_cases
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "menghini_neurips23_tpu"))
    if leaked:
        fail(f"the port imported JAX or the JAX package: {leaked[:5]}")
    log(f"smoke wall {time.perf_counter() - t_start:.1f} s (kernel builds included)")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
