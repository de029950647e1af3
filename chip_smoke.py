#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (menghini_neurips23_tpu_torch) on one
NVIDIA GPU: builds the port's CUDA kernels from csrc/, holds each against its
plain PyTorch version at the main path's shapes, then drives the zero-shot /
pseudolabel path end to end at ViT-B/32's full width (random weights from a
seed), the SSL CoOp prompt training (textual_prompt, textual_fpl) and the
UL and TRZSL visual prompt training (visual_fpl), and checks what they write.

    python3 chip_smoke.py            # from the repository root; needs one card

Phases (one or more lines each; any failure raises and exits non-zero):
  1. device: the card's name and power limit, torch/CUDA/nvcc/Triton
     versions, which optional host packages import, whether the native image
     loader builds; fails when torch sees no card
  2. build: compiles every kernel (one nvcc per source, all at once) and
     prints ptxas's register report; fails if any entry point spills
     registers
  3. kernels: each kernel against its plain version on the card, fp32 and
     bf16, at the main path's shapes (K1 also at ViT-L/14's, K3 also at
     pseudolabel pools of 65,536 rows), with CUDA-event
     times of the kernel, the plain version and, for attention,
     scaled_dot_product_attention as a yardstick (forward alone; forward +
     backward through autograd beside the K1 + K2 pair - the port never
     calls it), and bound_share = bound_ms / ms; the FusedAttention
     gradient against autograd of the plain forward; a full-width ViT-B/32
     forward on the card against the same weights on the CPU; one CoOp
     training step and one deep VPT training step at ViT-B/32 width on the
     card against the same step on the CPU
  4. main path: main_clip.workflow on a synthetic 10-class MNIST-layout
     dataset (224x224 PNGs, 64 train + 64 test per class), BATCH_SIZE 256,
     in float32 and in bfloat16
  5. pseudolabels: FPL top-16 per class over the 640-image train pool
  6. serving: predict.main over the 640 test images, top 5
  7. training: main_ssl.workflow, MODEL=textual_prompt in float32 for 20
     epochs and MODEL=textual_fpl in bfloat16 for the paper's 150 epochs;
     then main_ul.workflow, MODEL=visual_fpl in bfloat16 for 150 epochs, and
     main_trzsl.workflow, MODEL=visual_fpl in float32 for 20 epochs; the
     bundled configs (BATCH_SIZE 16), on the same dataset
  8. breakdown: set-up, host decode and device encode of the bf16 pass,
     each timed alone; one bf16 training step of textual_fpl (10 and 102
     classes) and of visual_fpl on the host clock and under torch.profiler
     (device busy time, kernels by name)
Phases 4-6 (the zero-shot path), the SSL CoOp runs and the UL/TRZSL VPT
runs of phase 7 (two training paths) each run with every launch count set
to 0 just before and read just after; a kernel the path runs must show a
launch.  Then one JSON line listing each kernel with its launches (the sum
over the paths, and by path), and last the device line
{"ok": true, "device": {...}}.
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
# The attention kernels' bounds take the input type's rate (fp32 on the FMA
# units).  The CLIP head's bound is the least time for fp32-accurate work by
# any means: for fp32 inputs 3 x FLOPs at the TF32 tensor-core rate (3xTF32,
# what its kernel runs), for bf16 FLOPs at the bf16 rate; against the FMA
# rate a tensor-core kernel would read above 100% of its bound.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "tf32": 494e12}

# kernel vs plain tolerances (max abs error), with the reason in the test
# file tests/test_torch_port_gpu.py: sums in another order; bf16 outputs may
# land on neighbouring bf16 values
ATTN_TOL = {"float32": 1e-5, "bfloat16": 2e-2}  # the backward: tol + tol * |ref| (see
# the test file: its gradients exceed 1 on unit-scale inputs, where one bf16 step is larger)
HEAD_TOL = 2e-5
MODEL_TOL = 1e-3  # ViT-B/32 features, card vs CPU, fp32 through 12 layers
STEP_PREFIX_TOL = 1e-4  # one CoOp or VPT step, card vs CPU: updated prompts (abs)
STEP_LOSS_RTOL = 1e-5  # ... and the loss (relative)

N_CLASSES, N_PER_CLASS, RES = 10, 64, 224


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
    secs = _cuda.build(["attention_fwd", "attention_bwd", "clip_head"])
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
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(torch):
    import torch.nn.functional as F

    from menghini_neurips23_tpu_torch.ops.attention import attention_reference, fused_attention
    from menghini_neurips23_tpu_torch.ops.clip_head import fused_probs, fused_probs_reference

    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    g = torch.Generator(device="cuda").manual_seed(0)
    attn_cases, head_cases = [], []
    # vision (ViT-B/32, the main path's batch), the text tower: C = 10 or
    # 102 classes at the truncated lengths 16 and 24 and the full 77, and
    # Flowers102's (102, 48); ViT-B/32 vision with a 16-token VPT prefix (a
    # training batch of 16, a validation batch of 256); ViT-L/14 vision
    # without and with a VPT prefix
    shapes = [(256, 50, 768, 12, None)] + [
        (b, t, 512, 8, "causal") for b in (10, 102) for t in (16, 24, 77)
    ] + [(102, 48, 512, 8, "causal"), (16, 66, 768, 12, None), (256, 66, 768, 12, None),
         (8, 257, 1024, 16, None), (8, 273, 1024, 16, None)]
    for dname, dt in dtypes.items():
        for B, T, W, H, mask in shapes:
            D = W // H
            qkv = torch.randn(B, T, 3 * W, generator=g, device="cuda").to(dt)
            out = fused_attention(qkv, mask, H)
            torch.cuda.synchronize()
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
                        tol=ATTN_TOL[dname], ms=ms, eager_ms=eager, plain_ms=plain,
                        library_ms=lib, bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / ms)
            attn_cases.append(case)
            log("  attention_fwd " + json.dumps(case))
            if not ok:
                fail(f"attention_fwd disagrees with its plain version: {case}")
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
        b_ms, b_by = bound((B + C) * E * size + B * C * 4,
                           3 * flops if dname == "float32" else flops,
                           "tf32" if dname == "float32" else dname)
        case = dict(shape=[B, E, C], dtype=dname, max_abs_err=err, tol=HEAD_TOL,
                    row_sum_err=row_err, ms=ms,
                    eager_ms=eager, plain_ms=plain, library_ms=None, bound_ms=b_ms,
                    bound_by=b_by, bound_share=b_ms / ms)
        head_cases.append(case)
        log("  clip_head " + json.dumps(case))
        if err > HEAD_TOL or row_err > HEAD_TOL:
            fail(f"clip_head disagrees with its plain version: {case}")
    return attn_cases, head_cases


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

    from menghini_neurips23_tpu_torch.ops.attention import (
        attention_bwd,
        attention_bwd_reference,
        fused_attention,
    )

    g = torch.Generator(device="cuda").manual_seed(1)
    cases = []
    # the CoOp text tower (C = 10 or 102 classes, truncated 24 or full 77;
    # Flowers102's (102, 48)), the VPT vision tower (16 prompt tokens; the
    # training batch of 16 and a batch of 256) and the plain ViT-B/32 one
    shapes = [(b, t, 512, 8, "causal") for b in (10, 102) for t in (24, 77)] + [
        (102, 48, 512, 8, "causal"), (16, 66, 768, 12, None), (256, 66, 768, 12, None),
        (256, 50, 768, 12, None),
    ]
    for dname, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        for B, T, W, H, mask in shapes:
            D = W // H
            causal = mask == "causal"
            qkv = torch.randn(B, T, 3 * W, generator=g, device="cuda").to(dt)
            grad = torch.randn(B, T, W, generator=g, device="cuda").to(dt)
            out = attention_bwd(qkv, grad, mask, H)
            torch.cuda.synchronize()
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
            lib = device_ms(torch, lambda: torch.autograd.grad(
                F.scaled_dot_product_attention(*heads, is_causal=causal), heads, g_heads))
            size = qkv.element_size()
            pairs = T * (T + 1) // 2 if causal else T * T  # key/query pairs computed
            # reads qkv (3W) and g (W), writes dqkv (3W); five T x T x D products
            b_ms, b_by = bound(B * T * 7 * W * size, 10 * B * H * D * pairs, dname)
            case = dict(shape=[B, T, W, H], mask=mask, dtype=dname, max_abs_err=err,
                        tol=tol, rtol=tol, ms=ms, plain_ms=plain, pair_ms=pair,
                        library_ms=lib, library="autograd.grad of scaled_dot_product_attention "
                        "(forward + backward)", bound_ms=b_ms, bound_by=b_by,
                        bound_share=b_ms / ms)
            cases.append(case)
            log("  attention_bwd " + json.dumps(case))
            if not ok:
                fail(f"attention_bwd disagrees with its plain version: {case}")
    # the FusedAttention gradient (K1 forward + K2 backward) against autograd
    # of the plain forward, both on the card, fp32
    from menghini_neurips23_tpu_torch.ops.attention import attention_reference

    for B, T, W, H, mask in ((10, 24, 512, 8, "causal"), (256, 66, 768, 12, None)):
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


def step_runtimes(torch):
    """ViT-B/32 fp32 runtimes on the CPU and on the card, with the same
    (random, seeded) weights."""
    from menghini_neurips23_tpu_torch.config import Config
    from menghini_neurips23_tpu_torch.runtime import ClipRuntime

    cfg = Config(VIS_ENCODER="ViT-B/32", COMPUTE_DTYPE="float32", BATCH_SIZE=16, OPTIM_SEED=1)
    cpu_rt = ClipRuntime(cfg, device="cpu")
    gpu_rt = ClipRuntime(cfg, device="cuda")
    gpu_rt.model.load_state_dict(cpu_rt.model.state_dict())
    return {"cpu": cpu_rt, "cuda": gpu_rt}


def one_step_card_vs_cpu(torch, runtimes, what, cls, cfg, prompt, feats, ctx=None):
    """One training step of strategy `cls` (two loss groups at textual_fpl's
    balance, 128 pseudo / 16 labeled) from the same weights, prompt, class
    context and batch: on the card through K1 + K2, on the CPU through the
    plain versions.  `ctx` None takes the strategy's own class context."""
    import numpy as np

    from menghini_neurips23_tpu_torch.ops.attention import attention_bwd, fused_attention

    classes = [str(i) for i in range(N_CLASSES)]
    l2i = {c: i for i, c in enumerate(classes)}
    rng = np.random.default_rng(0)
    labels = torch.from_numpy(rng.integers(0, N_CLASSES, 16).astype(np.int32))
    group = torch.from_numpy((np.arange(16) % 2).astype(np.int32))
    valid = torch.ones(16)
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
        launches = (fused_attention.launches - f0, attention_bwd.launches - b0)
        out[name] = (loss, correct, strat.epoch_parameters(), launches, tuple(c.shape))
    (lc, cc, pc, nc, shape), (lg, cg, pg, ng, _) = out["cpu"], out["cuda"]
    p_err = max(float(np.abs(g - c).max()) for g, c in zip(pg, pc))
    moved = min(float(np.abs(c - p).max()) for c, p in zip(pc, prompt))
    l_rel = abs(lg - lc) / abs(lc)
    rec = {"class_context": list(shape), "batch": list(feats.shape),
           "prompt": [list(p.shape) for p in prompt], "loss_cpu": lc, "loss_card": lg,
           "loss_rel_err": l_rel, "correct": [cc, cg], "prompt_max_abs_err": p_err,
           "prompt_moved_min": moved, "card_launches_k1_k2": list(ng),
           "cpu_launches_k1_k2": list(nc)}
    log(f"  one {what} step, ViT-B/32 fp32, card vs CPU: {json.dumps(rec)} "
        f"(tol {STEP_PREFIX_TOL} abs prompt, {STEP_LOSS_RTOL} rel loss)")
    if not (p_err <= STEP_PREFIX_TOL and l_rel <= STEP_LOSS_RTOL and cc == cg and moved > 0):
        fail(f"one {what} step on the card disagrees with the CPU: {rec}")
    if ng != (12, 12) or nc != (0, 0):
        fail(f"one {what} step: K1/K2 launches card {ng}, CPU {nc}; expected 12/12 and 0/0")


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


def phase_one_vpt_step(torch, runtimes):
    """One deep VPT step (visual_fpl, VPT_DEEP on) at ViT-B/32 width, fp32,
    card vs CPU: the vision tower over a batch of 16 token sequences with the
    16-token prefix (T = 66) and the 11 layers' deep prompts, against 10
    frozen text features."""
    import numpy as np

    from menghini_neurips23_tpu_torch.config import Config
    from menghini_neurips23_tpu_torch.models import VIT_B32
    from menghini_neurips23_tpu_torch.models.prompts import init_deep_prefix, init_prefix
    from menghini_neurips23_tpu_torch.training import VisualStrategy

    a = VIT_B32
    cfg = Config(VIS_ENCODER="ViT-B/32", MODEL="visual_fpl", COMPUTE_DTYPE="float32",
                 BATCH_SIZE=16, OPTIM_SEED=1, VPT_DEEP=True)
    gen = torch.Generator().manual_seed(7)
    prompt = [init_prefix(gen, 16, a.vision_width).numpy(),
              init_deep_prefix(gen, a.vision_layers - 1, 16, a.vision_width).numpy()]
    rng = np.random.default_rng(1)
    tokens = rng.normal(0, 1, (16, 1 + a.num_patches, a.vision_width)).astype(np.float32)
    text = rng.normal(0, 1, (N_CLASSES, a.embed_dim)).astype(np.float32)
    text /= np.linalg.norm(text, axis=1, keepdims=True)
    one_step_card_vs_cpu(torch, runtimes, "deep VPT", VisualStrategy, cfg, prompt,
                         torch.from_numpy(tokens), torch.from_numpy(text))


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


def _config(data_dir: str, artifacts: str, dtype: str, model: str = "clip_baseline"):
    from menghini_neurips23_tpu_torch.config import Config

    return Config(
        DATASET_NAME="MNIST", DATASET_DIR=data_dir, MODEL=model, VIS_ENCODER="ViT-B/32",
        LEARNING_PARADIGM="ssl", PROMPT_TEMPLATE="a photo of a {}", BATCH_SIZE=256,
        COMPUTE_DTYPE=dtype, OPTIM_SEED=1, SPLIT_SEED=500, ARTIFACT_DIR=artifacts,
    )


def phase_main_clip(torch, data_dir: str, work: str, dtype: str):
    import numpy as np

    from menghini_neurips23_tpu_torch.runners import main_clip

    artifacts = f"{work}/artifacts_{dtype}"
    cfg = _config(data_dir, artifacts, dtype)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    resp = main_clip.workflow(cfg.DATASET_DIR, cfg, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = N_CLASSES * N_PER_CLASS
    with open(f"{artifacts}/results_model_clip_baseline.json") as f:
        rec = json.loads(f.readline())
    with open(f"{artifacts}/evaluation/MNIST_ssl_clip_baseline_ViT-B32_opt_1_spl_500.pickle", "rb") as f:
        pred = pickle.load(f)
    logits = np.asarray(pred["logits"])
    if rec["model"] != "clip_baseline" or not 0.0 <= rec["accuracy"] <= 1.0:
        fail(f"main_clip[{dtype}]: bad results line {rec}")
    if logits.shape != (n, N_CLASSES) or not np.isfinite(logits).all():
        fail(f"main_clip[{dtype}]: logits {logits.shape}, finite={np.isfinite(logits).all()}")
    if len(pred["predictions"]) != n or len(pred["images"]) != n:
        fail(f"main_clip[{dtype}]: {len(pred['predictions'])} predictions for {n} images")
    log(f"  main_clip[{dtype}]: accuracy {resp[0]:.4f}, {n} test images, wall {wall:.3f} s "
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
def phase_train(torch, data_dir: str, work: str, paradigm: str, model: str, dtype: str,
                epochs: int):
    """main_<paradigm>.workflow for one prompt MODEL (CoOp or VPT) with its
    bundled config (N_LABEL 2, PREFIX_SIZE 16, N_PSEUDOSHOTS 16, BATCH_SIZE
    16, SGD lr 0.1 cosine), `epochs` epochs, in `dtype`; checks the artifacts,
    the training rows the paradigm makes and the losses."""
    import argparse
    import importlib
    import logging

    import numpy as np

    from menghini_neurips23_tpu_torch.models.prompts import init_prefix
    from menghini_neurips23_tpu_torch.runners import common
    from menghini_neurips23_tpu_torch.training import TrainingStrategy

    runner = importlib.import_module(f"{PKG}.runners.main_{paradigm}")
    artifacts = f"{work}/artifacts_{paradigm}_{model}_{dtype}"
    env = dict(DATASET_NAME="MNIST", DATASET_DIR=data_dir, MODEL=model,
               VIS_ENCODER="ViT-B/32", OPTIM_SEED="1", SPLIT_SEED="500")
    args = argparse.Namespace(model_config=f"{model}_config.yml", learning_paradigm=paradigm)
    cfg = common.load_config(args, env=env)
    cfg.EPOCHS, cfg.COMPUTE_DTYPE, cfg.ARTIFACT_DIR = epochs, dtype, artifacts

    # what the run reports: the epoch log lines (loss per epoch), one pair of
    # CUDA events around every step, the strategy and its best val accuracy
    epoch_logs, events, seen = [], [], {}

    class EpochLog(logging.Handler):
        def emit(self, record):
            if isinstance(record.msg, str) and record.msg.startswith("epoch %d"):
                epoch_logs.append(record.args)

    strategy_log = logging.getLogger("menghini_neurips23_tpu_torch.training.strategy")
    handler = EpochLog(logging.INFO)
    strategy_log.addHandler(handler)
    strategy_log.setLevel(logging.INFO)
    strategy_log.propagate = False  # one summary line per run instead of one per epoch
    step, run = TrainingStrategy._apply_step, common.run_strategy

    def timed_step(self, *a, **k):
        ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev[0].record()
        out = step(self, *a, **k)
        ev[1].record()
        events.append(ev)
        return out

    def recorded_run(strategy, *a):
        seen["strategy"] = strategy
        t0 = time.perf_counter()
        seen["result"] = run(strategy, *a)
        seen["train_s"] = time.perf_counter() - t0
        return seen["result"]

    TrainingStrategy._apply_step, common.run_strategy = timed_step, recorded_run
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        resp = runner.workflow(cfg.DATASET_DIR, cfg, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        TrainingStrategy._apply_step, common.run_strategy = step, run
        strategy_log.removeHandler(handler)
        strategy_log.propagate = True

    what = f"train[{paradigm}, {model}]"
    enc = cfg.VIS_ENCODER.replace("/", "")
    stem = f"MNIST_{paradigm}_{model}_{enc}_opt_1_spl_500.pickle"
    with open(f"{artifacts}/trained_prompts/{stem}", "rb") as f:
        saved = pickle.load(f)
    strategy = seen["strategy"]
    # the prefix is the first draw of the prompt's generator: (16, 512) for
    # CoOp, (16, 768) for VPT at ViT-B/32
    final = strategy.epoch_parameters()
    width = final[0].shape[1]
    start = init_prefix(torch.Generator().manual_seed(cfg.OPTIM_SEED * 1000), cfg.PREFIX_SIZE,
                        width, cfg.VIS_PREFIX_INIT, cfg.MEAN_INIT, cfg.VAR_INIT).numpy()
    p = np.asarray(saved[0])
    losses = [a[1] for a in epoch_logs]
    if len(losses) != epochs or not all(np.isfinite(losses)):
        fail(f"{what}: {len(losses)} epoch losses for {epochs} epochs, or not finite")
    # the saved prompt is the best-validation epoch's; epoch 0 trains at lr 0
    # (the cosine warm-up), so a best epoch of 0 saves the initial prefix
    val_accs = [a[3] for a in epoch_logs]
    best_epoch = int(np.argmax(val_accs))
    if not (len(saved) == len(final) and p.shape == (16, width) and p.dtype == np.float32
            and np.isfinite(p).all() and np.array_equal(p, start) == (best_epoch == 0)
            and not np.array_equal(final[0], start)):
        fail(f"{what}: saved prefix {p.shape} {p.dtype} (best epoch {best_epoch}) is not "
             f"the trained (16, {width}) fp32 one, or the prefix never moved")
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
    if model.endswith("_fpl"):
        cache = (f"{artifacts}/pseudolabels/MNIST_{enc}_{paradigm}_{model}_16"
                 "_pseudolabels_split_500.pickle")
        with open(cache, "rb") as f:
            n_pseudo = len(pickle.load(f)["filepaths"])
        # pseudo rows: the 80% carve of the selection.  SSL adds the train
        # share of 2 shots per class, TRZSL the seen classes' labeled train
        # split; UL trains on the pseudolabels alone, in the labeled group 0
        n_train_pseudo = int(n_pseudo * cfg.ratio_train_val)
        n_shots = int(cfg.N_LABEL * N_CLASSES * cfg.ratio_train_val)
        ok = {"ssl": (n_group1, rows) == (n_train_pseudo, n_train_pseudo + n_shots),
              "ul": (n_group1, rows) == (0, n_train_pseudo),
              "trzsl": n_group1 == n_train_pseudo and rows > n_train_pseudo}[paradigm]
        if not ok:
            fail(f"{what}: {rows} training rows ({n_group1} in the pseudolabel group) for "
                 f"{n_pseudo} pseudolabels")
        extra = {"pseudolabels": n_pseudo, "pseudo_val": len(strategy.val_unseen_files)}
    steps = len(events)
    torch.cuda.synchronize()
    ev_ms = sorted(a.elapsed_time(b) for a, b in events)
    out = {
        "paradigm": paradigm, "model": model, "dtype": dtype, "epochs": epochs,
        "prompt": [list(x.shape) for x in final], "training_rows": rows,
        "pseudolabel_group_rows": n_group1,
        "steps": steps, "steps_per_epoch": steps / epochs, "wall_s": wall,
        "train_s": seen["train_s"], "wall_ms_per_step": 1e3 * seen["train_s"] / steps,
        "event_ms_per_step_median": ev_ms[len(ev_ms) // 2], "event_ms_per_step_min": ev_ms[0],
        "best_val_metric": seen["result"][0], "best_epoch": best_epoch,
        "saved_prefix_moved": float(np.abs(p - start).max()), "test_result": list(resp),
        "first_loss": losses[0], "last_loss": losses[-1], **extra,
    }
    log(f"  {what}, {dtype}: " + json.dumps(out, default=float))
    return wall, strategy


def phase_step_profile(torch, strategy, files, n: int = 20):
    """Where one training step's time goes: `n` steps of the trained strategy
    (lr 0, a fixed batch of the first 16 of `files`) timed on the host clock
    alone, then again under torch.profiler for the device's busy time and the
    kernels by name."""
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
    wall_ms = steps()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prof_wall_ms = steps()
    from torch.autograd import DeviceType

    # device-side events only (a CPU op's entry repeats its kernels' time),
    # summed by the first 70 characters of the kernel's name
    kernels, launched = {}, 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            kernels[e.key[:70]] = kernels.get(e.key[:70], 0.0) + us / 1e3 / n
            launched += e.count
    busy = sum(kernels.values())
    out = {
        "model": strategy.config.MODEL, "dtype": strategy.config.COMPUTE_DTYPE,
        "class_context": list(ctx.shape), "batch": list(feats.shape), "steps": n,
        "wall_ms_per_step": wall_ms,
        "profiled_wall_ms_per_step": prof_wall_ms,
        "device_ops_per_step": launched / n if kernels else None,
        "device_busy_ms_per_step": busy if kernels else None,
        # the busy time against the wall without the profiler's overhead
        "device_idle_share": 1 - busy / wall_ms if kernels else None,
        "top_kernels_ms_per_step": dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:8]),
    }
    log("  training step profile: " + json.dumps(out))


# ---------------------------------------------------------------- phase 8
def phase_breakdown(torch, data_dir: str, work: str):
    """Where a main_clip run's wall time goes (bf16), measured apart from the
    counted main path: runtime set-up, the host's decode of the 640 test
    PNGs alone, the device's encode of one decoded 256-image batch alone,
    and the prefetching pass that overlaps decode with the device."""
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


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, PKG)):
        print(f"chip_smoke.py: {PKG}/ not found beside this script; run it from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import torch

    from menghini_neurips23_tpu_torch.ops.attention import attention_bwd, fused_attention
    from menghini_neurips23_tpu_torch.ops.clip_head import fused_probs

    log("[1] device")
    phase_device(torch)
    log("[2] build")
    phase_build()
    log("[3] kernels vs plain versions")
    attn_cases, head_cases = phase_kernels(torch)
    bwd_cases = phase_kernels_bwd(torch)
    phase_model_reference(torch)
    runtimes = step_runtimes(torch)
    phase_one_step(torch, runtimes)
    phase_one_vpt_step(torch, runtimes)
    del runtimes

    work = os.path.join(ROOT, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    data_dir = f"{work}/data"
    t0 = time.perf_counter()
    classes = make_dataset(f"{data_dir}/MNIST")
    log(f"[4] main path: dataset of {len(classes)} classes x {N_PER_CLASS} train + "
        f"{N_PER_CLASS} test {RES}px PNGs written in {time.perf_counter() - t0:.2f} s")

    wrappers = {"attention_fwd": fused_attention, "attention_bwd": attention_bwd,
                "clip_head": fused_probs}
    # each main path runs with every count set to 0 just before it and read
    # just after; a kernel the path runs must show at least one launch
    by_path = {}

    def counted(path: str, needs, run):
        for w in wrappers.values():
            w.launches = 0
        run()
        by_path[path] = {name: w.launches for name, w in wrappers.items()}
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

    def training_runs(runs):
        def run():
            for paradigm, model, dtype, epochs in runs:
                walls[f"{paradigm}_{model}_{dtype}"], trained[f"{paradigm}_{model}"] = phase_train(
                    torch, data_dir, work, paradigm, model, dtype, epochs)
        return run

    counted("zero-shot", ("attention_fwd", "clip_head"), zero_shot_path)
    log("[7] training (SSL CoOp)")
    counted("training (SSL CoOp)", tuple(wrappers), training_runs(
        [("ssl", "textual_prompt", "float32", 20), ("ssl", "textual_fpl", "bfloat16", 150)]))
    log("[7] training (UL/TRZSL, VPT)")
    counted("training (UL/TRZSL, VPT)", tuple(wrappers), training_runs(
        [("ul", "visual_fpl", "bfloat16", 150), ("trzsl", "visual_fpl", "float32", 20)]))
    launches = {name: sum(c[name] for c in by_path.values()) for name in wrappers}
    log("phase wall seconds: " + json.dumps({k: round(v, 3) for k, v in walls.items()}))
    log("[8] breakdown")
    phase_breakdown(torch, data_dir, work)
    with open(f"{data_dir}/MNIST/train.txt") as f:
        train_files = [f"{data_dir}/MNIST/train/{l.split()[0]}" for l in f if l.strip()]
    fpl = trained["ssl_textual_fpl"]
    phase_step_profile(torch, fpl, train_files)
    # the same step over Flowers102's 102 class prompts (the paper's widest
    # class list), on the same runtime
    from menghini_neurips23_tpu_torch.data import get_class_names
    from menghini_neurips23_tpu_torch.training import TextualStrategy

    flowers = get_class_names("Flowers102", data_dir, 500)[0]
    phase_step_profile(torch, TextualStrategy(
        fpl.config, {c: i for i, c in enumerate(flowers)}, flowers, flowers, flowers,
        runtime=fpl.runtime), train_files)
    # one bf16 VPT step: the vision tower over 16 x 66 tokens, forward and
    # backward to the prefix
    phase_step_profile(torch, trained["ul_visual_fpl"], train_files)

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

    kernels = [
        entry("attention_fwd", f"{PKG}/csrc/attention_fwd.cu",
              "menghini_neurips23_tpu/ops/attention.py:65", attn_cases,
              lambda c: c["shape"] == [256, 50, 768, 12] and c["dtype"] == "bfloat16"),
        entry("attention_bwd", f"{PKG}/csrc/attention_bwd.cu",
              "menghini_neurips23_tpu/ops/attention.py:96", bwd_cases,
              lambda c: c["shape"] == [10, 24, 512, 8] and c["dtype"] == "bfloat16"),
        entry("clip_head", f"{PKG}/csrc/clip_head.cu",
              "menghini_neurips23_tpu/ops/clip_head.py:40", head_cases,
              lambda c: c["shape"] == [640, 512, 10] and c["dtype"] == "float32"),
    ]
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "menghini_neurips23_tpu"))
    if leaked:
        fail(f"the port imported JAX or the JAX package: {leaked[:5]}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
