#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (menghini_neurips23_tpu_torch) on one
NVIDIA GPU: builds the port's CUDA kernels from csrc/, holds each against its
plain PyTorch version at the main path's shapes, then drives the zero-shot /
pseudolabel path end to end at ViT-B/32's full width (random weights from a
seed) and the SSL CoOp prompt training (textual_prompt, textual_fpl), and
checks what they write.

    python3 chip_smoke.py            # from the repository root; needs one card

Phases (one or more lines each; any failure raises and exits non-zero):
  1. device: the card's name and power limit, torch/CUDA/nvcc/Triton
     versions, which optional host packages import, whether the native image
     loader builds; fails when torch sees no card
  2. build: compiles every kernel (one nvcc per source, all at once)
  3. kernels: each kernel against its plain version on the card, fp32 and
     bf16, at the main path's shapes, with CUDA-event times of the kernel,
     the plain version and, for attention, scaled_dot_product_attention as
     a yardstick (forward alone; forward + backward through autograd beside
     the K1 + K2 pair - the port never calls it); the FusedAttention
     gradient against autograd of the plain forward; a full-width ViT-B/32
     forward on the card against the same weights on the CPU; one CoOp
     training step at ViT-B/32 width on the card against the same step on
     the CPU
  4. main path: main_clip.workflow on a synthetic 10-class MNIST-layout
     dataset (224x224 PNGs, 64 train + 64 test per class), BATCH_SIZE 256,
     in float32 and in bfloat16
  5. pseudolabels: FPL top-16 per class over the 640-image train pool
  6. serving: predict.main over the 640 test images, top 5
  7. training: main_ssl.workflow, MODEL=textual_prompt in float32 for 20
     epochs and MODEL=textual_fpl in bfloat16 for the paper's 150 epochs,
     BATCH_SIZE 16, on the same dataset
  8. breakdown: set-up, host decode and device encode of the bf16 pass,
     each timed alone; one bf16 textual_fpl training step on the host clock
     and under torch.profiler (device busy time, kernels by name)
Phases 4-6 (the zero-shot path) and phase 7 (the training path) each run
with every launch count set to 0 just before and read just after; a kernel
the path runs must show a launch.  Then one JSON line listing each kernel
with its launches (the sum over both paths, and by path), and last the
device line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import struct
import subprocess
import sys
import time
import zlib

ROOT = os.path.dirname(os.path.abspath(__file__))
PKG = "menghini_neurips23_tpu_torch"

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and FLOP/s by type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

# kernel vs plain tolerances (max abs error), with the reason in the test
# file tests/test_torch_port_gpu.py: sums in another order; bf16 outputs may
# land on neighbouring bf16 values
ATTN_TOL = {"float32": 1e-5, "bfloat16": 2e-2}  # the backward: tol + tol * |ref| (see
# the test file: its gradients exceed 1 on unit-scale inputs, where one bf16 step is larger)
HEAD_TOL = 2e-5
MODEL_TOL = 1e-3  # ViT-B/32 features, card vs CPU, fp32 through 12 layers
STEP_PREFIX_TOL = 1e-4  # one CoOp step, card vs CPU: updated prefix (abs)
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
        regs = [l.strip() for l in _cuda.build_log(name).splitlines() if "registers" in l]
        log(f"  {name}: {len(regs)} entry points; " + ("; ".join(sorted(set(regs))) or "no report"))


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
    # vision (ViT-B/32, the main path's batch) and the text tower: C = 10 or
    # 102 classes at the truncated lengths 16 and 24 and the full 77
    shapes = [(256, 50, 768, 12, None)] + [
        (b, t, 512, 8, "causal") for b in (10, 102) for t in (16, 24, 77)
    ]
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
                        library_ms=lib, bound_ms=b_ms, bound_by=b_by)
            attn_cases.append(case)
            log("  attention_fwd " + json.dumps(case))
            if not ok:
                fail(f"attention_fwd disagrees with its plain version: {case}")
    for dname, dt in dtypes.items():
        # (640, 512, 10): the pseudolabel pool of phase 5 in one call
        for B, E, C in ((256, 512, 10), (256, 512, 102), (640, 512, 10)):
            img = torch.randn(B, E, generator=g, device="cuda").to(dt)
            txt = torch.randn(C, E, generator=g, device="cuda").to(dt)
            out = fused_probs(img, txt, 100.0)
            torch.cuda.synchronize()
            err = (out - fused_probs_reference(img, txt, 100.0)).abs().max().item()
            ms = device_ms(torch, lambda: fused_probs(img, txt, 100.0))
            eager = eager_ms(torch, lambda: fused_probs(img, txt, 100.0))
            plain = device_ms(torch, lambda: fused_probs_reference(img, txt, 100.0))
            size = img.element_size()
            b_ms, b_by = bound((B + C) * E * size + B * C * 4,
                               2 * B * C * E + 2 * (B + C) * E, dname)
            case = dict(shape=[B, E, C], dtype=dname, max_abs_err=err, tol=HEAD_TOL, ms=ms,
                        eager_ms=eager, plain_ms=plain, library_ms=None, bound_ms=b_ms,
                        bound_by=b_by)
            head_cases.append(case)
            log("  clip_head " + json.dumps(case))
            if err > HEAD_TOL:
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
    # the CoOp text tower (C = 10 or 102 classes, truncated 24 or full 77),
    # the VPT vision tower (16 prompt tokens) and the plain ViT-B/32 one
    shapes = [(b, t, 512, 8, "causal") for b in (10, 102) for t in (24, 77)] + [
        (256, 66, 768, 12, None), (256, 50, 768, 12, None)
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
                        "(forward + backward)", bound_ms=b_ms, bound_by=b_by)
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


def phase_one_step(torch):
    """One CoOp step (textual_fpl weights, two loss groups) at ViT-B/32 width,
    fp32: on the card through K1 + K2, on the CPU through the plain versions,
    from the same weights, prefix and batch."""
    import numpy as np

    from menghini_neurips23_tpu_torch.config import Config
    from menghini_neurips23_tpu_torch.models.prompts import init_prefix
    from menghini_neurips23_tpu_torch.ops.attention import attention_bwd, fused_attention
    from menghini_neurips23_tpu_torch.runtime import ClipRuntime
    from menghini_neurips23_tpu_torch.training import TextualStrategy

    cfg = Config(VIS_ENCODER="ViT-B/32", MODEL="textual_fpl", COMPUTE_DTYPE="float32",
                 BATCH_SIZE=16, OPTIM_SEED=1)
    classes = [str(i) for i in range(N_CLASSES)]
    l2i = {c: i for i, c in enumerate(classes)}
    cpu_rt = ClipRuntime(cfg, device="cpu")
    gpu_rt = ClipRuntime(cfg, device="cuda")
    gpu_rt.model.load_state_dict(cpu_rt.model.state_dict())
    prefix = init_prefix(torch.Generator().manual_seed(7), 16, 512).numpy()
    rng = np.random.default_rng(0)
    feats = rng.normal(0, 1, (16, 512)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    labels = rng.integers(0, N_CLASSES, 16).astype(np.int32)
    group = (np.arange(16) % 2).astype(np.int32)
    valid = np.ones(16, np.float32)
    out = {}
    for name, rt in (("cpu", cpu_rt), ("cuda", gpu_rt)):
        strat = TextualStrategy(cfg, l2i, classes, classes, classes, runtime=rt)
        strat.load_parameters([prefix])
        strat._w0, strat._w1 = 8.0, 1.0  # textual_fpl's balance, 128 pseudo / 16 labeled
        dev = rt.device
        ctx = torch.tensor(strat._train_text_class_ids(classes), dtype=torch.long, device=dev)
        f0, b0 = fused_attention.launches, attention_bwd.launches
        loss, correct = strat._apply_step(
            ctx, 0.1, torch.from_numpy(feats).to(dev), torch.from_numpy(labels).to(dev),
            torch.from_numpy(group).to(dev), torch.from_numpy(valid).to(dev))
        launches = (fused_attention.launches - f0, attention_bwd.launches - b0)
        out[name] = (loss, correct, strat.epoch_parameters()[0], launches, tuple(ctx.shape))
    (lc, cc, pc, nc, shape), (lg, cg, pg, ng, _) = out["cpu"], out["cuda"]
    p_err = float(np.abs(pg - pc).max())
    moved = float(np.abs(pc - prefix).max())
    l_rel = abs(lg - lc) / abs(lc)
    rec = {"token_ids": list(shape), "loss_cpu": lc, "loss_card": lg, "loss_rel_err": l_rel,
           "correct": [cc, cg], "prefix_max_abs_err": p_err, "prefix_moved": moved,
           "card_launches_k1_k2": list(ng), "cpu_launches_k1_k2": list(nc)}
    log(f"  one CoOp step, ViT-B/32 fp32, card vs CPU: {json.dumps(rec)} "
        f"(tol {STEP_PREFIX_TOL} abs prefix, {STEP_LOSS_RTOL} rel loss)")
    if not (p_err <= STEP_PREFIX_TOL and l_rel <= STEP_LOSS_RTOL and cc == cg and moved > 0):
        fail(f"one CoOp step on the card disagrees with the CPU: {rec}")
    if ng != (12, 12) or nc != (0, 0):
        fail(f"one CoOp step: K1/K2 launches card {ng}, CPU {nc}; expected 12/12 and 0/0")


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
def phase_train(torch, data_dir: str, work: str, model: str, dtype: str, epochs: int):
    """main_ssl.workflow for one CoOp MODEL with the bundled config (N_LABEL 2,
    PREFIX_SIZE 16, N_PSEUDOSHOTS 16, BATCH_SIZE 16, SGD lr 0.1 cosine),
    `epochs` epochs, in `dtype`; checks the artifacts and the losses."""
    import argparse
    import logging

    import numpy as np

    from menghini_neurips23_tpu_torch.models.prompts import init_prefix
    from menghini_neurips23_tpu_torch.runners import common, main_ssl
    from menghini_neurips23_tpu_torch.training import TextualStrategy

    artifacts = f"{work}/artifacts_{model}_{dtype}"
    env = dict(DATASET_NAME="MNIST", DATASET_DIR=data_dir, MODEL=model,
               VIS_ENCODER="ViT-B/32", OPTIM_SEED="1", SPLIT_SEED="500")
    args = argparse.Namespace(model_config=f"{model}_config.yml", learning_paradigm="ssl")
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
    step, run = TextualStrategy._apply_step, common.run_strategy

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

    TextualStrategy._apply_step, common.run_strategy = timed_step, recorded_run
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        resp = main_ssl.workflow(cfg.DATASET_DIR, cfg, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        TextualStrategy._apply_step, common.run_strategy = step, run
        strategy_log.removeHandler(handler)
        strategy_log.propagate = True

    enc = cfg.VIS_ENCODER.replace("/", "")
    stem = f"MNIST_ssl_{model}_{enc}_opt_1_spl_500.pickle"
    with open(f"{artifacts}/trained_prompts/{stem}", "rb") as f:
        saved = pickle.load(f)
    strategy = seen["strategy"]
    width = strategy.runtime.arch.transformer_width  # 512 for ViT-B/32
    start = init_prefix(torch.Generator().manual_seed(cfg.OPTIM_SEED * 1000), cfg.PREFIX_SIZE,
                        width, cfg.VIS_PREFIX_INIT, cfg.MEAN_INIT, cfg.VAR_INIT).numpy()
    p = np.asarray(saved[0])
    losses = [a[1] for a in epoch_logs]
    if len(losses) != epochs or not all(np.isfinite(losses)):
        fail(f"train[{model}]: {len(losses)} epoch losses for {epochs} epochs, or not finite")
    # the saved prompt is the best-validation epoch's; epoch 0 trains at lr 0
    # (the cosine warm-up), so a best epoch of 0 saves the initial prefix
    val_accs = [a[3] for a in epoch_logs]
    best_epoch = int(np.argmax(val_accs))
    final = strategy.epoch_parameters()[0]
    if not (len(saved) == 1 and p.shape == (16, width) and p.dtype == np.float32
            and np.isfinite(p).all() and np.array_equal(p, start) == (best_epoch == 0)
            and not np.array_equal(final, start)):
        fail(f"train[{model}]: saved prefix {p.shape} {p.dtype} (best epoch {best_epoch}) is not "
             f"the trained (16, {width}) fp32 one, or the prefix never moved")
    with open(f"{artifacts}/results_model_{model}.json") as f:
        rec = json.loads(f.readline())
    with open(f"{artifacts}/evaluation/{stem}", "rb") as f:
        pred = pickle.load(f)
    n_test = N_CLASSES * N_PER_CLASS
    logits = np.asarray(pred["logits"])
    if rec["model"] != model or not 0.0 <= rec["accuracy"] <= 1.0:
        fail(f"train[{model}]: bad results line {rec}")
    if logits.shape != (n_test, N_CLASSES) or not np.isfinite(logits).all():
        fail(f"train[{model}]: evaluation logits {logits.shape}")
    rows = len(strategy._train_groups)
    extra = {}
    if model == "textual_fpl":
        cache = (f"{artifacts}/pseudolabels/MNIST_{enc}_ssl_textual_fpl_16"
                 "_pseudolabels_split_500.pickle")
        with open(cache, "rb") as f:
            n_pseudo = len(pickle.load(f)["filepaths"])
        # pseudo rows: the 80% carve of the selection; labeled rows: the
        # train share of 2 shots per class
        n_train_pseudo = int(n_pseudo * cfg.ratio_train_val)
        n_shots = int(cfg.N_LABEL * N_CLASSES * cfg.ratio_train_val)
        if (sum(strategy._train_groups), rows) != (n_train_pseudo, n_train_pseudo + n_shots):
            fail(f"train[{model}]: {rows} training rows ({sum(strategy._train_groups)} pseudo), "
                 f"expected {n_train_pseudo} + {n_shots}")
        extra = {"pseudolabels": n_pseudo, "pseudo_val": len(strategy.val_unseen_files)}
    steps = len(events)
    torch.cuda.synchronize()
    ev_ms = sorted(a.elapsed_time(b) for a, b in events)
    out = {
        "model": model, "dtype": dtype, "epochs": epochs, "training_rows": rows,
        "steps": steps, "steps_per_epoch": steps / epochs, "wall_s": wall,
        "train_s": seen["train_s"], "wall_ms_per_step": 1e3 * seen["train_s"] / steps,
        "event_ms_per_step_median": ev_ms[len(ev_ms) // 2], "event_ms_per_step_min": ev_ms[0],
        "best_val_acc": seen["result"][0], "best_epoch": best_epoch,
        "saved_prefix_moved": float(np.abs(p - start).max()), "test_acc": resp[0],
        "first_loss": losses[0], "last_loss": losses[-1], **extra,
    }
    log(f"  train[{model}, {dtype}]: " + json.dumps(out))
    return wall, strategy


def phase_step_profile(torch, strategy, n: int = 20):
    """Where one training step's time goes: `n` steps of the trained strategy
    (lr 0, a fixed batch of 16) timed on the host clock alone, then again
    under torch.profiler for the device's busy time and the kernels by name."""
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    dev = strategy.device
    n_cls = len(strategy.classes)
    ctx = torch.tensor(strategy._train_text_class_ids(strategy.classes), dtype=torch.long,
                       device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    feats = F.normalize(torch.randn(16, strategy.runtime.arch.embed_dim, generator=g,
                                    device=dev), dim=1)
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
        "token_ids": list(ctx.shape), "steps": n, "wall_ms_per_step": wall_ms,
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
    phase_one_step(torch)

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

    def training_path():
        for model, dtype, epochs in (("textual_prompt", "float32", 20),
                                     ("textual_fpl", "bfloat16", 150)):
            walls[f"{model}_{dtype}"], trained[model] = phase_train(
                torch, data_dir, work, model, dtype, epochs)

    counted("zero-shot", ("attention_fwd", "clip_head"), zero_shot_path)
    log("[7] training (SSL CoOp)")
    counted("training", tuple(wrappers), training_path)
    launches = {name: sum(c[name] for c in by_path.values()) for name in wrappers}
    log("phase wall seconds: " + json.dumps({k: round(v, 3) for k, v in walls.items()}))
    log("[8] breakdown")
    phase_breakdown(torch, data_dir, work)
    fpl = trained["textual_fpl"]
    phase_step_profile(torch, fpl)
    # the same step over Flowers102's 102 class prompts (the paper's widest
    # class list), on the same runtime
    from menghini_neurips23_tpu_torch.data import get_class_names
    from menghini_neurips23_tpu_torch.training import TextualStrategy

    flowers = get_class_names("Flowers102", data_dir, 500)[0]
    phase_step_profile(torch, TextualStrategy(
        fpl.config, {c: i for i, c in enumerate(flowers)}, flowers, flowers, flowers,
        runtime=fpl.runtime))

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
