"""Time the streamed attention kernels (T > 320) of the port under ROOT on one
CUDA card, and the training step that runs them, so that two trees can be
compared in one call.

For K1 (`fused_attention`) and K2 (`attention_bwd`) at `chip_smoke.py`'s
LONG_SHAPES, fp32 and bf16: device ms per call (20 calls captured in one
CUDA graph, replayed), beside `scaled_dot_product_attention` on the same
inputs (forward alone for K1; forward + backward through autograd for K2),
the bound (`chip_smoke.bound`: bytes over the HBM rate or operations over
the peak, fp32 as 3xTF32) and bound / ms.  Then one bf16 VPT training step
at ViT-L/14's full width with an 80-token prompt (T = 337, the vision tower
over a 16-row batch, random weights, lr 0) in the per-step loop: wall ms on
the host clock, and under torch.profiler the device busy ms and K1's and
K2's ms a step.  Prints the card's `nvidia-smi` line, then one JSON line.

    python3 scripts/streamed_attention_compare.py [ROOT] [--label NAME] [--reps N]

To compare with a parent commit: unpack it into a directory that .gitignore
lists (`git archive <parent> | tar -x -C build/parent`) and run parent,
current, current, parent one after another on the same card.  The helpers
(timing, bounds, shapes) come from the `chip_smoke.py` beside this script,
so both trees are measured the same way.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 10
PREFIX = 80  # ViT-L/14: T = 1 + 256 + 80 = 337


def smoke_helpers():
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers",
                                                  os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ptxas(_cuda):
    """{kernel<type, D>: [registers, spill-store bytes]} of each streamed or
    tiled entry point, from the compiler's report beside the libraries."""
    import re

    out = {}
    for lib in ("attention_fwd", "attention_bwd"):
        for block in _cuda.build_log(lib).split("Compiling entry function ")[1:]:
            name = re.match(r"'([^']+)'", block).group(1)
            if "streamed" not in name and "tiled" not in name:
                continue
            kernel = re.search(r"\d(attention_\w+?)I", name).group(1)
            kind = "bf16, " if "bfloat16Li" in name else "f32, " if "IfLi" in name else ""
            d = re.search(r"Li(\d+)E", name).group(1)
            regs = re.search(r"Used (\d+) registers", block)
            spill = re.search(r"(\d+) bytes spill stores", block)
            out[f"{kernel}<{kind}{d}>"] = [int(regs.group(1)) if regs else None,
                                           int(spill.group(1)) if spill else None]
    return out


def kernel_cases(torch, smoke, reps: int):
    import torch.nn.functional as F

    from menghini_neurips23_tpu_torch.ops.attention import attention_bwd, fused_attention

    g = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for dname, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        for B, T, W, H, mask in smoke.LONG_SHAPES:
            D = W // H
            qkv = torch.randn(B, T, 3 * W, generator=g, device="cuda").to(dt)
            grad = torch.randn(B, T, W, generator=g, device="cuda").to(dt)
            heads = [t.detach().contiguous().requires_grad_(True)
                     for t in qkv.view(B, T, 3, H, D).permute(2, 0, 3, 1, 4)]
            g_heads = grad.view(B, T, H, D).transpose(1, 2).contiguous()
            causal = mask == "causal"
            pairs = T * (T + 1) // 2 if causal else T * T
            size = qkv.element_size()
            fwd = smoke.device_ms(torch, lambda: fused_attention(qkv, mask, H), reps)
            sdpa_fwd = smoke.device_ms(torch, lambda: F.scaled_dot_product_attention(
                *heads, is_causal=causal), reps)
            bwd = smoke.device_ms(torch, lambda: attention_bwd(qkv, grad, mask, H), reps)
            sdpa_bwd = smoke.device_ms(torch, lambda: torch.autograd.grad(
                F.scaled_dot_product_attention(*heads, is_causal=causal), heads, g_heads), reps)
            fb, fb_by = smoke.bound(B * T * 4 * W * size, 4 * B * H * D * pairs, dname)
            bb, bb_by = smoke.bound(B * T * 7 * W * size, 10 * B * H * D * pairs, dname)
            case = {"shape": [B, T, W, H], "mask": mask, "dtype": dname,
                    "k1_ms": fwd, "k1_sdpa_ms": sdpa_fwd, "k1_bound_ms": fb, "k1_bound_by": fb_by,
                    "k1_share": fb / fwd,
                    "k2_ms": bwd, "k2_sdpa_ms": sdpa_bwd, "k2_bound_ms": bb, "k2_bound_by": bb_by,
                    "k2_share": bb / bwd}
            print("  " + json.dumps(case), flush=True)
            cases.append(case)
    return cases


def vpt_step(torch, smoke):
    """The bf16 VPT step at ViT-L/14 with an 80-token prompt, per-step loop."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from menghini_neurips23_tpu_torch.config import Config
    from menghini_neurips23_tpu_torch.models.prompts import init_prefix
    from menghini_neurips23_tpu_torch.runtime import ClipRuntime
    from menghini_neurips23_tpu_torch.training import VisualStrategy

    cfg = Config(VIS_ENCODER="ViT-L/14", MODEL="visual_fpl", COMPUTE_DTYPE="bfloat16",
                 BATCH_SIZE=16, OPTIM_SEED=1, PREFIX_SIZE=PREFIX)
    rt = ClipRuntime(cfg, device="cuda")
    a = rt.arch
    classes = [str(i) for i in range(10)]
    strat = VisualStrategy(cfg, {c: i for i, c in enumerate(classes)}, classes, classes,
                           classes, runtime=rt)
    strat.load_parameters([init_prefix(torch.Generator().manual_seed(7), PREFIX,
                                       a.vision_width).numpy()])
    strat._w0, strat._w1 = 8.0, 1.0
    rng = np.random.default_rng(1)
    feats = torch.from_numpy(rng.normal(0, 1, (16, 1 + a.num_patches, a.vision_width))
                             .astype(np.float32)).cuda()
    text = rng.normal(0, 1, (10, a.embed_dim)).astype(np.float32)
    ctx = torch.from_numpy(text / np.linalg.norm(text, axis=1, keepdims=True)).cuda()
    labels = torch.from_numpy(rng.integers(0, 10, 16).astype(np.int32)).cuda()
    group = (torch.arange(16, device="cuda") % 2).int()
    valid = torch.ones(16, device="cuda")

    def steps():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEPS):
            strat._apply_step(ctx, 0.0, feats, labels, group, valid)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / STEPS

    steps()
    wall = steps()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        steps()
    kernels, ops, _ = smoke.profiled_kernels(prof, STEPS)
    busy = sum(kernels.values())
    k1 = sum(ms for name, ms in kernels.items() if "attention_fwd" in name)
    k2 = sum(ms for name, ms in kernels.items() if "attention_bwd" in name)
    return {"encoder": a.name, "T": 1 + a.num_patches + PREFIX, "batch": 16,
            "wall_ms_per_step": wall, "device_busy_ms_per_step": busy,
            "device_ops_per_step": ops, "k1_ms_per_step": k1, "k2_ms_per_step": k2,
            "top_kernels_ms_per_step": dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:6])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", default=HERE)
    ap.add_argument("--label", default=None)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("streamed_attention_compare.py: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: no output",
          flush=True)
    smoke = smoke_helpers()
    from menghini_neurips23_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    _cuda.build(["attention_fwd", "attention_bwd"])
    build_s = time.perf_counter() - t0
    out = {"label": args.label or root, "root": root, "build_s": build_s, "ptxas": ptxas(_cuda),
           "kernels": kernel_cases(torch, smoke, args.reps), "vpt_step": vpt_step(torch, smoke)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
