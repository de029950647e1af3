"""Time the attention kernels of the port under ROOT on one CUDA card above
128 tokens, and the training step that runs them, so that two trees can be
compared in one call.

By default, the streamed forms (T > 320): K1 (`fused_attention`) and K2
(`attention_bwd`) at `chip_smoke.py`'s LONG_SHAPES, fp32 and bf16: device ms
per call (20 calls captured in one CUDA graph, replayed), beside
`scaled_dot_product_attention` on the same inputs (forward alone for K1;
forward + backward through autograd for K2), the bound (`chip_smoke.bound`:
bytes over the HBM rate or operations over the peak, fp32 as 3xTF32) and
bound / ms, K1's error against its plain version, a digest of its output's
bits and the most shared memory a block of it takes.  Then one bf16 VPT training step at ViT-L/14's full width with
an 80-token prompt (T = 337, the vision tower over a 16-row batch, random
weights, lr 0) in the per-step loop: wall ms on the host clock, and under
torch.profiler the device busy ms and K1's and K2's ms a step.

With --resident, K1 alone from 129 to 320 tokens: at `chip_smoke.py`'s
RESIDENT_SHAPES and ViT-L/14's two tensor-parallel shards (SHARD_SHAPES),
and, to show that they did not move, at a few lengths up to 128 and past
320; then the bf16 VPT step at ViT-L/14 with a 16-token prompt (T = 273)
and the device encode of a 256-image bf16 batch by ViT-L/14's vision tower
(T = 257), each with K1's ms; each K1 case carries a digest of the
output's bits, so that two trees' runs show whether they compute the same
bits, whether two launches give the same bits, and the most shared memory
a block of it takes; then, where the tree's kernel has the MNT_K1_PART
build flag, K1 bf16 at RESIDENT_SHAPES and the shards with its softmax
left out and with its products left out, beside the whole kernel.

With --k2-fp32, K2 alone in fp32 above 128 tokens: at the smoke's phase-3
lengths (129, 261, 273, 288, 320 at ViT-L/14's width, LONG_SHAPES and the
two ViT-L/14 vision shards) beside its plain version and SDPA's forward +
backward, and at guard shapes that should not move (fp32 up to 128 tokens,
bf16 at 273 and 337), each with a digest of the output's bits, with every
K2 entry point's registers; then the
fp32 VPT step at ViT-L/14 with a 16-token prompt (T = 273) in the per-step
loop (busy ms, K1's and K2's ms a step) and in the whole-run trainer over
3 epochs of 10 steps of the smoke's synthetic images (ms a step, epoch
ends included; busy ms and K2's ms a step).

With --twophase, K4 (`twophase_attention`, the attention experiment's
phase-grouped forward) at the smoke's TWOPHASE_SHAPES and at the longest T
one block takes at D = 64 (the first design's 176 bf16 and 144 fp32, and
the tree's own longest), in both types: device ms at the kernel's own G,
its G, blocks an SM and shared bytes; where the tree's wrapper takes a
`group`, the same at every G that divides H and fits, with whether its
output has the default's bits (on a tree without it, the default G alone);
beside them K1, SDPA's forward, the plain version, the bound and the bound
share, the errors against the plain version and K1, and a digest of the
output's bits.  Then the tree's `scripts/exp_attn_kernels.py` `twophase
fwd`, `ship fwd` and `sdpa fwd` at its default shape, one process each
(us/rep).

With --short-fp32, K1 and K2 alone in fp32 up to 128 tokens: at every
length of the smoke's phase 3 up to 128 (SHORT_FWD_SHAPES, SHORT_BWD_SHAPES
and the ViT-L/14 text tower's shard at 6 heads) beside their plain versions
and SDPA (forward; forward + backward through autograd), with the bound,
the bound share, the error against the plain version and a digest of the
output's bits, and at guard shapes that should not move (bf16 up to 128
tokens, fp32 at 273), each with its digest; then three fp32 ViT-B/32 runs,
each with the device busy ms and K1's and K2's ms inside it: the CoOp step
over 102 classes at the text tower's full length (C x 77, TEXT_TRUNCATE
off) and the VPT step with a 16-token prompt (T = 66), each in the per-step
loop and in the whole-run trainer (10 epochs of 10 steps over the smoke's
synthetic images), and the device encode of a 256-image batch (T = 50).

With --long-fp32, K1 alone in fp32 above 128 tokens (`attention_fwd_tf32`,
3xTF32 on warpgroup MMA): at `chip_smoke.py`'s RESIDENT_SHAPES, ViT-L/14's
two tensor-parallel shards and LONG_SHAPES, beside its plain version and
SDPA's forward, with the bound, the bound share, the error against the
plain version, whether two launches give the same bits and a digest of
them, and at guard shapes that should not move (bf16 at 257, 273 and 337
tokens, fp32 at 50 and 77), each with its digest, and its error at (8,
1024) with V 4x larger, both masks; then the fp32 VPT step at
ViT-L/14 with a 16-token prompt (T = 273) in the per-step loop (busy ms,
K1's and K2's ms a step) and the device encode of a 256-image fp32 batch by
ViT-L/14's vision tower (T = 257: ms, busy ms and K1's ms a batch).

Prints the card's `nvidia-smi` line, then one JSON line, which names every
K1 (or K2, or K4) entry point's registers and spill stores as ptxas reports
them.

    python3 scripts/streamed_attention_compare.py [ROOT] [--label NAME] [--reps N]
        [--resident | --k2-fp32 | --twophase | --short-fp32 | --long-fp32]

To compare with a parent commit: unpack it into a directory that .gitignore
lists (`git archive <parent> | tar -x -C build/parent`) and run parent,
current, current, parent one after another on the same card.  The helpers
(timing, bounds, shapes) come from the `chip_smoke.py` beside this script,
so both trees are measured the same way.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 10
PREFIX = 80  # ViT-L/14: T = 1 + 256 + 80 = 337
RESIDENT_PREFIX = 16  # T = 273
# K1 where it did not change: ViT-B/32 vision, the full text tower over 102
# classes, VPT's ViT-B/32 validation batch, one 128-key chunk; two streamed
# lengths
GUARD_SHAPES = [(256, 50, 768, 12, None), (102, 77, 512, 8, "causal"),
                (256, 66, 768, 12, None), (64, 128, 1024, 16, None),
                (16, 337, 1024, 16, None), (8, 1024, 1024, 16, None)]
# K2 where it should not move: fp32 up to 128 tokens (the text tower over
# 102 classes, ViT-B/32 vision), bf16 resident (273) and streamed (337)
K2_GUARD_SHAPES = [("float32", (102, 77, 512, 8, "causal")), ("float32", (256, 50, 768, 12, None)),
                   ("bfloat16", (16, 273, 1024, 16, None)), ("bfloat16", (16, 337, 1024, 16, None))]


# K1 and K2 where --short-fp32 should not move them: bf16 up to 128 tokens
# (ViT-B/32 vision, the full text tower over 102 classes) and fp32 above
# 128 (ViT-L/14 with a 16-token VPT prompt)
SHORT_GUARD_SHAPES = [("bfloat16", (256, 50, 768, 12, None)),
                      ("bfloat16", (102, 77, 512, 8, "causal")),
                      ("float32", (16, 273, 1024, 16, None))]


# K1 where --long-fp32 should not move it: bf16 above 128 tokens (ViT-L/14's
# frozen pass over 8 images, VPT's 16- and 80-token prompts) and fp32 up to
# 128 (ViT-B/32 vision, the full text tower over 102 classes)
LONG_FP32_GUARD_SHAPES = [("bfloat16", (8, 257, 1024, 16, None)),
                          ("bfloat16", (16, 273, 1024, 16, None)),
                          ("bfloat16", (16, 337, 1024, 16, None)),
                          ("float32", (256, 50, 768, 12, None)),
                          ("float32", (102, 77, 512, 8, "causal"))]


def smoke_helpers():
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers",
                                                  os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ptxas(_cuda, libs, forms):
    """{kernel<type, D[, KC or resident]>: [registers, spill-store bytes]}
    of the entry points of `libs` whose names hold one of `forms`, from the
    compiler's report beside the libraries."""
    import re

    out = {}
    for lib in libs:
        for block in _cuda.build_log(lib).split("Compiling entry function ")[1:]:
            name = re.match(r"'([^']+)'", block).group(1)
            if not any(f in name for f in forms):
                continue
            kernel = re.search(r"\d((?:attention|twophase)\w*?)I", name).group(1)
            kind = "bf16, " if "bfloat16Li" in name else "f32, " if "IfLi" in name else ""
            ints = ", ".join(re.findall(r"L[ib](\d+)E", name))
            regs = re.search(r"Used (\d+) registers", block)
            spill = re.search(r"(\d+) bytes spill stores", block)
            out[f"{kernel}<{kind}{ints}>"] = [int(regs.group(1)) if regs else None,
                                              int(spill.group(1)) if spill else None]
    return out


def kernel_cases(torch, smoke, reps: int):
    import torch.nn.functional as F

    from menghini_neurips23_tpu_torch.ops.attention import (
        attention_bwd,
        attention_reference,
        fused_attention,
    )

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
            out = fused_attention(qkv, mask, H)
            err = (out.float() - attention_reference(qkv, mask, H).float()).abs().max().item()
            bits = digest(torch, out)
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
                    "k1_share": fb / fwd, "k1_max_abs_err": err, "k1_digest": bits,
                    "k1_smem_max": smem_max(torch, T, D, dt),
                    "k2_ms": bwd, "k2_sdpa_ms": sdpa_bwd, "k2_bound_ms": bb, "k2_bound_by": bb_by,
                    "k2_share": bb / bwd}
            print("  " + json.dumps(case), flush=True)
            cases.append(case)
    return cases


def resident_cases(torch, smoke, reps: int):
    """K1 alone at the resident lengths, ViT-L/14's shards and GUARD_SHAPES."""
    import torch.nn.functional as F

    from menghini_neurips23_tpu_torch.ops.attention import fused_attention

    g = torch.Generator(device="cuda").manual_seed(0)
    shapes = smoke.RESIDENT_SHAPES + [s[:5] for s in smoke.SHARD_SHAPES if s[1] > 128]
    cases = []
    for dname, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        for B, T, W, H, mask in shapes + GUARD_SHAPES:
            D = W // H
            qkv = torch.randn(B, T, 3 * W, generator=g, device="cuda").to(dt)
            heads = [t.contiguous() for t in qkv.view(B, T, 3, H, D).permute(2, 0, 3, 1, 4)]
            causal = mask == "causal"
            pairs = T * (T + 1) // 2 if causal else T * T
            first, again = fused_attention(qkv, mask, H), fused_attention(qkv, mask, H)
            bits = digest(torch, first)
            fwd = smoke.device_ms(torch, lambda: fused_attention(qkv, mask, H), reps)
            sdpa = smoke.device_ms(torch, lambda: F.scaled_dot_product_attention(
                *heads, is_causal=causal), reps)
            fb, fb_by = smoke.bound(B * T * 4 * W * qkv.element_size(), 4 * B * H * D * pairs,
                                    dname)
            case = {"shape": [B, T, W, H], "mask": mask, "dtype": dname, "k1_ms": fwd,
                    "k1_sdpa_ms": sdpa, "k1_bound_ms": fb, "k1_bound_by": fb_by,
                    "k1_share": fb / fwd, "k1_digest": bits,
                    "k1_bit_identical": torch.equal(first.view(torch.uint8),
                                                    again.view(torch.uint8)),
                    "k1_smem_max": smem_max(torch, T, D, dt),
                    "guard": (B, T, W, H, mask) in GUARD_SHAPES}
            print("  " + json.dumps(case), flush=True)
            cases.append(case)
            del qkv, heads, first, again
    return cases


def split_cases(torch, smoke, reps: int):
    """K1 bf16 from 129 to 320 tokens with its softmax left out and with its
    products left out (the kernel's MNT_K1_PART build flag, 1 and 2), beside
    the whole kernel, at RESIDENT_SHAPES and the ViT-L/14 shards; a tree
    whose kernel has no such flag gives a note instead."""
    import ctypes

    from menghini_neurips23_tpu_torch.ops import _cuda
    from menghini_neurips23_tpu_torch.ops.attention import _FWD_SIGNATURES, fused_attention

    src = os.path.join(_cuda.CSRC_DIR, "attention_fwd.cu")
    with open(src) as f:
        if "MNT_K1_PART" not in f.read():
            return "the tree's attention_fwd.cu has no MNT_K1_PART build flag"
    out_dir = os.path.join(_cuda.build_dir(), "split")
    os.makedirs(out_dir, exist_ok=True)
    builds = {part: subprocess.Popen(
        [_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, f"-DMNT_K1_PART={part}", "-o",
         os.path.join(out_dir, f"libattention_fwd_part{part}.so"), src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for part in (1, 2)}
    fns = {}
    for part, proc in builds.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"MNT_K1_PART={part}: nvcc failed:\n{log.decode()[-3000:]}")
        lib = ctypes.CDLL(os.path.join(out_dir, f"libattention_fwd_part{part}.so"))
        fn = lib.mnt_attention_fwd
        fn.argtypes, fn.restype = _FWD_SIGNATURES["mnt_attention_fwd"]
        fns[part] = fn

    g = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for B, T, W, H, mask in smoke.RESIDENT_SHAPES + [s[:5] for s in smoke.SHARD_SHAPES
                                                     if s[1] > 128]:
        qkv = torch.randn(B, T, 3 * W, generator=g, device="cuda").to(torch.bfloat16)
        out = torch.empty(B, T, W, dtype=torch.bfloat16, device="cuda")

        def part(fn):
            err = fn(qkv.data_ptr(), out.data_ptr(), B, T, W, H, (W // H) ** -0.5,
                     int(mask == "causal"), 1, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"MNT_K1_PART launch: CUDA error {err}")

        case = {"shape": [B, T, W, H], "mask": mask,
                "k1_ms": smoke.device_ms(torch, lambda: fused_attention(qkv, mask, H), reps),
                "products_ms": smoke.device_ms(torch, lambda: part(fns[1]), reps),
                "softmax_ms": smoke.device_ms(torch, lambda: part(fns[2]), reps)}
        print("  split " + json.dumps(case), flush=True)
        cases.append(case)
    return cases


def k2_fp32_cases(torch, smoke, reps: int):
    """K2 fp32 above 128 tokens, then K2_GUARD_SHAPES, each with a digest."""
    import torch.nn.functional as F

    from menghini_neurips23_tpu_torch.ops.attention import attention_bwd, attention_bwd_reference

    g = torch.Generator(device="cuda").manual_seed(0)
    long = [(16, t, 1024, 16, None) for t in (129, 261, 273, 288, 320)] + smoke.LONG_SHAPES + [
        sh[:5] for sh in smoke.SHARD_SHAPES if sh[1] > 128]
    cases = []
    for dname, shape, guard in ([("float32", sh, False) for sh in long]
                                + [(d, sh, True) for d, sh in K2_GUARD_SHAPES]):
        B, T, W, H, mask = shape
        D = W // H
        dt = getattr(torch, dname)
        qkv = torch.randn(B, T, 3 * W, generator=g, device="cuda").to(dt)
        grad = torch.randn(B, T, W, generator=g, device="cuda").to(dt)
        heads = [t.detach().contiguous().requires_grad_(True)
                 for t in qkv.view(B, T, 3, H, D).permute(2, 0, 3, 1, 4)]
        g_heads = grad.view(B, T, H, D).transpose(1, 2).contiguous()
        causal = mask == "causal"
        pairs = T * (T + 1) // 2 if causal else T * T
        out = attention_bwd(qkv, grad, mask, H)
        ref = attention_bwd_reference(qkv, grad, mask, H)
        diff = (out.float() - ref.float()).abs()
        bits = digest(torch, out)
        bwd = smoke.device_ms(torch, lambda: attention_bwd(qkv, grad, mask, H), reps)
        plain = smoke.device_ms(torch, lambda: attention_bwd_reference(qkv, grad, mask, H), reps)
        sdpa = smoke.device_ms(torch, lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(*heads, is_causal=causal), heads, g_heads), reps)
        bb, bb_by = smoke.bound(B * T * 7 * W * qkv.element_size(), 10 * B * H * D * pairs,
                                dname)
        case = {"shape": [B, T, W, H], "mask": mask, "dtype": dname, "guard": guard,
                "k2_ms": bwd, "k2_plain_ms": plain, "k2_sdpa_ms": sdpa, "k2_bound_ms": bb,
                "k2_bound_by": bb_by, "k2_share": bb / bwd, "k2_digest": bits,
                "max_abs_err": diff.max().item(),
                "rel_excess": ((diff - smoke.ATTN_TOL[dname] * ref.float().abs()).max().item())}
        print("  " + json.dumps(case), flush=True)
        cases.append(case)
        del qkv, grad, heads, g_heads, out, ref, diff
    return cases


def short_fp32_cases(torch, smoke, reps: int):
    """K1 and K2 fp32 up to 128 tokens at the smoke's phase-3 shapes, then
    SHORT_GUARD_SHAPES, each with the error against its plain version and a
    digest of its output's bits."""
    import torch.nn.functional as F

    from menghini_neurips23_tpu_torch.ops.attention import (
        attention_bwd,
        attention_bwd_reference,
        attention_reference,
        fused_attention,
    )

    g = torch.Generator(device="cuda").manual_seed(0)
    shard = [sh[:5] for sh in smoke.SHARD_SHAPES if sh[1] <= 128]
    fwd = smoke.SHORT_FWD_SHAPES + shard
    bwd = smoke.SHORT_BWD_SHAPES + shard
    runs = ([("float32", sh, "k1", False) for sh in fwd]
            + [("float32", sh, "k2", False) for sh in bwd]
            + [(d, sh, k, True) for d, sh in SHORT_GUARD_SHAPES for k in ("k1", "k2")])
    cases = []
    for dname, (B, T, W, H, mask), kernel, guard in runs:
        D = W // H
        dt = getattr(torch, dname)
        causal = mask == "causal"
        pairs = T * (T + 1) // 2 if causal else T * T
        size = 4 if dt == torch.float32 else 2
        qkv = torch.randn(B, T, 3 * W, generator=g, device="cuda").to(dt)
        heads = [t.detach().contiguous().requires_grad_(True)
                 for t in qkv.view(B, T, 3, H, D).permute(2, 0, 3, 1, 4)]
        if kernel == "k1":
            run = lambda: fused_attention(qkv, mask, H)  # noqa: E731
            plain = lambda: attention_reference(qkv, mask, H)  # noqa: E731
            sdpa = lambda: F.scaled_dot_product_attention(*heads, is_causal=causal)  # noqa: E731
            bound = smoke.bound(B * T * 4 * W * size, 4 * B * H * D * pairs, dname)
        else:
            grad = torch.randn(B, T, W, generator=g, device="cuda").to(dt)
            g_heads = grad.view(B, T, H, D).transpose(1, 2).contiguous()
            run = lambda: attention_bwd(qkv, grad, mask, H)  # noqa: E731
            plain = lambda: attention_bwd_reference(qkv, grad, mask, H)  # noqa: E731
            sdpa = lambda: torch.autograd.grad(  # noqa: E731
                F.scaled_dot_product_attention(*heads, is_causal=causal), heads, g_heads)
            bound = smoke.bound(B * T * 7 * W * size, 10 * B * H * D * pairs, dname)
        out, ref = run(), plain().float()
        diff = (out.float() - ref).abs()
        ms = smoke.device_ms(torch, run, reps)
        case = {"kernel": kernel, "shape": [B, T, W, H], "mask": mask, "dtype": dname,
                "guard": guard, "ms": ms, "plain_ms": smoke.device_ms(torch, plain, reps),
                "sdpa_ms": smoke.device_ms(torch, sdpa, reps), "bound_ms": bound[0],
                "bound_by": bound[1], "share": bound[0] / ms, "digest": digest(torch, out),
                "max_abs_err": diff.max().item(),
                "rel_excess": (diff - smoke.ATTN_TOL[dname] * ref.abs()).max().item()}
        print("  " + json.dumps(case), flush=True)
        cases.append(case)
        del qkv, heads, out, ref, diff
    return cases


def long_fp32_cases(torch, smoke, reps: int):
    """K1 fp32 above 128 tokens, then LONG_FP32_GUARD_SHAPES, each with the
    error against its plain version and a digest of its output's bits."""
    import torch.nn.functional as F

    from menghini_neurips23_tpu_torch.ops.attention import attention_reference, fused_attention

    g = torch.Generator(device="cuda").manual_seed(0)
    long = (smoke.RESIDENT_SHAPES + [sh[:5] for sh in smoke.SHARD_SHAPES if sh[1] > 128]
            + smoke.LONG_SHAPES)
    cases = []
    for dname, (B, T, W, H, mask), guard in ([("float32", sh, False) for sh in long]
                                             + [(d, sh, True) for d, sh in LONG_FP32_GUARD_SHAPES]):
        D = W // H
        dt = getattr(torch, dname)
        causal = mask == "causal"
        pairs = T * (T + 1) // 2 if causal else T * T
        qkv = torch.randn(B, T, 3 * W, generator=g, device="cuda").to(dt)
        heads = [t.contiguous() for t in qkv.view(B, T, 3, H, D).permute(2, 0, 3, 1, 4)]
        out, again = fused_attention(qkv, mask, H), fused_attention(qkv, mask, H)
        err = (out.float() - attention_reference(qkv, mask, H).float()).abs().max().item()
        ms = smoke.device_ms(torch, lambda: fused_attention(qkv, mask, H), reps)
        bound = smoke.bound(B * T * 4 * W * qkv.element_size(), 4 * B * H * D * pairs, dname)
        case = {"shape": [B, T, W, H], "mask": mask, "dtype": dname, "guard": guard, "ms": ms,
                "plain_ms": smoke.device_ms(torch, lambda: attention_reference(qkv, mask, H),
                                            reps),
                "sdpa_ms": smoke.device_ms(torch, lambda: F.scaled_dot_product_attention(
                    *heads, is_causal=causal), reps),
                "bound_ms": bound[0], "bound_by": bound[1], "share": bound[0] / ms,
                "max_abs_err": err, "tol": smoke.ATTN_TOL[dname],
                "bit_identical": torch.equal(out.view(torch.uint8), again.view(torch.uint8)),
                "digest": digest(torch, out), "smem_max": smem_max(torch, T, D, dt)}
        print("  " + json.dumps(case), flush=True)
        cases.append(case)
        del qkv, heads, out, again
    # (8, 1024) with V 4x larger, both masks: the error of the tensor cores'
    # truncating sums grows with the values summed
    for mask in ("causal", None):
        qkv = torch.randn(8, 1024, 3 * 1024, generator=g, device="cuda")
        qkv[..., 2 * 1024:] *= 4
        out = fused_attention(qkv, mask, 16)
        case = {"shape": [8, 1024, 1024, 16], "mask": mask, "dtype": "float32", "v_scale": 4,
                "max_abs_err": (out - attention_reference(qkv, mask, 16)).abs().max().item(),
                "tol": smoke.ATTN_TOL["float32"], "digest": digest(torch, out)}
        print("  " + json.dumps(case), flush=True)
        cases.append(case)
        del qkv, out
    return cases


def smem_max(torch, T, D, dt) -> int:
    """The most dynamic shared memory a block of K1 takes at (T, D, dt), as
    the tree's library reports it."""
    from menghini_neurips23_tpu_torch.ops import _cuda
    from menghini_neurips23_tpu_torch.ops.attention import _DTYPE_CODES, _FWD_SIGNATURES

    return _cuda.library("attention_fwd", _FWD_SIGNATURES).mnt_attention_fwd_smem(
        T, D, _DTYPE_CODES[dt])


def digest(torch, t) -> str:
    return hashlib.sha1(t.view(torch.uint8).cpu().numpy().tobytes()).hexdigest()[:16]


def twophase_cases(torch, smoke, reps: int):
    """K4 at TWOPHASE_SHAPES and the longest T, each with its G sweep."""
    import inspect

    import torch.nn.functional as F

    from menghini_neurips23_tpu_torch.ops import _cuda
    from menghini_neurips23_tpu_torch.ops.attention import (
        _DTYPE_CODES,
        _MAX_SMEM_BYTES,
        fused_attention,
    )

    # the module (the package's `ops` exports its function under the same name)
    k4mod = importlib.import_module("menghini_neurips23_tpu_torch.ops.twophase_attention")
    k4, plain = k4mod.twophase_attention, k4mod.twophase_attention_reference
    sweeps = "group" in inspect.signature(k4).parameters  # the tree's wrapper takes a G
    lib = _cuda.library("twophase_attention", k4mod._SIGNATURES)

    def fits(T, D, G, dt):
        return k4mod.twophase_smem_bytes(T, D, G, dt) <= _MAX_SMEM_BYTES

    def longest(dt):
        if sweeps:
            return max(t for t in range(1, 513) if fits(t, 64, 1, dt))
        return max(t for t in range(1, 513)
                   if lib.mnt_twophase_attention_groups(t, 64, 12, _DTYPE_CODES[dt]))

    g = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for dname, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        code, tol = _DTYPE_CODES[dt], smoke.ATTN_TOL[dname]
        # the first design's longest T and this one's (a tree that takes fewer refuses)
        lengths = sorted(({144, 176} if dt == torch.float32 else {176, 192}) | {longest(dt)})
        for B, T, W, H in smoke.TWOPHASE_SHAPES + [(8, t, 768, 12) for t in lengths]:
            D = W // H
            qkv = torch.randn(B, T, 3 * W, generator=g, device="cuda").to(dt)
            case = {"shape": [B, T, W, H], "dtype": dname}
            try:
                out = k4(qkv, H)
            except ValueError as e:
                case["refused"] = str(e)
                print("  " + json.dumps(case), flush=True)
                cases.append(case)
                continue
            again = k4(qkv, H)
            ref = plain(qkv, H).float()
            k1 = fused_attention(qkv, None, H).float()
            q, k, v = (t.contiguous() for t in qkv.view(B, T, 3, H, D).permute(2, 0, 3, 1, 4))
            b_ms, b_by = smoke.bound(B * T * 4 * W * qkv.element_size(), 4 * B * H * D * T * T,
                                     dname)
            ms = smoke.device_ms(torch, lambda: k4(qkv, H), reps)
            case.update(
                ms=ms, digest=digest(torch, out),
                bit_identical=torch.equal(out.view(torch.uint8), again.view(torch.uint8)),
                max_abs_err=(out.float() - ref).abs().max().item(),
                max_abs_err_vs_k1=(out.float() - k1).abs().max().item(), tol=tol,
                k1_ms=smoke.device_ms(torch, lambda: fused_attention(qkv, None, H), reps),
                sdpa_ms=smoke.device_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v),
                                        reps),
                plain_ms=smoke.device_ms(torch, lambda: plain(qkv, H), reps),
                bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / ms)
            if sweeps:
                G = lib.mnt_twophase_attention_groups(B, T, D, H, code)
                case.update(group=G, blocks_per_sm=lib.mnt_twophase_attention_blocks_per_sm(
                    T, D, H, code, G), smem_bytes=lib.mnt_twophase_attention_smem(T, D, G, code))
                case["groups"] = []
                for G in (G for G in range(1, H + 1) if H % G == 0 and fits(T, D, G, dt)):
                    og = k4(qkv, H, group=G)
                    case["groups"].append({
                        "group": G, "ms": smoke.device_ms(torch, lambda: k4(qkv, H, group=G),
                                                          reps),
                        "blocks_per_sm": lib.mnt_twophase_attention_blocks_per_sm(
                            T, D, H, code, G),
                        "smem_bytes": lib.mnt_twophase_attention_smem(T, D, G, code),
                        "same_bits": torch.equal(og.view(torch.uint8), out.view(torch.uint8))})
            else:
                case.update(group=lib.mnt_twophase_attention_groups(T, D, H, code),
                            smem_bytes=lib.mnt_twophase_attention_smem(T, D, H, code),
                            groups="the wrapper takes no group: the default G alone")
            print("  " + json.dumps(case), flush=True)
            cases.append(case)
            del qkv, out, again, ref, k1, q, k, v
    return cases


def experiment(root: str):
    """The tree's scripts/exp_attn_kernels.py, fwd at its default shape: us/rep
    of twophase, ship and sdpa, one process each."""
    import re

    res = {}
    for variant in ("twophase", "ship", "sdpa"):
        done = subprocess.run([sys.executable, os.path.join(root, "scripts", "exp_attn_kernels.py"),
                               variant, "fwd", "100"], capture_output=True, text=True,
                              timeout=600, cwd=root)
        hit = re.search(r"RESULT \S+: ([0-9.]+) us/rep", done.stdout)
        res[f"{variant} fwd"] = float(hit.group(1)) if hit else (
            f"exit {done.returncode}: {done.stderr.strip()[-300:]}")
    return res


def vit_l14_runtime(torch, prefix: int, dtype: str = "bfloat16", encoder: str = "ViT-L/14",
                    model: str = "visual_fpl", **extra):
    """(config, runtime) of `model` at `encoder` in `dtype` (ViT-L/14 VPT by
    default) with random weights."""
    from menghini_neurips23_tpu_torch.config import Config
    from menghini_neurips23_tpu_torch.runtime import ClipRuntime

    cfg = Config(VIS_ENCODER=encoder, MODEL=model, COMPUTE_DTYPE=dtype,
                 BATCH_SIZE=16, OPTIM_SEED=1, PREFIX_SIZE=prefix, **extra)
    return cfg, ClipRuntime(cfg, device="cuda")


def encode_256(torch, smoke, rt, n: int = 5):
    """The device encode of one 256-image batch by the runtime's vision
    tower (ViT-L/14: T = 257; ViT-B/32: T = 50) in its type: ms a batch on
    CUDA events (eager), and under torch.profiler the device busy ms and
    K1's ms a batch."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device="cuda").manual_seed(3)
    batch = torch.randint(0, 256, (256, 224, 224, 3), generator=g, device="cuda",
                          dtype=torch.uint8)
    with torch.inference_mode():
        ms = smoke.eager_ms(torch, lambda: rt._encode_images(batch), reps=n)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                rt._encode_images(batch)
            torch.cuda.synchronize()
    kernels, ops, _ = smoke.profiled_kernels(prof, n)
    return {"encoder": rt.arch.name, "dtype": rt.cfg.COMPUTE_DTYPE, "batch": 256,
            "T": 1 + rt.arch.num_patches,
            "encode_ms": ms, "device_busy_ms": sum(kernels.values()), "device_ops": ops,
            "k1_ms": sum(v for k, v in kernels.items() if "attention_fwd" in k)}


def vpt_strategy(torch, runtime, prefix: int):
    """A VPT strategy over 10 classes on `runtime` with a seeded prompt."""
    from menghini_neurips23_tpu_torch.models.prompts import init_prefix
    from menghini_neurips23_tpu_torch.training import VisualStrategy

    cfg, rt = runtime
    classes = [str(i) for i in range(10)]
    strat = VisualStrategy(cfg, {c: i for i, c in enumerate(classes)}, classes, classes,
                           classes, runtime=rt)
    strat.load_parameters([init_prefix(torch.Generator().manual_seed(7), prefix,
                                       rt.arch.vision_width).numpy()])
    return strat


def coop_strategy(torch, runtime, n_classes: int = 102):
    """A CoOp strategy over `n_classes` classes on `runtime` (its prefix
    drawn from OPTIM_SEED)."""
    from menghini_neurips23_tpu_torch.training import TextualStrategy

    cfg, rt = runtime
    classes = [f"class {i}" for i in range(n_classes)]
    return TextualStrategy(cfg, {c: i for i, c in enumerate(classes)}, classes, classes,
                           classes, runtime=rt)


def whole_run(torch, smoke, strat, epochs: int = 3):
    """The whole-run trainer of `strat` over 160 of the smoke's synthetic
    images (10 batches of 16, labels drawn over its classes) for `epochs`
    epochs, validating on 32 more: three runs on the same graphs, the first
    capturing, the second on the host clock (ms a step = its wall / its
    steps, epoch ends included), the third under torch.profiler (busy ms and
    K1's and K2's ms a step)."""
    import copy

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    root = os.path.join(HERE, "build", "compare_data")
    if not os.path.exists(os.path.join(root, "train.txt")):
        shutil.rmtree(root, ignore_errors=True)
        smoke.make_dataset(root)
    with open(os.path.join(root, "train.txt")) as f:
        files = [os.path.join(root, "train", l.split()[0]) for l in f if l.strip()]
    cfg = strat.config
    cfg.EPOCHS = epochs
    labels = np.random.default_rng(0).choice(len(strat.classes), 192)
    train, val = smoke.Rows(files[:160], labels[:160]), smoke.Rows(files[160:192], labels[160:192])

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        strat.train(copy.deepcopy(train), copy.deepcopy(val))
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    strat._fused_keep = True  # the graphs of the first run serve the next two
    try:
        first = run()
        info = dict(strat._fused_info)
        wall = run()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
    finally:
        strat._fused_keep = False
        strat._fused_free()
    steps = epochs * info["steps_per_epoch"]
    kernels, ops, _ = smoke.profiled_kernels(prof, steps)
    busy = sum(kernels.values())
    k1 = sum(ms for name, ms in kernels.items() if "attention_fwd" in name)
    k2 = sum(ms for name, ms in kernels.items() if "attention_bwd" in name)
    return {"model": cfg.MODEL, "encoder": cfg.VIS_ENCODER, "dtype": cfg.COMPUTE_DTYPE,
            "classes": len(strat.classes), "epochs": epochs, "steps": steps,
            "graphs": info["graphs"], "first_run_s": first,
            "wall_ms_per_step": wall * 1e3 / steps, "device_busy_ms_per_step": busy,
            "device_ops_per_step": ops, "k1_ms_per_step": k1, "k2_ms_per_step": k2,
            "k2_share_of_busy": k2 / busy if busy else None}


def vpt_step(torch, smoke, prefix: int = PREFIX, runtime=None):
    """The VPT step at ViT-L/14 with a `prefix`-token prompt (bf16 unless
    `runtime` says otherwise), per-step loop."""
    import numpy as np

    runtime = runtime or vit_l14_runtime(torch, prefix)
    a = runtime[1].arch
    rng = np.random.default_rng(1)
    feats = torch.from_numpy(rng.normal(0, 1, (16, 1 + a.num_patches, a.vision_width))
                             .astype(np.float32)).cuda()
    text = rng.normal(0, 1, (10, a.embed_dim)).astype(np.float32)
    ctx = torch.from_numpy(text / np.linalg.norm(text, axis=1, keepdims=True)).cuda()
    out = train_step(torch, smoke, vpt_strategy(torch, runtime, prefix), ctx, feats, rng)
    return {"T": 1 + a.num_patches + prefix, **out}


def coop_step(torch, smoke, strat):
    """The CoOp step of `strat` over its classes' token ids (its text tower
    over C x the ids' length), per-step loop, on 16 random unit image
    features."""
    import numpy as np

    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (16, strat.runtime.arch.embed_dim)).astype(np.float32)
    feats = torch.from_numpy(x / np.linalg.norm(x, axis=1, keepdims=True)).cuda()
    ctx = strat._class_context(strat.classes)
    return {"text": list(ctx.shape), **train_step(torch, smoke, strat, ctx, feats, rng)}


def train_step(torch, smoke, strat, ctx, feats, rng):
    """STEPS steps of `strat` (lr 0) on one 16-row batch in the per-step
    loop: wall ms a step on the host clock, then under torch.profiler the
    device busy ms and K1's and K2's ms a step."""
    from torch.profiler import ProfilerActivity, profile

    cfg, a = strat.config, strat.runtime.arch
    strat._w0, strat._w1 = 8.0, 1.0
    labels = torch.from_numpy(rng.integers(0, len(strat.classes), 16).astype("int32")).cuda()
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
    return {"model": cfg.MODEL, "encoder": a.name, "batch": 16, "dtype": cfg.COMPUTE_DTYPE,
            "wall_ms_per_step": wall, "device_busy_ms_per_step": busy,
            "device_ops_per_step": ops, "k1_ms_per_step": k1, "k2_ms_per_step": k2,
            "top_kernels_ms_per_step": dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:6])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", default=HERE)
    ap.add_argument("--label", default=None)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--resident", action="store_true",
                    help="K1 from 129 to 320 tokens, the T = 273 VPT step, the ViT-L/14 encode")
    ap.add_argument("--k2-fp32", action="store_true",
                    help="K2 fp32 above 128 tokens, guard shapes, the fp32 T = 273 VPT step")
    ap.add_argument("--short-fp32", action="store_true",
                    help="K1 and K2 fp32 up to 128 tokens, guard shapes, the fp32 ViT-B/32 "
                         "CoOp and VPT steps and encode")
    ap.add_argument("--long-fp32", action="store_true",
                    help="K1 fp32 above 128 tokens, guard shapes, the fp32 T = 273 VPT step "
                         "and the fp32 ViT-L/14 encode")
    ap.add_argument("--twophase", action="store_true",
                    help="K4 at the smoke's shapes and its longest T, with its G sweep, "
                         "and the attention experiment's fwd")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    import torch

    if not torch.cuda.is_available():
        print("streamed_attention_compare.py: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, root)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: no output",
          flush=True)
    smoke = smoke_helpers()
    from menghini_neurips23_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    _cuda.build(["attention_fwd", "twophase_attention"] if args.twophase
                else ["attention_fwd", "attention_bwd"])
    out = {"label": args.label or root, "root": root, "build_s": time.perf_counter() - t0}
    if args.twophase:
        out["ptxas"] = ptxas(_cuda, ["twophase_attention"], ["twophase"])
        out["kernels"] = twophase_cases(torch, smoke, args.reps)
        out["experiment"] = experiment(root)
    elif args.short_fp32:
        out["ptxas"] = ptxas(_cuda, ["attention_fwd", "attention_bwd"],
                             ["attention_fwd_f32", "attention_bwd_f32", "attention_fwd_bf16",
                              "attention_bwd_bf16"])
        out["kernels"] = short_fp32_cases(torch, smoke, args.reps)
        coop = coop_strategy(torch, vit_l14_runtime(
            torch, 16, "float32", "ViT-B/32", "textual_fpl", TEXT_TRUNCATE=False))
        out["coop_step"] = coop_step(torch, smoke, coop)
        out["coop_whole_run"] = whole_run(torch, smoke, coop, epochs=10)
        del coop
        runtime = vit_l14_runtime(torch, RESIDENT_PREFIX, "float32", "ViT-B/32")
        out["vpt_step"] = vpt_step(torch, smoke, RESIDENT_PREFIX, runtime)
        out["vpt_whole_run"] = whole_run(torch, smoke,
                                         vpt_strategy(torch, runtime, RESIDENT_PREFIX), epochs=10)
        out["encode"] = encode_256(torch, smoke, runtime[1])
    elif args.long_fp32:
        out["ptxas"] = ptxas(_cuda, ["attention_fwd"], ["attention_fwd"])
        out["kernels"] = long_fp32_cases(torch, smoke, args.reps)
        runtime = vit_l14_runtime(torch, RESIDENT_PREFIX, "float32")
        out["vpt_step"] = vpt_step(torch, smoke, RESIDENT_PREFIX, runtime)
        out["encode"] = encode_256(torch, smoke, runtime[1])
    elif args.k2_fp32:
        out["ptxas"] = ptxas(_cuda, ["attention_bwd"], ["attention_bwd"])
        out["kernels"] = k2_fp32_cases(torch, smoke, args.reps)
        runtime = vit_l14_runtime(torch, RESIDENT_PREFIX, "float32")
        out["vpt_step"] = vpt_step(torch, smoke, RESIDENT_PREFIX, runtime)
        out["vpt_whole_run"] = whole_run(torch, smoke,
                                         vpt_strategy(torch, runtime, RESIDENT_PREFIX))
    elif args.resident:
        out["ptxas"] = ptxas(_cuda, ["attention_fwd"], ["attention_fwd"])
        out["kernels"] = resident_cases(torch, smoke, args.reps)
        out["split"] = split_cases(torch, smoke, args.reps)
        runtime = vit_l14_runtime(torch, RESIDENT_PREFIX)
        out["encode"] = encode_256(torch, smoke, runtime[1])
        out["vpt_step"] = vpt_step(torch, smoke, RESIDENT_PREFIX, runtime)
    else:
        out["ptxas"] = ptxas(_cuda, ["attention_fwd", "attention_bwd"],
                             ["streamed", "tiled", "wgmma"])
        out["kernels"] = kernel_cases(torch, smoke, args.reps)
        out["vpt_step"] = vpt_step(torch, smoke)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
