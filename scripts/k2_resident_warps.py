#!/usr/bin/env python3
"""Warps per block of K2's bf16 kernel above 128 tokens, measured on the card.

Builds a copy of csrc/attention_bwd.cu for each most-warps count (its
kResidentWarps set to the count; one nvcc each, all at once) in
build/k2_warps/, prints what ptxas reports for the bf16 kernel of each build,
then holds each build against the plain version at ViT-L/14's shapes (bf16,
W 1024, 16 heads) and times it by CUDA-graph replay, as chip_smoke.py's
phase 3 does.  Each line names the warps the build launches at that length.

    python3 scripts/k2_resident_warps.py [8 10 12]     # from the repository root; one card
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(16, 273), (16, 261), (16, 129), (16, 288), (16, 320)]  # (B, T), W 1024, 16 heads
CONSTANT = "constexpr int kResidentWarps = 10;"  # the kernel's own count


def main(argv) -> int:
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("k2_resident_warps.py: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke
    from menghini_neurips23_tpu_torch.ops import _cuda
    from menghini_neurips23_tpu_torch.ops.attention import _BWD_SIGNATURES, attention_bwd_reference

    counts = [int(a) for a in argv] or [8, 10, 12]
    out_dir = os.path.join(ROOT, "build", "k2_warps")
    os.makedirs(out_dir, exist_ok=True)
    shutil.copy(os.path.join(_cuda.CSRC_DIR, "attention_common.cuh"), out_dir)
    with open(os.path.join(_cuda.CSRC_DIR, "attention_bwd.cu")) as f:
        src = f.read()
    if src.count(CONSTANT) != 1:
        raise RuntimeError(f"csrc/attention_bwd.cu does not define {CONSTANT!r} once")
    procs = {}
    t0 = time.perf_counter()
    for n in counts:
        path = os.path.join(out_dir, f"attention_bwd_w{n}.cu")
        with open(path, "w") as f:
            f.write(src.replace(CONSTANT, f"constexpr int kResidentWarps = {n};"))
        procs[n] = subprocess.Popen(
            [_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, "-o", os.path.join(out_dir, f"libk2_w{n}.so"),
             path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    logs = {n: p.communicate()[0].decode(errors="replace") for n, p in procs.items()}
    print(f"built {counts} in {time.perf_counter() - t0:.1f} s", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    g = torch.Generator(device="cuda").manual_seed(1)
    inputs = {}
    for B, T in SHAPES:
        qkv = torch.randn(B, T, 3 * 1024, generator=g, device="cuda").bfloat16()
        grad = torch.randn(B, T, 1024, generator=g, device="cuda").bfloat16()
        inputs[(B, T)] = (qkv, grad, attention_bwd_reference(qkv, grad, None, 16).float())
    for n in counts:
        if procs[n].returncode != 0:
            print(json.dumps({"warps": n, "build": "failed", "log": logs[n][-2000:]}), flush=True)
            continue
        # ptxas names each function, then reports its spills, then its registers
        report = re.findall(r"Compiling entry function '(\w*resident\w*)'.*?"
                            r"(\d+) bytes spill stores.*?Used (\d+) registers", logs[n], re.S)
        lib = ctypes.CDLL(os.path.join(out_dir, f"libk2_w{n}.so"))
        for symbol, (argtypes, restype) in _BWD_SIGNATURES.items():
            getattr(lib, symbol).argtypes, getattr(lib, symbol).restype = argtypes, restype
        for (B, T), (qkv, grad, ref) in inputs.items():
            out = torch.empty_like(qkv)

            def call():
                code = lib.mnt_attention_bwd(
                    qkv.data_ptr(), grad.data_ptr(), out.data_ptr(), None, B, T, 1024, 16,
                    64 ** -0.5, 0, 1, torch.cuda.current_stream().cuda_stream)
                if code:
                    raise RuntimeError(lib.mnt_error_string(code).decode())

            call()
            torch.cuda.synchronize()
            diff = (out.float() - ref).abs()
            ok = bool((diff <= 2e-2 + 2e-2 * ref.abs()).all())
            rec = {"most_warps": n, "warps": lib.mnt_attention_bwd_warps(T, 64, 1, B * 16),
                   "shape": [B, T, 1024, 16],
                   "dtype": "bfloat16", "max_abs_err": diff.max().item(), "ok": ok,
                   "ms": chip_smoke.device_ms(torch, call),
                   "ptxas": [{"kernel": k, "spill_bytes": int(s), "registers": int(r)}
                             for k, s, r in report]}
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
