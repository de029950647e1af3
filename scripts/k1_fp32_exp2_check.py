"""K1 fp32 above 128 tokens (`attention_fwd_tf32`, 3xTF32 on warpgroup MMA):
does its one-MUFU exponential (`ex2.approx.ftz.f32`, `ex2` in
csrc/attention_common.cuh) hold its error against fp64 above the plain fp32
version's?  On the card, build scratch copies of the package's
attention_fwd.cu whose `ex2` is CUDA's `exp2f` (2 ulp) or `exp2` in fp64
rounded to fp32, and hold each copy, the package's own library and the
plain version (`attention_reference`) against an fp64 attention at (8,
1024) x 16 heads of 64 with V 4x larger: 12 inputs (seeds 0-5, unmasked and
causal), the largest and the mean of each input's largest error.  Then each
library's device time at the frozen ViT-L/14 pass's (256, 257) fp32, timed in
turns.  The package's sources are not changed.

    python3 scripts/k1_fp32_exp2_check.py [--reps N]

Prints the card's nvidia-smi line, then one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EX2 = 'asm volatile("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));'
VARIANTS = {"exp2f": "y = exp2f(x);", "exp2_fp64": "y = (float)exp2((double)x);"}


def reference_fp64(torch, qkv, mask, heads):
    """softmax(q k^T D^-0.5) v in fp64, (B, T, W)."""
    B, T, three_w = qkv.shape
    W = three_w // 3
    D = W // heads
    q, k, v = (t.reshape(B, T, heads, D).transpose(1, 2).double() for t in qkv.split(W, -1))
    s = torch.matmul(q, k.transpose(-1, -2)) * D ** -0.5
    if mask == "causal":
        s = s + torch.triu(torch.full((T, T), float("-inf"), dtype=torch.float64,
                                      device=qkv.device), 1)
    return torch.matmul(torch.softmax(s, -1), v).transpose(1, 2).reshape(B, T, W)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("k1_fp32_exp2_check.py: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: no output",
          flush=True)
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers",
                                                  os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from menghini_neurips23_tpu_torch.ops import _cuda
    from menghini_neurips23_tpu_torch.ops.attention import (
        _FWD_SIGNATURES,
        attention_reference,
        fused_attention,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    # the scratch copies: csrc/ with `ex2` replaced, one nvcc each, all at once
    procs = {}
    for name, body in VARIANTS.items():
        d = os.path.join(_cuda.build_dir(), "exp2_check", name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_cuda.CSRC_DIR, d)
        common = os.path.join(d, "attention_common.cuh")
        with open(common) as f:
            text = f.read()
        if EX2 not in text:
            raise RuntimeError("attention_common.cuh no longer holds the ex2 this script replaces")
        with open(common, "w") as f:
            f.write(text.replace(EX2, body))
        procs[name] = subprocess.Popen(
            [_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, "-o", os.path.join(d, "lib.so"),
             os.path.join(d, "attention_fwd.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed:\n{log.decode()[-3000:]}")
        fn = ctypes.CDLL(os.path.join(_cuda.build_dir(), "exp2_check", name,
                                      "lib.so")).mnt_attention_fwd
        fn.argtypes, fn.restype = _FWD_SIGNATURES["mnt_attention_fwd"]
        fns[name] = fn

    def launcher(fn, qkv, out, mask, heads):
        B, T, three_w = qkv.shape
        W = three_w // 3

        def run():
            err = fn(qkv.data_ptr(), out.data_ptr(), B, T, W, heads, (W // heads) ** -0.5,
                     int(mask == "causal"), 0, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"CUDA error {err}")
        return run

    forms = ["ex2.approx.ftz (the package)", *VARIANTS, "plain fp32 (attention_reference)"]
    errors = {f: [] for f in forms}
    for seed in range(6):
        for mask in (None, "causal"):
            g = torch.Generator(device="cuda").manual_seed(seed)
            qkv = torch.randn(8, 1024, 3 * 1024, generator=g, device="cuda")
            qkv[..., 2 * 1024:] *= 4
            ref = reference_fp64(torch, qkv, mask, 16)
            outs = {forms[0]: fused_attention(qkv, mask, 16),
                    forms[-1]: attention_reference(qkv, mask, 16)}
            for name, fn in fns.items():
                out = torch.empty(8, 1024, 1024, device="cuda")
                launcher(fn, qkv, out, mask, 16)()
                outs[name] = out
            torch.cuda.synchronize()
            for f in forms:
                errors[f].append((outs[f].double() - ref).abs().max().item())
            del qkv, ref, outs
    result = {"shape": [8, 1024, 1024, 16], "v_scale": 4,
              "inputs": "seeds 0-5 x (unmasked, causal)",
              "max_abs_err_vs_fp64": {f: max(e) for f, e in errors.items()},
              "mean_of_max_abs_err_vs_fp64": {f: sum(e) / len(e) for f, e in errors.items()},
              "per_input": errors}
    # (256, 257) fp32, in turns: package, copies, copies, package
    g = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn(256, 257, 3 * 1024, generator=g, device="cuda")
    out = torch.empty(256, 257, 1024, device="cuda")
    ms = {f: [] for f in forms[:-1]}
    order = [forms[0], *VARIANTS, *reversed(list(VARIANTS)), forms[0]]
    for f in order:
        run = ((lambda: fused_attention(qkv, None, 16)) if f == forms[0]
               else launcher(fns[f], qkv, out, None, 16))
        ms[f].append(smoke.device_ms(torch, run, args.reps))
    result["ms_256x257"] = ms
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
