"""Time variants of a kernel library of the port (csrc/attention_fwd.cu by
default, or csrc/attention_bwd.cu) against each other on one CUDA card: the
shipped source, the parent commit's, and copies of the shipped source with
regions replaced or text patched, as a spec file describes them
(scripts/kernel_variants/k1_bf16_above_128.json: K1's bf16 kernels above
128 tokens and the alternative designs measured before the one-sweep form
was chosen; k2_bf16_pair.json: K2's bf16 pair above 320 tokens on
warpgroup MMA, its step-D overlap, and the pair taken from 129 tokens on).

A spec may name its `library` (default `attention_fwd`; `attention_bwd`
for K2) and the `kernels` whose ptxas report is printed (default K1's
`attention_fwd_onesweep` and `attention_fwd_wgmma`).  It names `regions`
of the library's source by their first line and the first line after
them, and `variants`, each either `{"src": "parent"}` (the csrc/ of the
tree given as --parent) or a copy of this tree's csrc/ with `regions`
({region: fragment file, relative to the spec}) put in place and then
`patches` ([old, new] string pairs, each applied to the source files that
hold `old`) applied, built with the package's nvcc flags and any `flags`.
Each variant's library is loaded with ctypes and called at the spec's bf16
`shapes` (B, T, W, heads, mask), in turns (forward, then backward over the
variants), with CUDA-event times of 20 calls replayed from a CUDA graph
(`chip_smoke.device_ms`): K1's `mnt_attention_fwd` held against
`attention_reference` (bf16 tolerance), K2's `mnt_attention_bwd` (on the
workspace its own library asks for) against `attention_bwd_reference`
(within tol + tol |ref|); two launches must give the same bits.  Each
variant's ptxas registers and spill stores for the spec's kernels, and any
ptxas note that it serialised their wgmma, are printed too.

    python3 scripts/kernel_variants.py [SPEC] [--parent DIR] [--only NAME ...]

Prints the card's nvidia-smi line, one JSON line a shape, then one JSON
line of the whole run.  Builds land under build/kernel_variants/.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = os.path.join(HERE, "scripts", "kernel_variants", "k1_bf16_above_128.json")


def make_source(spec, spec_dir, name, v, parent, csrc):
    """The variant's csrc/ copy under build/kernel_variants/<name>."""
    d = os.path.join(HERE, "build", "kernel_variants", name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(os.path.join(parent, "menghini_neurips23_tpu_torch", "csrc")
                    if v.get("src") == "parent" else csrc, d)
    path = os.path.join(d, f"{spec.get('library', 'attention_fwd')}.cu")
    with open(path) as f:
        text = f.read()
    for region, fragment in v.get("regions", {}).items():
        first, after = spec["regions"][region]
        i = text.index(first)
        j = text.index(after, i)
        with open(os.path.join(spec_dir, fragment)) as f:
            text = text[:i] + f.read() + text[j:]
    with open(path, "w") as f:
        f.write(text)
    for old, new in v.get("patches", []):
        hits = 0
        for fname in sorted(os.listdir(d)):
            p = os.path.join(d, fname)
            with open(p) as f:
                text = f.read()
            if old in text:
                hits += 1
                with open(p, "w") as f:
                    f.write(text.replace(old, new))
        if not hits:
            raise RuntimeError(f"{name}: a patch matches no source file: {old[:80]!r}")
    return d


K1_KERNELS = ("attention_fwd_onesweep", "attention_fwd_wgmma")


def ptxas_report(log: str, kernels=K1_KERNELS):
    """{kernel<ints>: [registers, spill stores]} of `kernels`' entry
    points, and the entry points whose wgmma ptxas serialised."""
    regs, serialised = {}, set()
    for block in log.split("Compiling entry function ")[1:]:
        sym = re.match(r"'([^']+)'", block).group(1)
        kernel = re.search(r"\d((?:attention)\w*?)I", sym).group(1)
        if kernel not in kernels:
            continue
        key = f"{kernel}<{', '.join(re.findall(r'L[ib](\d+)E', sym))}>"
        r = re.search(r"Used (\d+) registers", block)
        sp = re.search(r"(\d+) bytes spill stores", block)
        regs[key] = [int(r.group(1)) if r else None, int(sp.group(1)) if sp else None]
    for line in log.splitlines():
        if "wgmma.mma_async instructions are serialized" in line:
            hit = re.search(r"\d((?:attention)\w*?)I((?:L[ib]\d+E)+)", line)
            if hit:
                ints = ", ".join(re.findall(r"L[ib](\d+)E", hit.group(2)))
                serialised.add(f"{hit.group(1)}<{ints}>")
    return regs, sorted(serialised)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("spec", nargs="?", default=SPEC)
    ap.add_argument("--parent", default=os.path.join(HERE, "build", "parent"))
    ap.add_argument("--only", nargs="*", default=None)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("kernel_variants.py: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: no output",
          flush=True)
    spec_s = importlib.util.spec_from_file_location("chip_smoke_helpers",
                                                    os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec_s)
    spec_s.loader.exec_module(smoke)
    from menghini_neurips23_tpu_torch.ops import _cuda
    from menghini_neurips23_tpu_torch.ops.attention import (
        _BWD_SIGNATURES,
        _FWD_SIGNATURES,
        attention_bwd_reference,
        attention_reference,
    )

    with open(args.spec) as f:
        spec = json.load(f)
    spec_dir = os.path.dirname(os.path.abspath(args.spec))
    library = spec.get("library", "attention_fwd")
    signatures = _BWD_SIGNATURES if library == "attention_bwd" else _FWD_SIGNATURES
    tol = smoke.ATTN_TOL["bfloat16"]
    names = [n for n in spec["variants"] if args.only is None or n in args.only]
    procs = {}
    for name in names:
        d = make_source(spec, spec_dir, name, spec["variants"][name], args.parent, _cuda.CSRC_DIR)
        cmd = [_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, *spec["variants"][name].get("flags", []),
               "-o", os.path.join(d, "lib.so"), os.path.join(d, f"{library}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    fns, builds = {}, {}
    for name, proc in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        d = os.path.join(HERE, "build", "kernel_variants", name)
        with open(os.path.join(d, "ptxas.log"), "w") as f:
            f.write(log)
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed:\n{log[-3000:]}")
        regs, serialised = ptxas_report(log, spec.get("kernels", K1_KERNELS))
        builds[name] = {"ptxas": regs, "wgmma_serialised": serialised}
        print(f"  build {name} " + json.dumps(builds[name]), flush=True)
        lib = ctypes.CDLL(os.path.join(d, "lib.so"))
        for sym, (argtypes, restype) in signatures.items():
            getattr(lib, sym).argtypes, getattr(lib, sym).restype = argtypes, restype
        fns[name] = lib

    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for B, T, W, H, mask in spec["shapes"]:
        qkv = torch.randn(B, T, 3 * W, generator=g, device="cuda").to(torch.bfloat16)
        scale, causal = (W // H) ** -0.5, int(mask == "causal")
        if library == "attention_bwd":
            grad = torch.randn(B, T, W, generator=g, device="cuda").to(torch.bfloat16)
            ref = attention_bwd_reference(qkv, grad, mask, H).float()
            out = torch.empty_like(qkv)
            # each variant's own workspace (a variant may take the pair at
            # lengths the shipped library holds resident)
            ws = {name: torch.empty(max(1, fns[name].mnt_attention_bwd_workspace(B, T, H, 1) // 4),
                                    dtype=torch.float32, device="cuda") for name in names}

            def launch(name):
                # the current stream at each call: a CUDA graph captures on its own
                err = fns[name].mnt_attention_bwd(qkv.data_ptr(), grad.data_ptr(), out.data_ptr(),
                                                  ws[name].data_ptr(), B, T, W, H, scale, causal,
                                                  1, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"CUDA error {err}")
        else:
            ref = attention_reference(qkv, mask, H).float()
            out = torch.empty(B, T, W, dtype=torch.bfloat16, device="cuda")

            def launch(name):
                err = fns[name].mnt_attention_fwd(qkv.data_ptr(), out.data_ptr(), B, T, W, H,
                                                  scale, causal, 1,
                                                  torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"CUDA error {err}")

        row = {"shape": [B, T, W, H], "mask": mask, "variants": {}}
        for name in names:
            launch(name)
            first = out.clone()
            launch(name)
            torch.cuda.synchronize()
            diff = (out.float() - ref).abs()
            row["variants"][name] = {
                "max_abs_err": diff.max().item(),
                # the part of the error past tol |ref| (K2's criterion)
                "max_excess": (diff - tol * ref.abs()).max().item(),
                "bit_identical": torch.equal(first.view(torch.uint8), out.view(torch.uint8)),
                "ms": []}
        for name in names + names[::-1]:
            row["variants"][name]["ms"].append(
                smoke.device_ms(torch, lambda: launch(name), args.reps))
        err_key = "max_excess" if library == "attention_bwd" else "max_abs_err"
        ok = all(v[err_key] <= tol and v["bit_identical"] for v in row["variants"].values())
        row["ok"] = ok
        print("  " + json.dumps(row), flush=True)
        rows.append(row)
        del qkv, ref, out
    print(json.dumps({"spec": os.path.relpath(args.spec, HERE), "builds": builds,
                      "shapes": rows}), flush=True)
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
