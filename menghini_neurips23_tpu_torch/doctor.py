"""Environment self-check: `python -m menghini_neurips23_tpu_torch.doctor`.

Prints one line per subsystem so a user can see, before launching a grid,
whether they are about to run on real weights, a real tokenizer, a CUDA card,
and kernels that build.

Default mode reports only (exit 0 always).  `--strict` gates: non-zero exit
when any check a REPRODUCTION run depends on fails (random weights, missing
BPE merges, no CUDA card, missing dataset dir), so a seed grid is not burned
on a misconfigured host.  The native-extension, kernel-build and
kernel-directory checks stay advisory in strict mode: the CUDA kernels build
on first use, and the native helpers affect speed, not results.
"""

from __future__ import annotations

import argparse
import os
import sys


def _line(name: str, ok: bool, detail: str) -> None:
    print(f"[{'ok' if ok else '--'}] {name:<18} {detail}")


def _kernels() -> tuple[bool, str]:
    """nvcc present, and the three kernel libraries build and load."""
    from menghini_neurips23_tpu_torch.ops import _cuda
    from menghini_neurips23_tpu_torch.ops import attention, clip_head

    try:
        nvcc = _cuda.nvcc_path()
    except RuntimeError as e:
        return False, str(e)
    libs = {"attention_fwd": attention._FWD_SIGNATURES,
            "attention_bwd": attention._BWD_SIGNATURES, "clip_head": clip_head._SIGNATURES}
    try:
        secs = _cuda.build(libs)
        for name, signatures in libs.items():
            _cuda.library(name, signatures)
    except (RuntimeError, OSError) as e:
        return False, f"{nvcc}: {str(e).splitlines()[0]}"
    built = ", ".join(f"{n} {s:.1f} s" if s else f"{n} cached" for n, s in secs.items())
    return True, f"{nvcc}: built and loaded ({built})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--strict",
        action="store_true",
        help="exit non-zero when a reproduction-critical check fails "
        "(random weights / missing BPE / no CUDA card / missing dataset)",
    )
    args = ap.parse_args(argv)
    failures = []

    def gate(name: str, ok: bool) -> None:
        if not ok:
            failures.append(name)

    # 1. backend: a CUDA card that torch sees
    import torch

    accel_ok = torch.cuda.is_available()
    if accel_ok:
        detail = (f"cuda ({torch.cuda.device_count()} device(s): "
                  f"{torch.cuda.get_device_name(0)}), torch {torch.__version__}")
    else:
        detail = f"no CUDA card (torch {torch.__version__}, CUDA build {torch.version.cuda})"
    _line("backend", accel_ok, detail)
    gate("backend", accel_ok)

    # 2. CLIP weights
    ckpt = os.environ.get("CLIP_CKPT", "")
    if ckpt and os.path.exists(ckpt):
        _line("clip weights", True, ckpt)
    elif ckpt:
        _line("clip weights", False, f"CLIP_CKPT={ckpt} DOES NOT EXIST")
        gate("clip weights", False)
    else:
        _line(
            "clip weights", False,
            "CLIP_CKPT unset - runs use RANDOM weights (throughput only)",
        )
        gate("clip weights", False)

    # 3. tokenizer
    bpe = os.environ.get("BPE_PATH", "") or os.environ.get("CLIP_BPE_PATH", "")
    if bpe and os.path.exists(bpe):
        _line("tokenizer", True, f"CLIP BPE merges: {bpe}")
    else:
        _line(
            "tokenizer", False,
            "no BPE merges (BPE_PATH/CLIP_BPE_PATH) - byte-level fallback vocab",
        )
        gate("tokenizer", False)

    # 4. native extensions (build on first use) - advisory even in strict
    # mode: the pure-Python fallbacks are byte-identical, only slower
    from menghini_neurips23_tpu_torch.data._native import get_fastloader, get_leaderboard

    _line("native loader", get_fastloader() is not None, "C++ threaded image decode")
    _line("native leaderboard", get_leaderboard() is not None, "C++ exact top-K cascade")

    # 5. the CUDA kernels (csrc/*.cu, nvcc for sm_90a) - advisory: a run
    # builds them on first use, and fails there if they do not build
    ok, detail = _kernels()
    _line("cuda kernels", ok, detail)

    # 6. the kernel build directory - advisory: a missing library is built
    # on first use, which costs set-up time, not results
    from menghini_neurips23_tpu_torch.ops._cuda import BUILD_DIR

    n = (len([f for f in os.listdir(BUILD_DIR) if f.endswith(".so")])
         if os.path.isdir(BUILD_DIR) else 0)
    _line("kernel build dir", n > 0,
          f"{BUILD_DIR} ({n} libraries)" if n else f"{BUILD_DIR} (empty: the first run builds)")

    # 7. dataset root
    ddir = os.environ.get("DATASET_DIR", "")
    ddir_ok = bool(ddir) and os.path.isdir(ddir)
    _line("dataset dir", ddir_ok, ddir or "DATASET_DIR unset")
    gate("dataset dir", ddir_ok)

    if args.strict and failures:
        print(f"strict: FAILED ({', '.join(failures)})", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
