"""Build and load the package's hand-written CUDA kernels (csrc/*.cu).

Each source is compiled by `nvcc` for Hopper (`sm_90a`) into a shared library
with a plain C interface and loaded with `ctypes`: pointers and the stream
travel as `c_void_p`, and every exported launcher returns `cudaGetLastError()`
so the Python wrapper can raise on a refused launch.  Nothing is compiled
when a module is imported; the first launch builds what it needs.

Libraries land in build/kernels/ at the repository root, named by a digest of
the source and the flags, so an edited source is rebuilt and an unchanged one
is reused.  `build` compiles several sources at once, one `nvcc` process per
source, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Sequence, Tuple

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, then `nvcc` on PATH, then
    /usr/local/cuda/bin/nvcc."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda/bin); "
        "the CUDA kernels of this package are built with it on first use"
    )


def _source(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


def library_path(name: str) -> str:
    """Where the library for csrc/<name>.cu is (or will be) built."""
    h = hashlib.sha256()
    with open(_source(name), "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(names: Iterable[str]) -> Dict[str, float]:
    """Compile every named source whose library is missing, all at once.

    Returns the seconds each build took (0.0 for one already built).  Raises
    RuntimeError with the compiler's output if any build fails.  The
    compiler's resource report (-Xptxas=-v) is kept beside each library as
    a .log file."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    seconds: Dict[str, float] = {}
    procs = []
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            seconds[name] = 0.0
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, _source(name)]
        procs.append((name, out, tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT
        )))
    failures = []
    for name, out, tmp, t0, proc in procs:
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        text = log.decode(errors="replace")
        if proc.returncode != 0:
            failures.append(f"nvcc failed for csrc/{name}.cu:\n{text}")
            continue
        with open(out[: -len(".so")] + ".log", "w") as f:
            f.write(text)
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def build_log(name: str) -> str:
    """The compiler's output for the built library (registers, spills)."""
    path = library_path(name)[: -len(".so")] + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def library(
    name: str, signatures: Dict[str, Tuple[Sequence, object]]
) -> ctypes.CDLL:
    """Build (if needed), load once, and declare the C signatures of
    csrc/<name>.cu's exported functions: {symbol: (argtypes, restype)}."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(library_path(name))
            for symbol, (argtypes, restype) in signatures.items():
                fn = getattr(lib, symbol)
                fn.argtypes = list(argtypes)
                fn.restype = restype
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if an exported launcher returned a CUDA error code."""
    if code != 0:
        msg = lib.mnt_error_string(code).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


ERROR_STRING = {"mnt_error_string": ([ctypes.c_int], ctypes.c_char_p)}
