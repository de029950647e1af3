"""Build/load glue for the repository's native C++ extensions (native/*.cpp).

The sources are shared with the JAX package; this package compiles them on
demand with g++ into its own build directory (build/native/ at the repository
root), so the two packages never overwrite each other's binaries.  The fast
image loader needs the libjpeg and libpng headers; where they are missing the
build fails once, is logged, and the loader decodes with PIL instead.  Set
MNT_NATIVE_LOADER=0 to disable, =1 to require; default is auto (use them when
the toolchain builds them).
"""

from __future__ import annotations

import importlib.util
import logging
import os
import subprocess
import sysconfig
import threading

log = logging.getLogger(__name__)

_lock = threading.Lock()
_modules: dict = {}

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_BUILD_DIR = os.path.join(_REPO_ROOT, "build", "native")

_SOURCES = {
    "_fastloader": ("fastloader.cpp", ["-ljpeg", "-lpng"]),
    "_leaderboard": ("leaderboard.cpp", []),
}


def _output_path(module_name: str) -> str:
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return os.path.join(_BUILD_DIR, f"{module_name}{suffix}")


def _build(module_name: str) -> bool:
    src_name, libs = _SOURCES[module_name]
    src = os.path.join(_NATIVE_DIR, src_name)
    if not os.path.exists(src):
        return False
    out = _output_path(module_name)
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        return True
    os.makedirs(_BUILD_DIR, exist_ok=True)
    include = sysconfig.get_paths()["include"]
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-shared", "-fPIC", "-std=c++17",
        src, f"-I{include}", *libs, "-pthread", "-o", tmp,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=180)
    except (OSError, subprocess.SubprocessError) as e:
        detail = getattr(e, "stderr", b"") or b""
        log.warning("native build of %s failed: %s %s", module_name, e,
                    detail.decode(errors="replace")[-300:])
        return False
    os.replace(tmp, out)
    return True


def _get_native(module_name: str):
    flag = os.environ.get("MNT_NATIVE_LOADER", "auto")
    if flag == "0":
        return None
    with _lock:
        if module_name in _modules:
            return _modules[module_name]
        mod = None
        if _build(module_name):
            # loaded from this build directory by path, not through sys.path,
            # so a same-named module built elsewhere is never picked up
            spec = importlib.util.spec_from_file_location(
                module_name, _output_path(module_name)
            )
            try:
                mod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(mod)
                log.info("native C++ module %s enabled", module_name)
            except ImportError as e:
                log.warning("native import of %s failed: %s", module_name, e)
        _modules[module_name] = mod
        if mod is None and flag == "1":
            raise RuntimeError(f"MNT_NATIVE_LOADER=1 but {module_name} is unavailable")
        return mod


def get_fastloader():
    """Returns the _fastloader module or None."""
    return _get_native("_fastloader")


def get_leaderboard():
    """Returns the _leaderboard module or None."""
    return _get_native("_leaderboard")
