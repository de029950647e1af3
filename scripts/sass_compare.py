"""Compare the machine code (SASS) of every kernel entry point of this
tree's CUDA libraries with the parent tree's, on a machine with nvcc and
cuobjdump (the CUDA card's), so that a change that should leave a kernel
alone (a shared header moved, a neighbour rewritten) shows that it did:
an entry point whose SASS is the same instruction for instruction computes
the same bits at every shape.

Both trees' csrc/*.cu are compiled with the package's nvcc flags
(`_cuda.NVCC_FLAGS`), one nvcc process a source, all started together,
under build/sass_compare/{parent,this}/.  Entry points are matched by name
with the anonymous namespace's per-file prefix taken out; the SASS text is
compared after the same substitution, runs of blanks taken as one (the
listing pads its columns to the widest instruction of the library).

    python3 scripts/sass_compare.py [--parent build/parent] [LIB ...]

LIB defaults to every csrc/*.cu of this tree.  Prints one JSON line a
library ({"same": n, "different": {entry point: [the parent's first
differing line, this tree's]}, "only_parent": [...], "only_this": [...]}),
then a JSON line of the whole run.  Exits 1 without nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ANON = re.compile(r"_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_[0-9a-f]{8}")


def sass_by_function(cuobjdump: str, lib: str) -> dict:
    """{entry point name, anonymous prefix taken out: its SASS text}."""
    text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True, check=True,
                          timeout=600).stdout
    out = {}
    for block in text.split("Function : ")[1:]:
        name, body = block.split("\n", 1)
        # cuobjdump pads its columns to the file's widest instruction
        out[_ANON.sub("ANON", name.strip())] = re.sub(r"[ \t]+", " ", _ANON.sub("ANON", body))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("libs", nargs="*")
    ap.add_argument("--parent", default=os.path.join(HERE, "build", "parent"))
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    from menghini_neurips23_tpu_torch.ops import _cuda

    try:
        nvcc = _cuda.nvcc_path()
    except RuntimeError as e:
        print(f"sass_compare.py: {e}", file=sys.stderr)
        return 1
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    libs = args.libs or sorted(n[:-3] for n in os.listdir(_cuda.CSRC_DIR) if n.endswith(".cu"))
    trees = {"parent": os.path.join(args.parent, "menghini_neurips23_tpu_torch", "csrc"),
             "this": _cuda.CSRC_DIR}
    procs = {}
    for tree, csrc in trees.items():
        d = os.path.join(HERE, "build", "sass_compare", tree)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(csrc, d)
        for lib in libs:
            cmd = [nvcc, *_cuda.NVCC_FLAGS, "-o", os.path.join(d, f"{lib}.so"),
                   os.path.join(d, f"{lib}.cu")]
            procs[(tree, lib)] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                  stderr=subprocess.STDOUT)
    for key, proc in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            raise RuntimeError(f"{key}: nvcc failed:\n{log[-3000:]}")
    total = {"same": 0, "different": 0}
    for lib in libs:
        sass = {tree: sass_by_function(cuobjdump, os.path.join(HERE, "build", "sass_compare",
                                                                tree, f"{lib}.so"))
                for tree in trees}
        common = sorted(set(sass["parent"]) & set(sass["this"]))
        diff = [n for n in common if sass["parent"][n] != sass["this"][n]]
        # the first differing line of each entry point that differs
        first = {}
        for n in diff:
            a, b = sass["parent"][n].splitlines(), sass["this"][n].splitlines()
            i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
            first[n] = [a[i].strip() if i < len(a) else None, b[i].strip() if i < len(b) else None]
        row = {"lib": lib, "same": len(common) - len(diff), "different": first,
               "only_parent": sorted(set(sass["parent"]) - set(sass["this"])),
               "only_this": sorted(set(sass["this"]) - set(sass["parent"]))}
        print(json.dumps(row), flush=True)
        total["same"] += row["same"]
        total["different"] += len(diff)
    print(json.dumps(total), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
