"""A manifest of tiny cells, defined here only: the tests' proof that a cell,
a configuration and a metric are added as files and entries alone."""

from __future__ import annotations

import json
import os

from portbench.harness.manifest import ROOT

TINY = {"source": "https://github.com/openai/CLIP", "arch": "tiny-test", "embed_dim": 16,
        "image_resolution": 32, "vision_layers": 2, "vision_width": 32, "vision_patch_size": 16,
        "vision_heads": 1, "context_length": 77, "vocab_size": 514, "transformer_width": 32,
        "transformer_heads": 2, "transformer_layers": 2, "reduced": []}


def _cell(name: str, **over) -> dict:
    """A cell file of the benchmark at tiny sizes.  Its limits are the tests':
    the CPU's plain versions against the reference read ~1e-7 and the
    planted faults 1e-2 or more."""
    with open(os.path.join(ROOT, "portbench", "workloads", f"{name}.json")) as f:
        cell = dict(json.load(f), config="tiny", **over)
    cell["limits"] = {k: 0 if k in ("selection_diff", "val_rows_off", "best_gap") else 1e-4
                      for k in cell["limits"]}
    return cell


CELLS = {
    "tiny_coop": _cell("coop_b32_ssl_fp32", classes=3, pseudo_per_class=10, batch_size=8),
    "tiny_vpt": _cell("vpt_l14_ul_fp32", classes=3, pseudo_per_class=10, batch_size=8,
                      prefix_size=4),
    "tiny_pass": _cell("fpl_l14_pass_fp32", classes=3, pool=64, pseudo_per_class=4,
                       check_rows=16),
}


def write_manifest(tmp) -> str:
    """tmp/BENCHMARK.json with the tiny configuration and cells; returns its path."""
    os.makedirs(os.path.join(tmp, "pb", "workloads"), exist_ok=True)
    os.makedirs(os.path.join(tmp, "pb", "configs"), exist_ok=True)
    with open(os.path.join(tmp, "pb", "configs", "tiny.json"), "w") as f:
        json.dump(TINY, f)
    for name, cell in CELLS.items():
        with open(os.path.join(tmp, "pb", "workloads", f"{name}.json"), "w") as f:
            json.dump(cell, f)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        m = json.load(f)
    m["paths"] = ["pb"]
    m["configs"] = [{"name": "tiny", "source": TINY["source"], "file": "pb/configs/tiny.json",
                     "reduced": [], "why": "CPU tests only"}]
    m["workloads"] = [{"name": n, "config": "tiny", "traffic": n, "chips": 1,
                       "why": "CPU tests"} for n in CELLS]
    for e in m["end_to_end"] + m["per_layer"]:
        if "workloads" in e:
            e["workloads"] = (["tiny_pass"] if "pass" in e["name"] else
                              ["tiny_coop", "tiny_vpt"])
    path = os.path.join(tmp, "BENCHMARK.json")
    with open(path, "w") as f:
        json.dump(m, f)
    return path
