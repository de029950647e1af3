"""BENCHMARK.json and the files it names: loading, finding by name, checking.

Everything of one configuration, one cell or one per-layer metric lives in a
file of its own, found by the name that BENCHMARK.json gives:

- a configuration: the file its `configs` entry names (configs/<name>.json);
- a cell: <paths[0]>/workloads/<name>.json;
- a driver (one per kind of traffic): portbench/drivers/<driver>.py;
- a per-layer metric: portbench/metrics/<name>.py, with `read(trace)`.

Files are found relative to the manifest's directory, so a test can hand
the harness a manifest of its own beside its own cells and configurations;
drivers and metric readers always come from this package.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PKG_DIR)

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES_E2E = ("host_clock", "device_trace")
# every source a per-layer metric may name, so that a metric read from the
# program's spans or counters is added as a file and an entry alone
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


class ManifestError(ValueError):
    pass


def _line(text, what):
    if not isinstance(text, str) or not 1 <= len(text) <= 200 or "\n" in text or "\t" in text:
        raise ManifestError(f"{what}: 1 to 200 characters on one line, got {text!r}")


def check(m: dict) -> None:
    """Raise ManifestError where the manifest breaks the contract's form."""
    keys = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    if set(m) != keys:
        raise ManifestError(f"keys {sorted(m)} != {sorted(keys)}")
    names = []
    for c in m["configs"]:
        if set(c) != {"name", "source", "file", "reduced", "why"}:
            raise ManifestError(f"config keys {sorted(c)}")
        _line(c["source"], "source")
        _line(c["why"], "why")
        names += [c["name"], *c["reduced"]]
    for w in m["workloads"]:
        if set(w) != {"name", "config", "traffic", "chips", "why"}:
            raise ManifestError(f"workload keys {sorted(w)}")
        if w["chips"] not in (1, 4):
            raise ManifestError(f"{w['name']}: chips {w['chips']}")
        _line(w["why"], "why")
        names += [w["name"], w["config"], w["traffic"]]
    for e in m["end_to_end"] + m["per_layer"]:
        extra = {"workloads"} & set(e)
        base = ({"name", "unit", "better", "bound", "source"} if e in m["end_to_end"]
                else {"name", "unit", "better", "source", "layer", "moves"})
        if set(e) - extra != base:
            raise ManifestError(f"metric keys {sorted(e)}")
        if not UNIT_RE.match(e["unit"]) or e["better"] not in ("lower", "higher"):
            raise ManifestError(f"{e['name']}: unit {e['unit']!r}, better {e['better']!r}")
        if e["source"] not in (SOURCES_E2E if e in m["end_to_end"] else SOURCES):
            raise ManifestError(f"{e['name']}: source {e['source']!r}")
        names.append(e["name"])
    for e in m["per_layer"]:
        _line(e["layer"], "layer")
    for n in names:
        if not isinstance(n, str) or not NAME_RE.match(n):
            raise ManifestError(f"name {n!r}")
    for group in ("configs", "workloads"):
        seen = [x["name"] for x in m[group]]
        if len(seen) != len(set(seen)):
            raise ManifestError(f"duplicate {group} name")
    metric_names = [e["name"] for e in m["end_to_end"] + m["per_layer"]]
    if len(metric_names) != len(set(metric_names)):
        raise ManifestError("duplicate metric name")


class Bench:
    """One manifest and the files it names."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        self.dir = os.path.dirname(self.path)
        with open(self.path) as f:
            self.m = json.load(f)
        check(self.m)

    def workload(self, name: str) -> dict:
        entry = next((w for w in self.m["workloads"] if w["name"] == name), None)
        if entry is None:
            raise ManifestError(f"no workload {name!r} in {self.path}")
        cell = _load_json(os.path.join(self.dir, self.m["paths"][0], "workloads", f"{name}.json"))
        if cell.get("config") != entry["config"]:
            raise ManifestError(f"{name}: cell file names config {cell.get('config')!r}")
        cell = dict(cell, name=name, chips=entry["chips"])
        return cell

    def config(self, name: str) -> dict:
        entry = next(c for c in self.m["configs"] if c["name"] == name)
        return dict(_load_json(os.path.join(self.dir, entry["file"])), name=name)

    def end_to_end(self, cell: str):
        """The end-to-end metrics the cell reports."""
        return [e for e in self.m["end_to_end"] if cell in e.get("workloads", [cell])]

    def per_layer(self, cell: str):
        """The per-layer metrics the cell reports: those listing it, and those
        without a list whose `moves` the cell reports."""
        e2e = {e["name"] for e in self.end_to_end(cell)}
        return [e for e in self.m["per_layer"]
                if (cell in e["workloads"] if "workloads" in e else e["moves"] in e2e)]


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """portbench/<kind>/<name>.py as a module (names may hold dots)."""
    path = os.path.join(PKG_DIR, kind, f"{name}.py")
    if not os.path.exists(path):
        raise ManifestError(f"no {kind[:-1]} file {path}")
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
