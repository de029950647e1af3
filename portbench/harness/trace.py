"""The traced window: torch.profiler around the work, read back as intervals.

torch.profiler loses the first device records of every window it opens, a
number that grows with the process's age.  So the window opens with
HEAD_FILL empty spin kernels (`torch.cuda._sleep(0)`, named apart from every
kernel of the program), which take that loss and count for nothing.  The
work runs inside a `portbench.window` annotation that ends once the card is
synchronised; that annotation's span is the window.

The trace is written as Chrome JSON under the run's temporary directory,
read, and deleted.  Device busy time is the union of the device records'
intervals (kernels, copies, sets) inside the window, so overlapping work is
counted once.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

HEAD_FILL = 4096
FILL_NAME = "spin_kernel"
WINDOW = "portbench.window"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


@dataclass
class Trace:
    """What a metric reader gets: the window's device records, the host's
    spans and counters, and the driver's facts about the work it traced."""

    kernels: List[Tuple[str, float, float]]  # (name, start s, seconds), clipped to the window
    window_s: float
    busy_s: float
    gaps: List[Tuple[str, float]]  # the longest idle gaps, by what the host was doing
    head_lost: int
    facts: Dict = field(default_factory=dict)

    def seconds(self, match: Callable[[str], bool]) -> float:
        return sum(d for n, _, d in self.kernels if match(n))

    def top_ops(self, n: int = 10):
        by: Dict[str, float] = {}
        for name, _, d in self.kernels:
            key = name[:120]
            by[key] = by.get(key, 0.0) + d
        return sorted(by.items(), key=lambda kv: -kv[1])[:n]


def union_seconds(intervals) -> Tuple[float, list]:
    """(covered seconds, merged intervals) of (start, end) pairs."""
    merged: list = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def profiled(fn, torch):
    """Run fn() in a traced window; returns (fn's result, Trace without facts)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(HEAD_FILL):
            torch.cuda._sleep(0)
        with record_function(WINDOW):
            out = fn()
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return out, read_events(events)


def read_events(events) -> Trace:
    """A Chrome trace's events (microseconds) as a Trace."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in xs if e.get("cat") == "user_annotation" and e.get("name") == WINDOW]
    if not win:
        raise RuntimeError("the trace holds no portbench.window annotation")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, fill = [], 0
    for e in xs:
        if e.get("cat") not in _DEVICE_CATS:
            continue
        if FILL_NAME in e.get("name", ""):
            fill += 1
            continue
        s, t = max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1)
        if t > s:
            dev.append((e["name"], (s - w0) / 1e6, (t - s) / 1e6))
    busy, merged = union_seconds([(s, s + d) for _, s, d in dev])
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("name", ""))
                   for e in xs if e.get("cat") in _HOST_CATS and e.get("name") != WINDOW))
    edges = [0.0] + [x for m in merged for x in m] + [(w1 - w0) / 1e6]
    holes = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)
                    if edges[i + 1] > edges[i]), reverse=True)[:10]
    gaps = [(_host_at(host, w0 + (start + length / 2) * 1e6), length) for length, start in holes]
    return Trace(kernels=dev, window_s=(w1 - w0) / 1e6, busy_s=busy, gaps=gaps,
                 head_lost=HEAD_FILL - fill)


def _host_at(host, t_us: float) -> str:
    """The shortest host event running at t (any thread), or 'host idle'."""
    best = None
    for s, e, name in host:
        if s > t_us:
            break
        if e >= t_us and (best is None or e - s < best[0]):
            best = (e - s, name)
    return best[1] if best else "host idle"


def breakdown(trace: Trace) -> dict:
    return {"device_ops": [[n, s] for n, s in trace.top_ops()],
            "idle_gaps": [[n, s] for n, s in trace.gaps]}
