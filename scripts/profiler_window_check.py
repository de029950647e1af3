"""How many of two captured CUDA graphs' kernels torch.profiler reports in
a window, by how the window opens and closes.

Two graphs stand for a training step and its epoch end: the step graph
launches ADDS in-place adds over a 64 Mi-float tensor, the end graph MULS
in-place multiplies (one elementwise kernel each, ~0.2 ms apiece on an
H100).  A window replays the step graph twice, then the end graph once, as
the whole-run trainer's `run()` of two steps does, so it must report
2 x ADDS add kernels and MULS multiply kernels.  The forms (`--forms`):

- unpadded: the graphs, then a synchronisation, and the window closes;
- padded: `--pad` idle seconds at each end of the window;
- spun: a spin kernel of `--spin` seconds before the graphs;
- filled_before, filled_after, filled_both: `--fill` small kernels (negations
  of a 256-float tensor) before the graphs, after them, or both.

`--trials` windows of each, spread over `--span` seconds.  For every window:
the process's age, the kernels seen (adds, multiplies, others), the last
kernel's end less the start of a host marker recorded once the
synchronisation has returned (the lead), the first recorded kernel's start
less the first graph launch's (the gap), both in ms on the profiler's time
base, and where the lost adds lay: [at the head, between recorded ones, at
the tail].  Prints one JSON line.

    python3 scripts/profiler_window_check.py [--trials 40] [--pad 0.5]
        [--spin 0.05] [--fill 64] [--forms unpadded,padded,spun] [--span 0]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

ADDS = 48
MULS = 48
N = 64 << 20


def counts(prof):
    """(add kernels, multiply kernels, other device kernels) in a profile."""
    from torch.autograd import DeviceType

    add = mul = other = 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        name = e.key.lower()
        if "add" in name:
            add += e.count
        elif "mul" in name:
            mul += e.count
        else:
            other += e.count
    return add, mul, other


def clocks_ms(prof):
    """On the profiler's time base, in ms: the last device kernel's end less
    the start of the host's "after_sync" marker (the lead), and the first
    device kernel's start less the first graph launch's (the gap); None
    where one is missing."""
    from torch.autograd import DeviceType

    events = prof.events()
    dev = [e.time_range for e in events if e.device_type == DeviceType.CUDA]
    marks = [e.time_range.start for e in events if e.name == "after_sync"]
    launches = [e.time_range.start for e in events if e.name == "cudaGraphLaunch"]
    lead = (max(r.end for r in dev) - marks[0]) / 1e3 if dev and marks else None
    gap = (min(r.start for r in dev) - min(launches)) / 1e3 if dev and launches else None
    return lead, gap


def where_short(prof):
    """Where the add kernels a window lost lie: [missing at the head,
    missing between recorded ones, missing at the tail] by the gaps in the
    recorded kernels' start times (the step graph's adds run back to back,
    then the end graph's multiplies)."""
    from torch.autograd import DeviceType

    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    adds = sorted(e.time_range.start for e in dev if "add" in e.name.lower())
    muls = sorted(e.time_range.start for e in dev if "mul" in e.name.lower())
    if len(adds) < 3 or not muls:
        return None
    steps = sorted(b - a for a, b in zip(adds, adds[1:]))
    d = steps[len(steps) // 2]
    inside = sum(max(0, round((b - a) / d) - 1) for a, b in zip(adds, adds[1:]))
    tail = max(0, round((muls[0] - adds[-1]) / d) - 1)
    return [2 * ADDS - len(adds) - inside - tail, inside, tail]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trials", type=int, default=40)
    ap.add_argument("--pad", type=float, default=0.5, help="idle seconds at each end")
    ap.add_argument("--spin", type=float, default=0.05,
                    help="seconds the card spins before the graphs in the spun form")
    ap.add_argument("--fill", type=int, default=64,
                    help="small kernels before or after the graphs in the filled forms")
    ap.add_argument("--forms", default="unpadded,padded,spun",
                    help="comma-separated: unpadded, padded, spun, filled_before, "
                    "filled_after, filled_both")
    ap.add_argument("--span", type=float, default=0.0,
                    help="seconds over which to spread the trials")
    args = ap.parse_args()

    t_start = time.perf_counter()
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    if not torch.cuda.is_available():
        raise SystemExit("profiler_window_check.py needs a CUDA card")
    x = torch.ones(N, device="cuda")
    graphs = []
    side = torch.cuda.Stream()
    for op, n in ((lambda: x.add_(1e-7), ADDS), (lambda: x.mul_(1.0), MULS)):
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            op()  # warm up outside the capture
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(n):
                op()
        graphs.append(g)
    g_step, g_end = graphs

    y = torch.zeros(256, device="cuda")

    def window(pad: float, spin: float, fill: int = 0, fill_after: int = 0):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            t0 = time.perf_counter()
            if spin:
                torch.cuda._sleep(int(spin * 2e9))  # ~spin seconds at ~2 GHz
            for _ in range(fill):
                y.neg_()
            g_step.replay()
            g_step.replay()
            g_end.replay()
            for _ in range(fill_after):
                y.neg_()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            with record_function("after_sync"):
                pass
            time.sleep(pad)
        return counts(prof), ms, clocks_ms(prof), where_short(prof)

    fill = args.fill
    forms = {"unpadded": (0.0, 0.0, 0, 0), "padded": (args.pad, 0.0, 0, 0),
             "spun": (0.0, args.spin, 0, 0), "filled_before": (0.0, 0.0, fill, 0),
             "filled_after": (0.0, 0.0, 0, fill), "filled_both": (0.0, 0.0, fill, fill)}
    forms = {k: forms[k] for k in args.forms.split(",")}
    window(args.pad, 0.0)  # the profiler's first start is slow; not counted
    want = (2 * ADDS, MULS)
    out = {}
    for form, (pad, spin, before, after) in forms.items():
        out[form] = {"pad_s": pad, "spin_s": spin, "fill": [before, after],
                     "windows": args.trials, "short": 0, "window_ms": [], "trials": []}
    for i in range(args.trials):
        time.sleep(max(0.0, t_start + args.span * i / args.trials - time.perf_counter()))
        for form, shape in forms.items():
            age = time.perf_counter() - t_start
            (add, mul, other), ms, (lead, gap), where = window(*shape)
            out[form]["window_ms"].append(ms)
            # [age s, adds, multiplies, other kernels, lead ms, gap ms,
            #  adds missing [at the head, inside, at the tail]]
            out[form]["trials"].append([round(age, 1), add, mul, other, lead, gap, where])
            out[form]["short"] += (add, mul) != want
    for rec in out.values():
        ms = sorted(rec.pop("window_ms"))
        rec["window_ms_median"] = ms[len(ms) // 2]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"card": card.strip(), "torch": torch.__version__,
                      "kernels_a_window": {"add": want[0], "mul": want[1]}, **out}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
