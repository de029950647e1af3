"""Run one benchmark cell of the PyTorch/CUDA port once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (everything before the first timed unit of work, from the start of
this process: imports, weights and inputs from the seed, the program's
build, and a first unit that compiles and captures every shape the cell
uses and is the program's reading for the correctness check) is `setup_s`.
With --trace 0 the window then runs whole units of the cell's work (a
training call, a pseudolabel pass) back to back until --seconds have passed,
and the cell's rate is the work of all those units over the time they took.
With --trace 1 one unit runs inside a profiler window instead and the
cell's per-layer metrics are read from it.  Then the program's state is
freed and the plain reference decides `correct`.

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device[, breakdown], and last `checks`: each number
compared beside its limit, also printed as the last lines of standard error.

Without a CUDA card it exits 2 and prints no result.  `--rehearse-cpu` runs
the same path on the CPU with the program's plain versions, for tests at
tiny sizes; its line carries no metric and no device.  `--manifest` names
another BENCHMARK.json (tests).
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "menghini_neurips23_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def log(msg: str) -> None:
    print(f"[portbench +{time.perf_counter() - T0:.3f}s] {msg}", file=sys.stderr, flush=True)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--manifest", default=os.path.join(ROOT, "BENCHMARK.json"))
    ap.add_argument("--rehearse-cpu", action="store_true")
    args = ap.parse_args(argv)

    # the port's libraries must not pull JAX in through a third party
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ.pop("CLIP_BPE_PATH", None)  # the byte-level tokenizer, as the reference has
    import torch

    from portbench.harness import compare, trace as tracing
    from portbench.harness.manifest import Bench, load_module

    bench = Bench(args.manifest)
    cell = bench.workload(args.workload)
    config = bench.config(cell["config"])
    if cell["chips"] != 1:
        log(f"{args.workload} asks for {cell['chips']} cards; this harness runs one-card cells")
        return 2
    if args.rehearse_cpu:
        device = torch.device("cpu")
        torch.set_num_threads(min(4, torch.get_num_threads()))
    else:
        if not torch.cuda.is_available():
            log("no CUDA device: this benchmark measures the card and reports nothing without one")
            return 2
        device = torch.device("cuda", 0)
    log(f"torch {torch.__version__} imported")

    ctx = types.SimpleNamespace(cell=cell, config=config, seed=args.seed, device=device, log=log)
    driver = load_module("drivers", cell["driver"]).Driver(ctx)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - T0
    log(f"set-up {setup_s:.3f} s")

    metrics, extra_device, breakdown = {}, {}, None
    if args.trace and device.type == "cuda":
        before = driver.counters()
        work, tr = tracing.profiled(driver.unit, torch)  # one unit
        attempted = 1
        tr.facts = driver.facts(1, {k: v - before[k] for k, v in driver.counters().items()})
        log(f"traced window {tr.window_s:.4f} s, device busy {tr.busy_s:.4f} s, "
            f"head records lost {tr.head_lost}; facts {json.dumps(tr.facts, default=str)}")
        for e in bench.per_layer(args.workload):
            value = load_module("metrics", e["name"]).read(tr)
            if value is not None:
                metrics[e["name"]] = {"value": float(value), "unit": e["unit"]}
        extra_device = {"busy_s": tr.busy_s, "window_s": tr.window_s}
        breakdown = tracing.breakdown(tr)
    else:
        work, attempted, ends = 0, 0, []
        t_start = time.perf_counter()
        while True:
            work += driver.unit()
            attempted += 1
            ends.append(time.perf_counter() - t_start)
            if time.perf_counter() - t_start >= args.seconds:
                break
        elapsed = time.perf_counter() - t_start
        log(f"window {elapsed:.4f} s, {attempted} units, {work} {cell['work_unit']}; "
            f"unit seconds {[round(b - a, 4) for a, b in zip([0.0] + ends, ends)]}")
        for e in bench.end_to_end(args.workload):
            if e["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": e["unit"]}
            elif e["name"] == cell["rate_metric"]:
                metrics[e["name"]] = {"value": work / elapsed, "unit": e["unit"]}
            else:
                raise RuntimeError(f"{args.workload} has no reading for {e['name']}")
    peak = None
    if device.type == "cuda":
        log(f"card: {card_line()}; CUDA {torch.version.cuda}")
        peak = int(torch.cuda.max_memory_allocated(device))
    driver.release()  # the program's state goes; its outputs for the check stay
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    readings = driver.check(("program",))["program"]
    checks = compare.judge(readings, cell["limits"])
    correct = compare.is_correct(checks)
    bad = forbidden_modules()
    if bad:
        log(f"modules of JAX or the JAX package were loaded: {bad}")
        return 3
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr, flush=True)
    out = {"correct": correct, "attempted": attempted, "failed": 0 if correct else attempted}
    if not args.rehearse_cpu:
        out["metrics"] = metrics
        out["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                         "count": 1, "memory_peak_bytes": peak, **extra_device}
        if breakdown is not None:
            out["breakdown"] = breakdown
    out["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in checks}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
