"""Read the numbers `correct` compares, for setting their limits (not run by
the benchmark's own runs).

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 ... [--variants program control fault_half]

For each seed, in one process: the cell's set-up at its own size (the
program's first training call, or one pass, through the timed path), then
the reference in fp32 and each variant against it:
- program: the program, as every run compares it;
- control: the reference computed in TF32 in the program's place (the
  nearest precision below the configuration's fp32);
- fault_half (training): the reference leaving out half of every batch,
  the mean taken over the rest.
Without `program` among the variants the program is not built.
One JSON line a seed goes to standard output and to --out.
"""

import argparse
import gc
import json
import os
import sys
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--variants", nargs="+", default=["program", "control"])
    ap.add_argument("--manifest", default=os.path.join(ROOT, "BENCHMARK.json"))
    ap.add_argument("--out", default="")
    ap.add_argument("--rehearse-cpu", action="store_true")
    args = ap.parse_args(argv)
    os.environ["USE_FLAX"] = "0"
    os.environ.pop("CLIP_BPE_PATH", None)
    import torch

    from portbench.harness.manifest import Bench, load_module

    bench = Bench(args.manifest)
    cell = bench.workload(args.workload)
    config = bench.config(cell["config"])
    device = torch.device("cpu" if args.rehearse_cpu else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    drivers = load_module("drivers", cell["driver"])
    out = open(args.out, "a") if args.out else None
    for seed in args.seeds:
        t0 = time.perf_counter()
        ctx = types.SimpleNamespace(cell=cell, config=config, seed=seed, device=device,
                                    log=lambda m: print(m, file=sys.stderr),
                                    reference_only="program" not in args.variants)
        driver = drivers.Driver(ctx)
        driver.release()
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        readings = driver.check(tuple(args.variants))
        line = json.dumps({"workload": args.workload, "seed": seed, "readings": readings,
                           "seconds": time.perf_counter() - t0})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        del driver
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
