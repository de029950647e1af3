#!/usr/bin/env python3
"""Data and tensor parallelism across the cards of one host, through NCCL:
main_ssl textual_fpl and visual_fpl (`--models`; fp32 or `--dtype`, full
`--encoder` width, random weights from a seed, chip_smoke.py's synthetic
10-class dataset, the bundled configs at `--lr`) in one process, again
with the initial prompt nudged by 1e-6 (the run's own sensitivity to
rounding), then in a group of `--nproc` ranks launched by
`torch.distributed.run` (one card each) for each `--mesh` layout (the
MESH_SHAPE: "N" splits every batch over N ranks, "d,m" also shares out the
tower weights over m model ranks), and each group's artifacts against the
one process's.

    python3 scripts/nccl_group_check.py --nproc 4          # on a host with 4 cards
    python3 scripts/nccl_group_check.py --nproc 4 --mesh 2,2 --mesh 1,4
    python3 scripts/nccl_group_check.py --nproc 4 --mesh 1,4 --models visual_fpl \
        --encoder ViT-L/14 --dtype bfloat16
    python3 scripts/nccl_group_check.py --nproc 4 --device cpu --encoder tiny-test \
        --per-class 20                                     # the same path over gloo

The data ranks split every batch (frozen passes and training steps) and
all-reduce the gradient inside the captured step graph; the model ranks of
a "d,m" layout each run H/m heads and 4W/m MLP rows of every tower block
and sum their partial products (2 all-reduces forward and 2 backward per
block the gradient crosses, all inside the step graph: 4 * layers + 1 a
step with the data group's).  So a group agrees with one process up to the
order of the sums: the artifacts' names and the results' keys must be
equal, every rank of the group must end with the same prompt bits, and
where the pseudolabels are the same bytes the prompts within 1e-4 (fp32;
1e-3 in bf16, where each shard's partial product is rounded once more) of
the one process's, or within the nudged run's distance if that is larger;
the script prints how far the prompts and logits are apart.  Each trained
strategy then runs its whole-run trainer again (5 epochs of 10 steps over
the first 160 training images): its step wall, and on every rank the
all-reduces its step graph captured (which must be 4 * layers + 1 under a
model axis, 1 without), and under torch.profiler the NCCL all-reduce
kernels of its replays, which must number the all-reduces counted over
groups of more than one rank (NCCL launches nothing for a one-rank sum),
or up to 2% fewer (the profiler may drop graph kernel records).  The last
line is one JSON object of the results.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = ("textual_fpl", "visual_fpl")
PROMPT_TOL = {"float32": 1e-4, "bfloat16": 1e-3}


def _args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--nproc", type=int, default=4)
    p.add_argument("--mesh", action="append", default=None,
                   help="a group's MESH_SHAPE ('N' or 'd,m'); repeat for several groups "
                   "(default: --nproc, data parallelism)")
    p.add_argument("--models", default=",".join(MODELS))
    p.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--encoder", default="ViT-B/32")
    p.add_argument("--per-class", type=int, default=64, help="train and test images per class")
    p.add_argument("--epochs", type=int, default=5)
    # the bundled 0.1 makes CoOp's run chaotic: a 1e-6 nudge of the initial
    # prompt moves one process's final prompt by 0.77 (10 epochs, tiny-test,
    # CPU); at 0.001 one process, and the group against it, stay close
    p.add_argument("--lr", type=float, default=0.001)
    p.add_argument("--out", default=os.path.join(ROOT, "build", "nccl_group_check"))
    p.add_argument("--worker", default=None, help=argparse.SUPPRESS)  # a model: run one
    p.add_argument("--tag", default=None, help=argparse.SUPPRESS)
    p.add_argument("--nudge", type=float, default=0.0, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def _sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def worker(args) -> None:
    """One process (a rank when torch.distributed.run set its variables):
    the workflow for `args.worker`, then the trainer's timed and profiled
    reruns; rank 0 writes what it saw to <out>/<tag>_<model>.json."""
    sys.path.insert(0, ROOT)
    import copy

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as smoke
    from menghini_neurips23_tpu_torch.ops.attention import attention_bwd, fused_attention
    from menghini_neurips23_tpu_torch.parallel import initialize_from_env, multihost
    from menghini_neurips23_tpu_torch.runners import common, main_ssl

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.device == "cpu":
        torch.set_num_threads(1)
    group = initialize_from_env(device=args.device)
    device = group or torch.device(args.device)
    data = os.path.join(args.out, "data")
    art = os.path.join(args.out, f"{args.tag}_{args.worker}")
    cfg = smoke.train_config(data, art, "ssl", args.worker, args.dtype, args.epochs,
                             encoder=args.encoder)
    cfg.LR = args.lr
    if group is not None:
        cfg.MESH_SHAPE = args.mesh[0]
    if args.nudge:  # the control run: the initial prompt moved by `nudge`
        from menghini_neurips23_tpu_torch.training import textual, visual

        for module in (textual, visual):
            def nudged(*a, _draw=module.init_prefix, **k):
                p = _draw(*a, **k)
                return p + args.nudge * torch.randn(
                    p.shape, generator=torch.Generator().manual_seed(9))

            module.init_prefix = nudged
    seen, run_strategy = {}, common.run_strategy

    def recorded(strategy, *a):
        seen["strategy"] = strategy
        return run_strategy(strategy, *a)

    common.run_strategy = recorded
    try:
        t0 = time.perf_counter()
        main_ssl.workflow(cfg.DATASET_DIR, cfg, device=device)
        _sync(torch, device)
        wall = time.perf_counter() - t0
    finally:
        common.run_strategy = run_strategy
    strategy = seen["strategy"]
    with open(f"{art}_prompts_rank{multihost.process_index()}.pkl", "wb") as f:
        pickle.dump(strategy.epoch_parameters(), f)  # every rank's, to compare their bits
    with open(f"{data}/MNIST/train.txt") as f:
        files = [f"{data}/MNIST/train/{line.split()[0]}" for line in f if line.strip()]
    labels = np.random.default_rng(0).choice(
        [strategy.label_to_idx[c] for c in strategy.classes], 192)
    train = smoke.Rows(files[:160], labels[:160])
    val = smoke.Rows(files[160:192], labels[160:192])
    cfg.EPOCHS, cfg.FUSED_EPOCH_CHUNK = args.epochs, 0

    def rerun():
        _sync(torch, device)
        t = time.perf_counter()
        strategy.train(copy.deepcopy(train), copy.deepcopy(val))
        _sync(torch, device)
        return time.perf_counter() - t

    strategy._fused_keep = True  # the first rerun's graphs serve the next two
    try:
        rerun()
        info = dict(strategy._fused_info)
        step_s = rerun()
        c0 = multihost.all_reduce_sum_.calls
        k0 = (fused_attention.launches, attention_bwd.launches)
        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else [])
        with profile(activities=activities) as prof:
            rerun()
        calls = multihost.all_reduce_sum_.calls - c0
        k1_k2 = [fused_attention.launches - k0[0], attention_bwd.launches - k0[1]]
    finally:
        strategy._fused_keep = False
        strategy._fused_free()
    steps = args.epochs * info["steps_per_epoch"]
    # device ms a step of the profiled run (its epoch ends included), by kernel
    kernel_ms, _, counts = smoke.profiled_kernels(prof, steps)
    nccl = {k: c for k, c in counts.items() if "nccl" in k.lower()}
    arch = strategy.runtime.arch
    rec = {"model": args.worker, "tag": args.tag, "world": multihost.process_count(),
           "mesh": [multihost.data_count(), multihost.model_count()],
           "layers": arch.transformer_layers if args.worker == "textual_fpl"
           else arch.vision_layers, "dtype": args.dtype, "encoder": args.encoder,
           "device": str(device), "workflow_wall_s": wall,
           "step_wall_ms": step_s * 1e3 / steps, "step_replays": steps,
           "epoch_end_replays": args.epochs,
           "graphs": info["graphs"], "all_reduces_per_step_graph": info["all_reduces_per_step"],
           "model_all_reduces_per_step_graph": info["model_all_reduces_per_step"],
           "all_reduces_per_epoch_end_graph": info["all_reduces_per_epoch_end"],
           "all_reduces_in_profiled_replays": calls,
           "k1_k2_launches_per_step_graph": info["launches_per_step"],
           "k1_k2_launches_per_epoch_end_graph": info["launches_per_epoch_end"],
           "k1_k2_launches_profiled": k1_k2,
           "busy_ms_per_step": sum(kernel_ms.values()),
           "nccl_ms_per_step": sum(v for k, v in kernel_ms.items() if "nccl" in k.lower()),
           "top_kernels_ms_per_step": dict(sorted(kernel_ms.items(), key=lambda kv: -kv[1])[:6]),
           "nccl_allreduce_kernels_profiled": sum(
               c for k, c in nccl.items() if "allreduce" in k.lower()),
           "nccl_kernels_profiled": nccl}
    if multihost.is_main_process():
        with open(f"{art}.json", "w") as f:
            json.dump(rec, f)
    if group is not None:
        import torch.distributed as dist

        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(args, model: str, tag: str, nproc: int, nudge: float = 0.0, mesh: str = "") -> None:
    me = os.path.abspath(__file__)
    common = ["--worker", model, "--tag", tag, "--device", args.device, "--encoder",
              args.encoder, "--epochs", str(args.epochs), "--lr", str(args.lr),
              "--nudge", str(nudge), "--out", args.out, "--dtype", args.dtype,
              "--mesh", mesh or str(nproc)]
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    if nproc == 1:
        cmd = [sys.executable, me] + common
    else:
        cmd = [sys.executable, "-m", "torch.distributed.run", f"--nproc_per_node={nproc}",
               "--master_addr=127.0.0.1", f"--master_port={_free_port()}", me] + common
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, cwd=args.out, capture_output=True, text=True,
                          timeout=1500)
    print(f"{tag} {model}: exit {proc.returncode} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    if proc.returncode != 0:
        print(proc.stdout[-4000:], proc.stderr[-6000:], sep="\n", flush=True)
        raise SystemExit(f"{tag} {model} failed")


def _files(root: str):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs if "checkpoints" not in d)


def _leaves(x):
    import numpy as np

    if isinstance(x, dict):
        return [v for k in sorted(x) for v in _leaves(x[k])]
    if isinstance(x, (list, tuple)):
        return [v for t in x for v in _leaves(t)]
    return [] if x is None else [np.asarray(x)]


def compare(single: str, group: str) -> dict:
    """What the group's artifacts share with the one process's."""
    import numpy as np

    names_a, names_b = _files(single), _files(group)
    out = {"artifact_names_equal": names_a == names_b, "pseudolabels_same_bytes": True,
           "prompt_max_abs_diff": 0.0, "logits_max_abs_diff": 0.0,
           "predictions_equal": True, "result_keys_equal": True}
    for rel in names_a:
        if rel not in names_b:
            continue
        with open(os.path.join(single, rel), "rb") as f:
            a = f.read()
        with open(os.path.join(group, rel), "rb") as f:
            b = f.read()
        if rel.startswith("results_model_"):
            ra, rb = (json.loads(x.splitlines()[0]) for x in (a, b))
            out["result_keys_equal"] = sorted(ra) == sorted(rb)
            out["results"] = {k: [ra[k], rb[k]] for k in ra if k not in ("config", "model")}
        elif rel.startswith("pseudolabels"):
            out["pseudolabels_same_bytes"] &= a == b
        elif rel.endswith(".pickle"):
            pa, pb = pickle.loads(a), pickle.loads(b)
            key = "logits_max_abs_diff" if rel.startswith("evaluation") else "prompt_max_abs_diff"
            if isinstance(pa, dict) and "predictions" in pa:
                out["predictions_equal"] &= pa["predictions"] == pb["predictions"]
            for x, y in zip(_leaves(pa), _leaves(pb)):
                if np.issubdtype(x.dtype, np.floating):
                    out[key] = max(out[key], float(np.abs(x - y).max()))
    return out


def main(argv=None) -> int:
    args = _args(argv)
    args.out = os.path.abspath(args.out)  # the workers run from inside it
    if args.worker:
        worker(args)
        return 0
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke

    os.makedirs(args.out, exist_ok=True)
    smoke.N_PER_CLASS = args.per_class
    t0 = time.perf_counter()
    smoke.make_dataset(os.path.join(args.out, "data", "MNIST"))
    print(f"dataset: 10 classes x {args.per_class} train + test images in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if args.device == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        print(smi.stdout.strip(), flush=True)
    results, ok = {}, True
    meshes = args.mesh or [str(args.nproc)]
    for model, mesh in ((m, mesh) for m in args.models.split(",") for mesh in meshes):
        if mesh == meshes[0]:
            _launch(args, model, "single", 1)
            _launch(args, model, "control", 1, nudge=1e-6)
        tag = f"group{args.nproc}_mesh{mesh.replace(',', 'x')}"
        _launch(args, model, tag, args.nproc, mesh=mesh)
        single = os.path.join(args.out, f"single_{model}")
        group = os.path.join(args.out, f"{tag}_{model}")
        with open(f"{single}.json") as f:
            one = json.load(f)
        with open(f"{group}.json") as f:
            many = json.load(f)
        cmp = compare(single, group)
        # how far one process moves from itself when its initial prompt is
        # nudged by 1e-6: the run's own sensitivity to rounding
        control = compare(single, os.path.join(args.out, f"control_{model}"))
        prompts = []
        for r in range(args.nproc):
            with open(f"{group}_prompts_rank{r}.pkl", "rb") as f:
                prompts.append(pickle.load(f))
        ranks_equal = all(len(p) == len(prompts[0]) and all(
            a.tobytes() == b.tobytes() for a, b in zip(p, prompts[0])) for p in prompts)
        d, m = many["mesh"]
        # every all-reduce the profiled window counted, less the data group's
        # one a step when that group is one rank (NCCL launches no kernel)
        expect_kernels = many["all_reduces_in_profiled_replays"] - (
            many["step_replays"] if d == 1 else 0)
        rec = {"model": model, "world": many["world"], "mesh": mesh, "data_x_model": [d, m],
               "encoder": args.encoder, "dtype": args.dtype, "lr": args.lr, "compare": cmp,
               "ranks_prompts_bit_equal": ranks_equal,
               "one_process_nudged_1e-6": {k: control[k] for k in (
                   "prompt_max_abs_diff", "logits_max_abs_diff", "predictions_equal")},
               "step_wall_ms": {"one_process": one["step_wall_ms"], "group": many["step_wall_ms"]},
               "workflow_wall_s": {"one_process": one["workflow_wall_s"],
                                   "group": many["workflow_wall_s"]},
               "step_wall_ratio": many["step_wall_ms"] / one["step_wall_ms"],
               "busy_ms_per_step": {"one_process": one["busy_ms_per_step"],
                                    "group": many["busy_ms_per_step"]},
               "nccl_ms_per_step": many["nccl_ms_per_step"],
               "k1_k2_launches_per_step_graph": {
                   "one_process": one["k1_k2_launches_per_step_graph"],
                   "group": many["k1_k2_launches_per_step_graph"]},
               "k1_k2_launches_profiled": many["k1_k2_launches_profiled"],
               "top_kernels_ms_per_step": {"one_process": one["top_kernels_ms_per_step"],
                                           "group": many["top_kernels_ms_per_step"]},
               "step_replays_profiled": many["step_replays"],
               "epoch_end_replays_profiled": many["epoch_end_replays"],
               "layers": many["layers"],
               "all_reduces_per_step_graph": many["all_reduces_per_step_graph"],
               "predicted_per_step_graph": 4 * many["layers"] + 1 if m > 1 else 1,
               "model_all_reduces_per_step_graph": many["model_all_reduces_per_step_graph"],
               "all_reduces_per_epoch_end_graph": many["all_reduces_per_epoch_end_graph"],
               "all_reduces_in_profiled_replays": many["all_reduces_in_profiled_replays"],
               "nccl_allreduce_kernels_expected": expect_kernels,
               "nccl_allreduce_kernels_profiled": many["nccl_allreduce_kernels_profiled"],
               "nccl_allreduce_kernels_per_step_replay":
                   many["nccl_allreduce_kernels_profiled"] / many["step_replays"],
               "nccl_kernels_profiled": many["nccl_kernels_profiled"]}
        print(json.dumps(rec), flush=True)
        results[f"{model}@{mesh}"] = rec
        checks = [cmp["artifact_names_equal"], cmp["result_keys_equal"], ranks_equal]
        if many["graphs"]:
            # the replays' all-reduces: the step graph's, each replay, and the
            # epoch end's (the validation's forward, under a model axis)
            replayed = (many["step_replays"] * many["all_reduces_per_step_graph"]
                        + many["epoch_end_replays"] * many["all_reduces_per_epoch_end_graph"])
            checks += [many["all_reduces_in_profiled_replays"] == replayed,
                       many["all_reduces_per_step_graph"] == rec["predicted_per_step_graph"]]
        elif m == 1:  # run eagerly (the CPU): one all-reduce a step
            checks.append(many["all_reduces_in_profiled_replays"] == many["step_replays"])
        if args.device == "cuda":
            # captured graphs; the profiler may drop a few graph kernel records
            # (chip_smoke.py allows 2% fewer, never more)
            n = many["nccl_allreduce_kernels_profiled"]
            checks += [many["graphs"], 0.98 * expect_kernels <= n <= expect_kernels]
        # the group no farther from one process than PROMPT_TOL, or than one
        # process from itself under the nudge
        if cmp["pseudolabels_same_bytes"]:
            checks.append(cmp["prompt_max_abs_diff"]
                          <= max(PROMPT_TOL[args.dtype], control["prompt_max_abs_diff"]))
        rec["checks"] = checks
        ok &= all(checks)
    print(json.dumps({"ok": bool(ok), "results": results}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
