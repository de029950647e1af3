"""Time the per-step training loop (FUSED_TRAIN off) of the port under ROOT
on one CUDA card, so that two trees can be compared in one call.

For CoOp (textual_fpl), VPT (visual_fpl) and UPT (multimodal_fpl) at
ViT-B/32 width, bf16, random weights: `_apply_step` on a fixed 16-row batch
at lr 0 (ms per step on the host clock, then device busy ms, device ops and
idle share under torch.profiler), and the wall of a 20-epoch `train()` in
the per-step loop over 160 training and 32 validation rows of synthetic
frozen features (10 steps of 16 a epoch).  Where the tree has the whole-run
trainer, the same `train()` through it too.  Prints one JSON line.

    python3 scripts/step_loop_compare.py [ROOT] [--label NAME]

To compare with a parent commit: unpack it into a directory that .gitignore
lists (`git archive <parent> | tar -x -C build/parent`) and run parent,
current, current, parent one after another on the same card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

STEPS = 20
EPOCHS = 20
N_CLASSES = 10


class Rows:
    """What `train()` reads of a dataset: file paths naming rows of a
    feature table that stands in for the frozen towers' output."""

    transform = None
    label_id = True

    def __init__(self, paths, labels):
        self.filepaths, self.labels = list(paths), [int(x) for x in labels]

    def label_ids(self):
        return list(self.labels)


def device_kernels(prof, n: int):
    """(device busy ms per unit of n, device ops per unit of n)."""
    from torch.autograd import DeviceType

    busy, ops = 0.0, 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            busy += us / 1e3
            ops += e.count
    return busy / n, ops / n


def measure(torch, rt, cls, model: str, table, labels) -> dict:
    import copy

    from torch.profiler import ProfilerActivity, profile

    from menghini_neurips23_tpu_torch.training import strategy as strategy_mod

    classes = [str(i) for i in range(N_CLASSES)]
    cfg = copy.copy(rt.cfg)
    cfg.MODEL, cfg.EPOCHS = model, EPOCHS
    paths = [f"row{i}" for i in range(len(table))]
    row = {p: i for i, p in enumerate(paths)}

    def strategy(fused: bool):
        c = copy.copy(cfg)
        c.FUSED_TRAIN = fused
        s = cls(c, {k: i for i, k in enumerate(classes)}, classes, classes, classes, runtime=rt)
        s._features_for_paths = lambda ps, **k: table[[row[p] for p in ps]]
        return s

    def run(s) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.train(Rows(paths[:160], labels[:160]), Rows(paths[160:192], labels[160:192]),
                only_seen=True)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    s = strategy(False)
    s.train(Rows(paths[:160], labels[:160]), Rows(paths[160:192], labels[160:192]),
            only_seen=True)  # builds the state the step needs; warms the kernels
    dev = s.device
    ctx = s._class_context(classes)
    feats = torch.tensor(table[:16], device=dev)
    lab = torch.tensor(labels[:16], device=dev).int()
    group = (torch.arange(16, device=dev) % 2).int()
    valid = torch.ones(16, device=dev)

    def steps() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEPS):
            s._apply_step(ctx, 0.0, feats, lab, group, valid)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / STEPS

    steps()
    host_ms = steps()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        steps()
    busy, ops = device_kernels(prof, STEPS)
    out = {
        "step_host_ms": host_ms, "step_busy_ms": busy, "step_device_ops": ops,
        "step_idle_share": 1 - busy / host_ms,
        "per_step_loop_run_s": run(strategy(False)),
    }
    if hasattr(strategy_mod.TrainingStrategy, "_fused_train"):
        s = strategy(True)
        s._fused_keep = True  # the graphs the first run captures serve the second
        out["whole_run_trainer_first_run_s"] = run(s)
        out["whole_run_trainer_run_s"] = run(s)
        s._fused_keep = False
        s._fused_free()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("step_loop_compare: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from menghini_neurips23_tpu_torch.config import Config
    from menghini_neurips23_tpu_torch.runtime import ClipRuntime
    from menghini_neurips23_tpu_torch.training import (
        MultimodalStrategy,
        TextualStrategy,
        VisualStrategy,
    )

    cfg = Config(VIS_ENCODER="ViT-B/32", COMPUTE_DTYPE="bfloat16", BATCH_SIZE=16, OPTIM_SEED=1,
                 LR=0.5, WARMUP_EPOCHS=0, MOMENTUM=0.9)
    rt = ClipRuntime(cfg, device="cuda")
    a = rt.arch
    rng = np.random.default_rng(5)
    labels = rng.integers(0, N_CLASSES, 192)
    coop = rng.normal(0, 1, (192, a.embed_dim)).astype(np.float32)
    coop /= np.linalg.norm(coop, axis=1, keepdims=True)
    tokens = rng.normal(0, 1, (192, 1 + a.num_patches, a.vision_width)).astype(np.float32)
    t0 = time.perf_counter()
    res = {}
    for what, cls, model, table in (("coop", TextualStrategy, "textual_fpl", coop),
                                    ("vpt", VisualStrategy, "visual_fpl", tokens),
                                    ("upt", MultimodalStrategy, "multimodal_fpl", tokens)):
        res[what] = measure(torch, rt, cls, model, table, labels)
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "menghini_neurips23_tpu"))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()
    print(json.dumps({"label": args.label or args.root, "card": card[:1], "torch": torch.__version__,
                      "wall_s": time.perf_counter() - t0, "jax_imported": leaked, **res}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
