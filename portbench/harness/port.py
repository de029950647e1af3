"""The system under test: the port's runtime, built on the benchmark's inputs.

`ClipRuntime` takes no state dict: without a checkpoint it draws its own
weights through `init_clip_params` and derives its state from them (the
precast matmul weights, the normalisation folded into the patch kernel).
`runtime()` hands it the benchmark's weights in that function's place while
it is built, so that every tensor it derives follows them.  The images
reach it through its decoded-image cache, filled from memory, as a GRIP
refresh re-reads its pool: no file is read or decoded.
"""

from __future__ import annotations

import shutil
import tempfile
from typing import Dict, List, Sequence

import numpy as np

from portbench.harness import inputs

ARCH_KEYS = ("embed_dim", "image_resolution", "vision_layers", "vision_width",
             "vision_patch_size", "vision_heads", "context_length", "vocab_size",
             "transformer_width", "transformer_heads", "transformer_layers")


def port_config(cell: dict, config: dict, seed: int, **extra):
    """The port's Config for a cell: its traffic's training settings."""
    from menghini_neurips23_tpu_torch.config import Config

    return Config(
        VIS_ENCODER=config["arch"], MODEL=cell["model"], LEARNING_PARADIGM=cell["paradigm"],
        DATASET_NAME=cell["dataset"], COMPUTE_DTYPE=cell["dtype"],
        BATCH_SIZE=cell["batch_size"], PREFIX_SIZE=cell.get("prefix_size", 16),
        N_PSEUDOSHOTS=cell["pseudo_per_class"], OPTIM_SEED=inputs.sub_seed(seed, "optim", 31),
        ARTIFACT_DIR=tempfile.mkdtemp(prefix="portbench_artifacts_"), BPE_PATH="",
        CLIP_CKPT="", **extra)


def runtime(cfg, config: dict, seed: int, device):
    """A ClipRuntime holding the benchmark's weights for `seed`."""
    from menghini_neurips23_tpu_torch import runtime as rt_mod

    sd = inputs.clip_weights(config, seed, device)
    made = rt_mod.init_clip_params
    rt_mod.init_clip_params = lambda arch, seed=0, device=None: sd
    try:
        rt = rt_mod.ClipRuntime(cfg, device=device)
    finally:
        rt_mod.init_clip_params = made
    arch = rt.arch
    for k in ARCH_KEYS:
        if getattr(arch, k) != config[k]:
            raise ValueError(f"the port's {arch.name} has {k} {getattr(arch, k)}, "
                             f"the configuration {config[k]}")
    return rt


def fill_decode_cache(rt, paths: Sequence[str], pool: np.ndarray) -> None:
    """Put each (R, R, 3) uint8 image of `pool` in the runtime's decode cache
    under its path."""
    cache = rt._decode_cache
    if cache is None or cache.max_bytes < pool.nbytes:
        raise ValueError("the cell's pool does not fit the runtime's DECODE_CACHE_BYTES")
    for p, img in zip(paths, pool):
        cache.put(p, img)


def dataset(names: List[str], labels=None, label_id=True, label_map: Dict[str, int] = None):
    """A FileListDataset of the pool's names (paths resolve to pool/train/<name>)."""
    from menghini_neurips23_tpu_torch.data.datasets import FileListDataset

    return FileListDataset(names, "pool", train=True, labels=labels, label_id=label_id,
                           label_map=label_map)


def launch_counters() -> Dict[str, int]:
    """The program's kernel launch counters (K1, K2, K3 calls)."""
    from menghini_neurips23_tpu_torch.ops.attention import attention_bwd, fused_attention
    from menghini_neurips23_tpu_torch.ops.clip_head import fused_probs

    return {"k1": fused_attention.launches, "k2": attention_bwd.launches,
            "k3": fused_probs.launches}


class _Replay:
    """A captured graph whose every replay is followed by `after()`."""

    def __init__(self, graph, after):
        self.graph, self.after = graph, after

    def replay(self):
        self.graph.replay()
        self.after()


def watch_steps(strategy, after):
    """Call `after(program)` after every optimizer step of the strategy's
    whole-run program, from the next `train()` call on: after each replay of
    its captured step graph on the card, after each eager step on the CPU.
    Returns a function that stops watching."""
    made = strategy._fused_program
    seen = []

    def program(*a, **kw):
        prog = made(*a, **kw)
        if prog in seen:
            return prog
        seen.append(prog)
        if prog.graphs is not None:
            prog.graphs = (_Replay(prog.graphs[0], lambda: after(prog)), prog.graphs[1])
        elif prog.capture_graphs:
            capture = prog.capture

            def capture_watched():
                capture()
                prog.graphs = (_Replay(prog.graphs[0], lambda: after(prog)), prog.graphs[1])

            prog.capture = capture_watched
        else:
            step = prog.step

            def step_watched():
                step()
                after(prog)

            prog.step = step_watched
        return prog

    strategy._fused_program = program

    def stop():
        del strategy._fused_program
        for prog in seen:
            prog.__dict__.pop("capture", None)
            prog.__dict__.pop("step", None)
            if prog.graphs is not None and isinstance(prog.graphs[0], _Replay):
                prog.graphs = (prog.graphs[0].graph, prog.graphs[1])

    return stop


def images_host(seed: int, count: int, resolution: int, device) -> np.ndarray:
    return inputs.images(seed, count, resolution, device).cpu().numpy()


def close(strategy) -> None:
    """Drop a strategy's whole-run program (graphs, pool, buffers) and its
    artifact directory, which nothing in a cell writes to."""
    if strategy is not None:
        strategy._fused_free()
        shutil.rmtree(strategy.config.ARTIFACT_DIR, ignore_errors=True)
