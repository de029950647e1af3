"""Checkpoint / resume for iterative training (torch.save + JSON manifest).

The reference has no optimizer or iteration checkpointing: its only
resumability is the pseudolabel pickle cache (reference
utils/clip_pseudolabels.py:134-143).  Every IFPL/GRIP iteration persists a
resume state here - the iteration counter, the pseudoshot schedule
position, the best-so-far prompt parameters, the numpy permutation RNG's
state and the prompt re-init counter - keyed by the run identity the
reference uses for its artifacts ({dataset, paradigm, model, encoder,
optim_seed, split_seed}), so a killed run restarts at the iteration
boundary instead of from scratch, bit-identical to an uninterrupted run.

Layout (the JAX package's): ARTIFACT_DIR/checkpoints/<run_key>/iter_<n>/
holding `manifest.json` and the parameters.  The parameters are one
`torch.save` file, `params.pt`: the prompt parameter list with every array
as a CPU tensor, `None` kept (UPT's missing deep slot) and the UPT mixer's
parameter dicts kept as dicts; it loads with `weights_only=True`.  The JAX
package writes orbax checkpoints there instead, so neither package resumes
the other's runs.  A directory is written as `iter_<n>.tmp` and renamed
when complete.  In a process group (parallel/) rank 0 writes and clears,
between two barriers for an iteration state (JAX checkpoint.py:63-105), so
that no rank goes on before the state exists; every rank reads, so the
directory must be on a filesystem the ranks share.

Inside an iteration, the whole-run trainer split by FUSED_EPOCH_CHUNK saves
its carry at every chunk boundary (`save_chunk_state`, the JAX package's
checkpoint.py:145-227): `chunk_<fingerprint>.pt` beside the iteration
directories, one `torch.save` file written to a .tmp name and renamed.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch

from menghini_neurips23_tpu_torch.parallel.multihost import barrier, is_main_process

log = logging.getLogger(__name__)

_PARAMS_FILE = "params.pt"


def run_key(config) -> str:
    enc = config.VIS_ENCODER.replace("/", "")
    return (
        f"{config.DATASET_NAME}_{config.LEARNING_PARADIGM}_{config.MODEL}_{enc}"
        f"_opt_{config.OPTIM_SEED}_spl_{config.SPLIT_SEED}"
    )


def _ckpt_dir(config) -> str:
    return os.path.join(
        getattr(config, "ARTIFACT_DIR", ".") or ".", "checkpoints", run_key(config)
    )


def _to_tensors(tree):
    """numpy leaves -> CPU tensors owning a copy; lists, tuples, dicts and
    None keep their structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _to_tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_tensors(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def _to_numpy(tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_numpy(v) for v in tree]
    return tree.numpy()


def save_iteration_state(
    config,
    iteration: int,
    n_pseudoshots: int,
    best_metric: float,
    best_params: Any,
    rng_state: Optional[dict] = None,
    reinit: Optional[int] = None,
) -> str:
    """Persist resume state after a completed IFPL/GRIP iteration.

    rng_state (the numpy Generator's bit_generator.state) and reinit (the
    prompt re-init counter that seeds the prompt's torch.Generator) make a
    resumed run bit-identical to an uninterrupted one: without them the
    restarted process would draw fresh permutation streams and prompts."""
    path = os.path.join(_ckpt_dir(config), f"iter_{iteration}")
    barrier()  # every rank has finished the iteration
    if is_main_process():
        tmp = path + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        torch.save(_to_tensors(best_params), os.path.join(tmp, _PARAMS_FILE))
        manifest = {
            "iteration": iteration,
            "n_pseudoshots": int(n_pseudoshots),
            "best_metric": float(best_metric),
            "run": run_key(config),
            "rng_state": rng_state,
            "reinit": reinit,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)
        log.info("checkpointed iteration %d -> %s", iteration, path)
    barrier()  # no rank goes on before the state exists
    return path


def latest_iteration_state(config) -> Optional[dict]:
    """The newest completed iteration's manifest with its `best_params`
    (numpy), or None.  A corrupt or partial checkpoint warns and returns
    None: the run starts fresh."""
    base = _ckpt_dir(config)
    if not os.path.isdir(base):
        return None
    iters = []
    for name in os.listdir(base):
        if name.startswith("iter_") and not name.endswith(".tmp"):
            try:
                iters.append(int(name.split("_")[1]))
            except ValueError:
                continue
    if not iters:
        return None
    path = os.path.join(base, f"iter_{max(iters)}")
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        params = torch.load(os.path.join(path, _PARAMS_FILE), map_location="cpu",
                            weights_only=True)
        manifest["best_params"] = _to_numpy(params)
        return manifest
    except Exception as e:
        # a corrupt or partial checkpoint: the run starts fresh.  What a
        # damaged file raises depends on where it breaks (torch's unpickler
        # alone raises several types), so the boundary takes them all.
        log.warning("could not restore checkpoint %s: %s", path, e)
        return None


def clear_run_checkpoints(config):
    base = _ckpt_dir(config)
    if is_main_process() and os.path.isdir(base):
        shutil.rmtree(base)


# --------------------------------------------------------------- chunk states
# A run of the whole-run trainer split into FUSED_EPOCH_CHUNK-epoch chunks
# (strategy._fused_chunked_call) fetches its stats at every chunk boundary;
# with CHECKPOINT_ITER it also persists its carry there, so a kill costs at
# most one chunk instead of a whole IFPL/GRIP iteration.  The state is keyed
# by a fingerprint of everything that determines the computation (the
# permutation and lr schedules, the epoch and chunk counts, the initial
# carry): a resumed run, whose restored RNG stream and prompt re-init counter
# reproduce those inputs exactly, picks up the saved carry; any divergent run
# misses the key and recomputes.

def chunk_fingerprint(perms, lrs, epochs: int, chunk: int, carry0) -> str:
    """sha256 over perms, lrs, "epochs/chunk" and every leaf of the initial
    carry (dtype, shape, bytes; dicts by sorted key), first 32 hex digits."""
    import hashlib

    h = hashlib.sha256()
    h.update(np.ascontiguousarray(perms).tobytes())
    h.update(np.ascontiguousarray(lrs).tobytes())
    h.update(f"{epochs}/{chunk}".encode())

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in leaves(tree[k])]
        if isinstance(tree, (list, tuple)):
            return [x for t in tree for x in leaves(t)]
        return [np.asarray(tree)]

    for arr in leaves(carry0):
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()[:32]


def _chunk_path(config, fingerprint: str) -> str:
    return os.path.join(_ckpt_dir(config), f"chunk_{fingerprint}.pt")


def save_chunk_state(config, fingerprint: str, next_start: int, carry, outs_list) -> str:
    """Persist the carry after a chunk - (prompt, mom, gacc, best_metric,
    best_prompt), host arrays - and the per-chunk (3, chunk) stats so far.
    Rank 0 writes; every rank holds the same carry."""
    path = _chunk_path(config, fingerprint)
    if not is_main_process():
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save({"fmt": 2, "next_start": int(next_start), "carry": _to_tensors(carry),
                "outs_list": _to_tensors(outs_list)}, tmp)
    os.replace(tmp, path)
    log.info("checkpointed fused chunk (next epoch %d) -> %s", next_start, path)
    return path


def load_chunk_state(config, fingerprint: str) -> Optional[dict]:
    """The saved state for `fingerprint` with numpy leaves, or None (none
    saved, or unreadable: the run recomputes the iteration)."""
    path = _chunk_path(config, fingerprint)
    if not os.path.exists(path):
        return None
    try:
        state = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:  # truncated or corrupt: recompute from scratch
        log.warning("could not restore chunk state %s: %s", path, e)
        return None
    if state.get("fmt") != 2:
        log.warning("ignoring chunk state %s with another format", path)
        return None
    state["carry"] = _to_numpy(state["carry"])
    state["outs_list"] = _to_numpy(state["outs_list"])
    return state


def clear_chunk_state(config, fingerprint: str):
    path = _chunk_path(config, fingerprint)
    if is_main_process() and os.path.exists(path):
        os.remove(path)
