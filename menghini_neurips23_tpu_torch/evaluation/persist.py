"""Result/artifact persistence with the reference's filename schemas
(reference utils/compute_metrics.py:58-171).

Artifacts: the results JSON line, the predictions pickle, the per-iteration
pseudolabels of IFPL/GRIP under pseudolabels/, and the trained prompt under
trained_prompts/: [prefix] for CoOp, [prefix] or [prefix, deep] for VPT, a
pickled list of numpy arrays, or with ARTIFACT_FORMAT="torch" the
reference's list of torch tensors; for UPT eight files, one per part of
MULTI_PART_NAMES (numpy pickles, or with ARTIFACT_FORMAT="torch" the
reference's five `torch.save` state_dicts and three numpy pickles).  In a
process group (parallel/) rank 0 alone writes them (the JAX package's
persist.py:34-35); every rank holds the same values.
"""

from __future__ import annotations

import json
import logging
import os
import pickle
from typing import List

import numpy as np
import torch

from menghini_neurips23_tpu_torch.evaluation import interop
from menghini_neurips23_tpu_torch.parallel.multihost import is_main_process

log = logging.getLogger(__name__)

MULTI_PART_NAMES = [
    "transformer",
    "proj_coop_pre",
    "proj_coop_post",
    "proj_vpt_pre",
    "proj_vpt_post",
    "coop_embeddings",
    "deep_vpt",
    "vpt_embeddings",
]


def _artifact_dir(config) -> str:
    return getattr(config, "ARTIFACT_DIR", ".") or "."


def _ensure_dir(path: str):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)


def _config_dict(config) -> dict:
    if hasattr(config, "as_dict"):
        return config.as_dict()
    return dict(config.__dict__)


def store_results(obj_conf, std_response):
    """Append a JSON line to results_model_{MODEL}.json (reference :58-103)."""
    if not is_main_process():
        return
    if obj_conf.LEARNING_PARADIGM == "trzsl":
        results = {
            "model": obj_conf.MODEL,
            "config": _config_dict(obj_conf),
            "harmonic_mean": std_response[2],
            "seen_accuracy": std_response[1],
            "unseen_accuracy": std_response[0],
        }
    else:
        results = {
            "model": obj_conf.MODEL,
            "config": _config_dict(obj_conf),
            "accuracy": std_response[0],
        }
    file_name = f"{_artifact_dir(obj_conf)}/results_model_{obj_conf.MODEL}.json"
    _ensure_dir(file_name)
    mode = "a" if os.path.exists(file_name) else "w"
    with open(file_name, mode) as f:
        f.write(json.dumps(results, default=float) + "\n")


def _prompt_file_name(config, iteration=None) -> str:
    enc = config.VIS_ENCODER.replace("/", "")
    it = "" if iteration is None else f"_iter_{iteration}"
    return (
        f"{_artifact_dir(config)}/trained_prompts/{config.DATASET_NAME}_"
        f"{config.LEARNING_PARADIGM}_{config.MODEL}_{enc}{it}_opt_"
        f"{config.OPTIM_SEED}_spl_{config.SPLIT_SEED}.pickle"
    )


def _save_multi(obj, file_name: str, torch_fmt: bool):
    """The 8 multimodal parts, one file each, named by MULTI_PART_NAMES."""
    base = file_name.rsplit(".", 1)[0]
    for idx, name in enumerate(MULTI_PART_NAMES):
        part = obj[idx]
        if torch_fmt and idx < 5:
            torch.save(interop.multi_part_to_torch(idx, part), f"{base}_{name}.pt")
            continue
        if torch_fmt and part is not None:
            # the reference pickles the three embeddings as numpy at the
            # BATCHED rank its UPTModel holds: coop and vpt (1, L, W)
            # (prompts_models.py:88-95); deep is already (depth, L, W)
            part = np.asarray(part)
            if idx in (5, 7) and part.ndim == 2:
                part = part[None]
        with open(f"{base}_{name}.pickle", "wb") as f:
            pickle.dump(part, f)


def save_parameters(obj: List[np.ndarray], config, iteration=None):
    """Pickle prompt params (reference :105-147).  Multimodal prompts write
    8 separate artifacts keyed by MULTI_PART_NAMES, as the reference does.

    ARTIFACT_FORMAT="torch" writes the reference's layout instead: a pickled
    list of torch tensors, the textual prefix batched to (1, L, W) as the
    reference's TextPrefixModel holds it (clip_encoders.py:55-67); a visual
    prefix stays (L, W), as the JAX package writes it; the multimodal parts
    as above."""
    if not is_main_process():
        return
    file_name = _prompt_file_name(config, iteration)
    _ensure_dir(file_name)
    torch_fmt = getattr(config, "ARTIFACT_FORMAT", "numpy") == "torch"
    if config.MODALITY == "multi":
        _save_multi(obj, file_name, torch_fmt)
        return
    obj = [None if p is None else np.asarray(p) for p in obj]
    if torch_fmt:
        if config.MODALITY == "text":
            obj = [p if p is None or p.ndim != 2 else p[None] for p in obj]
        obj = interop.tensor_list_to_torch(obj)
    with open(file_name, "wb") as f:
        pickle.dump(obj, f)


def _load_multi_part(base: str, idx: int, name: str):
    """One multimodal part, from our numpy pickles or the reference's torch
    formats (.pt state_dicts, pickled tensors)."""
    pkl = f"{base}_{name}.pickle"
    if os.path.exists(pkl):
        with open(pkl, "rb") as f:
            part = pickle.load(f)
        if idx == 0 and isinstance(part, dict) and any("resblocks." in k for k in part):
            return interop.multi_part_from_torch(idx, part)
        if idx in (1, 2, 3, 4) and isinstance(part, dict) and "weight" in part:
            return interop.multi_part_from_torch(idx, part)
        if idx >= 5:
            arr = interop.to_numpy(part)
            if arr is not None and idx in (5, 7) and arr.ndim == 3 and arr.shape[0] == 1:
                # the reference's UPTModel holds coop and vpt batched
                # (1, L, W); ours are (L, W)
                arr = arr[0]
            return arr
        return part
    pt = f"{base}_{name}.pt"
    if os.path.exists(pt):
        return interop.multi_part_from_torch(
            idx, torch.load(pt, map_location="cpu", weights_only=True)
        )
    raise FileNotFoundError(f"neither {pkl} nor {pt} exists")


def load_saved_parameters(config, iteration=None):
    """Load a prompt artifact, ours or reference-produced (torch tensors are
    converted to numpy; torch state_dict layouts to our flax-layout parts)."""
    file_name = _prompt_file_name(config, iteration)
    if config.MODALITY == "multi":
        base = file_name.rsplit(".", 1)[0]
        return [_load_multi_part(base, idx, name) for idx, name in enumerate(MULTI_PART_NAMES)]
    with open(file_name, "rb") as f:
        out = pickle.load(f)
    if any(hasattr(p, "detach") for p in out if p is not None):
        out = interop.tensor_list_from_torch(out)
    return out


def save_pseudo_labels(imgs, labs, config, iteration):
    """Pickle the pseudolabels an IFPL/GRIP iteration trained on, with the
    reference's file name."""
    if not is_main_process():
        return
    enc = config.VIS_ENCODER.replace("/", "")
    filename = (
        f"{_artifact_dir(config)}/pseudolabels/{config.DATASET_NAME}_"
        f"{config.LEARNING_PARADIGM}_{config.MODEL}_{enc}_iter_{iteration}_opt_"
        f"{config.OPTIM_SEED}_spl_{config.SPLIT_SEED}.pickle"
    )
    _ensure_dir(filename)
    with open(filename, "wb") as f:
        pickle.dump({"filepaths": list(imgs), "labels": list(labs)}, f)


def save_predictions(obj, config, iteration=None):
    if not is_main_process():
        return
    enc = config.VIS_ENCODER.replace("/", "")
    it = "" if iteration is None else f"_iter_{iteration}"
    file_name = (
        f"{_artifact_dir(config)}/evaluation/{config.DATASET_NAME}_"
        f"{config.LEARNING_PARADIGM}_{config.MODEL}_{enc}{it}_opt_"
        f"{config.OPTIM_SEED}_spl_{config.SPLIT_SEED}.pickle"
    )
    _ensure_dir(file_name)
    with open(file_name, "wb") as f:
        pickle.dump(obj, f)
