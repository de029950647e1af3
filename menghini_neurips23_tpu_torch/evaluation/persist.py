"""Result/artifact persistence with the reference's filename schemas
(reference utils/compute_metrics.py:58-171).

Artifacts: the results JSON line, the predictions pickle, and the trained
prompt under trained_prompts/ ([prefix] for CoOp, [prefix] or [prefix,
deep] for VPT) - a pickled list of numpy arrays, or with
ARTIFACT_FORMAT="torch" the reference's list of torch tensors.  The
multimodal 8-part layout arrives with the UPT slice.  One process runs on
one device, so it is the main process and writes every artifact.
"""

from __future__ import annotations

import json
import logging
import os
import pickle
from typing import List

import numpy as np

from menghini_neurips23_tpu_torch.evaluation import interop

log = logging.getLogger(__name__)


def _refuse_multi(config) -> None:
    if config.MODALITY == "multi":
        raise NotImplementedError(
            "multimodal prompt artifacts are not in this package yet: they arrive "
            "with the UPT slice (ROADMAP M11)"
        )


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


def save_parameters(obj: List[np.ndarray], config, iteration=None):
    """Pickle prompt params (reference :105-147).

    ARTIFACT_FORMAT="torch" writes the reference's layout instead: a pickled
    list of torch tensors, the textual prefix batched to (1, L, W) as the
    reference's TextPrefixModel holds it (clip_encoders.py:55-67); a visual
    prefix stays (L, W), as the JAX package writes it."""
    _refuse_multi(config)
    file_name = _prompt_file_name(config, iteration)
    _ensure_dir(file_name)
    obj = [None if p is None else np.asarray(p) for p in obj]
    if getattr(config, "ARTIFACT_FORMAT", "numpy") == "torch":
        if config.MODALITY == "text":
            obj = [p if p is None or p.ndim != 2 else p[None] for p in obj]
        obj = interop.tensor_list_to_torch(obj)
    with open(file_name, "wb") as f:
        pickle.dump(obj, f)


def load_saved_parameters(config, iteration=None):
    """Load a prompt artifact, ours or reference-produced (torch tensors are
    converted to numpy)."""
    _refuse_multi(config)
    with open(_prompt_file_name(config, iteration), "rb") as f:
        out = pickle.load(f)
    if any(hasattr(p, "detach") for p in out if p is not None):
        out = interop.tensor_list_from_torch(out)
    return out


def save_predictions(obj, config, iteration=None):
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
