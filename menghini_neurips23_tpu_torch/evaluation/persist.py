"""Result/artifact persistence with the reference's filename schemas
(reference utils/compute_metrics.py:58-171).

This slice writes the zero-shot artifacts: the results JSON line and the
predictions pickle.  Prompt-parameter artifacts arrive with the training
slice.  One process runs on one device, so it is the main process and
writes every artifact.
"""

from __future__ import annotations

import json
import logging
import os
import pickle

log = logging.getLogger(__name__)


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
