"""Pseudolabel engine: batched whole-pool inference + exact top-K leaderboard.

Replaces reference utils/clip_pseudolabels.py.  The reference scores the
unlabeled pool ONE IMAGE AT A TIME through full CLIP (reference
utils/clip_pseudolabels.py:31-44 and the per-strategy assign_pseudo_labels
copies, e.g. methods/semi_supervised_learning/textual_fpl.py:214-230).  Here
the pool is scored in one batched inference pass on the device; only
the (N, C) probability matrix comes back to the host.

The per-class top-K "leaderboard with cascade to next-best classes"
(clip_pseudolabels.py:47-101) is then reproduced host-side with EXACTLY the
reference's semantics - including its arrival-order quirk (items appended
while a leaderboard is below K stay unsorted until the first overflow sorts
them, so the `board[-1]` comparison point is the most recent, not the
minimum).  Pseudolabel set parity requires this (SURVEY.md hard part #5).
"""

from __future__ import annotations

import logging
import os
import pickle
from typing import Dict, List, Sequence, Tuple

import numpy as np

log = logging.getLogger(__name__)

# Sentinel meaning "pseudolabel everything" (reference clip_pseudolabels.py:27)
LABEL_ALL = 10000000


def leaderboard_top_k(
    probs: np.ndarray,
    filepaths: Sequence[str],
    k: int,
    class_ids: Sequence[int],
) -> Tuple[List[str], List[int]]:
    """Exact reference leaderboard selection.

    :param probs: (N, C) class probabilities for each pool image, rows aligned
        with `filepaths`, columns aligned with `class_ids` (global label ids)
    :param k: per-class budget; LABEL_ALL labels every image with its argmax
    :returns: (new_filepaths, new_labels) - per-class winners concatenated in
        class order (reference clip_pseudolabels.py:103-109), or argmax labels
        for every image when k == LABEL_ALL.
    """
    n, c = probs.shape
    class_ids = list(class_ids)
    if k == LABEL_ALL:
        preds = probs.argmax(axis=1)
        return list(filepaths), [class_ids[j] for j in preds]
    if k <= 0:
        # degenerate budget (e.g. a GRIP quantile schedule on a tiny pool):
        # select nothing rather than index an empty board (the reference
        # crashes here, clip_pseudolabels.py:78 top_k[-1] on an empty list)
        return [], []

    argmax = probs.argmax(axis=1)

    # Vectorized-exact fast path: when no class receives more than k argmax
    # assignments, no board ever overflows, so the cascade never fires and
    # every board holds exactly its argmax-assigned samples in arrival order.
    counts = np.bincount(argmax, minlength=c)
    if counts.max() <= k:
        new_imgs = []
        new_labels = []
        for j, cid in enumerate(class_ids):
            members = np.flatnonzero(argmax == j)
            new_imgs += [filepaths[i] for i in members]
            new_labels += [cid] * len(members)
        return new_imgs, new_labels

    # Native C++ cascade (identical semantics, ~20-100x) once the pool is big
    # enough to amortize the ctypes marshalling (measured: 4096x10 = 24.7 ms
    # pure Python vs 1.2 ms native, byte-identical output).
    from menghini_neurips23_tpu_torch.data._native import get_leaderboard

    native = get_leaderboard()
    if native is not None and n * c >= 10_000:
        probs32 = np.ascontiguousarray(probs, np.float32)
        idx, cols = native.leaderboard(
            probs32.tobytes(), list(filepaths), n, c, int(k)
        )
        return [filepaths[i] for i in idx], [class_ids[j] for j in cols]

    boards: Dict[int, List[Tuple[float, str]]] = {cid: [] for cid in class_ids}
    for i in range(n):
        pred_col = int(argmax[i])
        pred = class_ids[pred_col]
        path = filepaths[i]
        row = probs[i]
        score = float(row[pred_col])
        board = boards[pred]
        if len(board) < k:
            board.append((score, path))
        elif board[-1][0] < score:
            boards[pred] = sorted(board + [(score, path)], reverse=True)[:k]
        else:
            # Cascade: offer the sample to every other class by descending
            # confidence (reference clip_pseudolabels.py:84-101).
            order = sorted(
                [(float(row[j]), j) for j in range(c) if j != pred_col],
                reverse=True,
            )
            for s, j in order:
                cid = class_ids[j]
                b = boards[cid]
                if len(b) < k:
                    b.append((s, path))
                elif b[-1][0] < s:
                    boards[cid] = sorted(b + [(s, path)], reverse=True)[:k]

    new_imgs: List[str] = []
    new_labels: List[int] = []
    for cid, board in boards.items():
        new_imgs += [t[1] for t in board]
        new_labels += [cid] * len(board)
    return new_imgs, new_labels


def compute_pseudo_labels(
    probs: np.ndarray,
    dataset,
    classnames: Sequence[str],
    label_to_idx: Dict[str, int],
    k: int,
    filename: str | None = None,
    method: str = "exact",
):
    """Apply top-K selection and mutate `dataset` in place (reference
    protocol, clip_pseudolabels.py:111-117); optionally pickle the result.

    :param method: "exact" = the reference's sequential leaderboard cascade.
        "device" (a top-k on the device) arrives with a later slice of this
        package and raises here.
    """
    if method == "device":
        raise NotImplementedError(
            "PSEUDO_TOPK='device' is not in this package yet: the device top-k "
            "(pseudo/device_topk.py) is ported with the tools slice (M13); use "
            "PSEUDO_TOPK='exact'"
        )
    class_ids = [label_to_idx[c] for c in classnames]
    if k <= 0:
        # degenerate budget: select nothing
        new_imgs, new_labels = [], []
    else:
        new_imgs, new_labels = leaderboard_top_k(probs, dataset.filepaths, k, class_ids)
    dataset.filepaths = new_imgs
    dataset.labels = new_labels
    dataset.label_id = True
    if filename:
        os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
        with open(filename, "wb") as f:
            pickle.dump({"filepaths": new_imgs, "labels": new_labels}, f)
    return dataset


def pseudolabel_cache_path(
    artifact_dir: str,
    data_name: str,
    vis_encoder: str,
    learning_paradigm: str,
    model: str,
    k: int,
    split_seed: int,
) -> str:
    """Reference cache filename schema (clip_pseudolabels.py:134)."""
    return (
        f"{artifact_dir}/pseudolabels/{data_name}_{vis_encoder.replace('/', '')}"
        f"_{learning_paradigm}_{model}_{k}_pseudolabels_split_{split_seed}.pickle"
    )


def pseudolabel_top_k(
    config,
    data_name: str,
    k: int,
    dataset,
    classnames: Sequence[str],
    label_to_idx: Dict[str, int],
    probs_fn,
):
    """Cache-or-compute wrapper (reference clip_pseudolabels.py:120-157).

    :param probs_fn: () -> (N, C) probabilities over `dataset.filepaths` x
        `classnames`; only called on cache miss (it is the expensive batched
        device pass).
    """
    filename = pseudolabel_cache_path(
        getattr(config, "ARTIFACT_DIR", "."),
        data_name,
        config.VIS_ENCODER,
        config.LEARNING_PARADIGM,
        config.MODEL,
        k,
        config.SPLIT_SEED,
    )
    if os.path.exists(filename):
        with open(filename, "rb") as f:
            cached = pickle.load(f)
        dataset.filepaths = cached["filepaths"]
        dataset.labels = cached["labels"]
        dataset.label_id = True
        return dataset
    probs = probs_fn()
    method = getattr(config, "PSEUDO_TOPK", "exact")
    return compute_pseudo_labels(
        probs, dataset, classnames, label_to_idx, k, filename, method=method
    )
