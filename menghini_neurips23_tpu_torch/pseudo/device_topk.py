"""Segmented per-class top-K pseudolabel selection on a device - EXACT
(config PSEUDO_TOPK="device"; the JAX package's pseudo/device_topk.py).

The reference algorithm (pseudo/engine.py `leaderboard_top_k`, reference
utils/clip_pseudolabels.py:47-101) is sequential: a sample that overflows its
argmax class's board cascades to its next-best classes, so results depend on
pool order.  That cascade cannot be expressed as a parallel reduction without
changing semantics, so this path returns BYTE-IDENTICAL output to the exact
host leaderboard:

- When no class receives more than k argmax assignments (the condition the
  exact path also computes), the cascade provably never fires and every board
  holds exactly its argmax-assigned samples in arrival order.  One masked
  `torch.topk` over the (C, N) score matrix, on the device the caller names,
  selects those samples, and the winner indices are re-sorted ascending to
  restore arrival order.
- On board overflow (counts.max() > k), for NaN confidences, or for the
  LABEL_ALL sentinel, whose output is pool-ordered rather than
  class-grouped, it takes the exact host leaderboard, and logs why.
- Below _KERNEL_MIN_CELLS pool cells the host leaderboard's vectorized
  no-overflow path costs milliseconds, less than the copies to and from the
  device, so small pools take it too.

The argmax is taken on the host at the input's full precision; the device
only ranks.  Recomputing it on the device after a float64 -> float32 cast
could move a near-tie row to another class than the overflow gate counted.
"""

from __future__ import annotations

import logging
from typing import List, Sequence, Tuple

import numpy as np
import torch

from menghini_neurips23_tpu_torch.pseudo.engine import LABEL_ALL, leaderboard_top_k

log = logging.getLogger(__name__)

_NEG = -1e30

# below this many pool cells (n * c) the host's vectorized no-overflow path
# is faster than the device round trip; every FRAMED dataset's GRIP pool
# (~16k x <= 102 classes) sits under it
_KERNEL_MIN_CELLS = 5_000_000


def _segmented_topk_scores(
    conf: np.ndarray, pred: np.ndarray, c: int, k: int, device: torch.device
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-sample (conf, argmax class) -> per-class (C, k) winner indices and
    their validity.  In the no-overflow regime every assigned sample is
    selected, so only the assignment matters and fp32 conf is enough."""
    conf_t = torch.from_numpy(np.ascontiguousarray(conf, np.float32)).to(device)
    pred_t = torch.from_numpy(np.ascontiguousarray(pred, np.int64)).to(device)
    classes = torch.arange(c, device=device)
    scores = torch.where(classes[:, None] == pred_t[None, :], conf_t[None, :],
                         torch.full((), _NEG, device=device))  # (C, N)
    vals, idx = torch.topk(scores, k, dim=1)
    return idx.cpu().numpy(), (vals > _NEG / 2).cpu().numpy()


def device_topk(
    probs: np.ndarray,
    filepaths: Sequence[str],
    k: int,
    class_ids: Sequence[int],
    *,
    device,
) -> Tuple[List[str], List[int]]:
    """`leaderboard_top_k`'s signature, return and OUTPUT; the ranking runs
    on `device` (a torch device or its name; the caller's runtime device)."""
    n, c = probs.shape
    k_eff = min(k, n)
    if k == LABEL_ALL or k_eff <= 0 or n * c < _KERNEL_MIN_CELLS:
        return leaderboard_top_k(probs, filepaths, k, class_ids)
    probs_np = np.asarray(probs)
    argmax = probs_np.argmax(axis=1)
    counts = np.bincount(argmax, minlength=c)
    if counts.max() > k_eff:
        log.info(
            "device_topk: class board overflow (max %d > k=%d); using the "
            "exact host leaderboard", int(counts.max()), k_eff,
        )
        return leaderboard_top_k(probs, filepaths, k, class_ids)
    conf = probs_np[np.arange(n), argmax]
    if np.isnan(conf).any():
        # a NaN confidence fails the validity compare on the device and would
        # drop a sample the exact path keeps
        log.info("device_topk: NaN confidences; using the exact host leaderboard")
        return leaderboard_top_k(probs, filepaths, k, class_ids)
    idx, valid = _segmented_topk_scores(conf, argmax, c, k_eff, torch.device(device))
    new_imgs: List[str] = []
    new_labels: List[int] = []
    for ci, cid in enumerate(class_ids):
        # ascending index = arrival order, as the exact no-overflow path keeps it
        sel = np.sort(idx[ci][valid[ci]])
        new_imgs += [filepaths[i] for i in sel]
        new_labels += [cid] * len(sel)
    return new_imgs, new_labels
