"""The numbers `correct` compares, each against its limit.

Training (the program's first call, stage by stage: each epoch's first
steps and its epoch end are taken by the reference from the program's own
prompt at that point, since later steps amplify rounding; the epoch's
batches and learning rate are the reference's own):
- loss_gap: the largest |loss - ref| / |ref| over each epoch's first steps;
- grad_gap: each epoch's first gradient, by the worst leaf: |‖g‖ - ‖g_ref‖|
  over the larger of the leaf's ‖g_ref‖ and the median leaf's (the worst
  epoch);
- change_gap: the prompt's change over each epoch's first steps, by the
  same measure;
- val_rows_off: the most validation rows, over the epochs, by which the
  program's count of correct rows differs from the reference's at the
  program's epoch-end prompt, beyond the rows whose label logit lies within
  the cell's `val_margin` of the row's best other logit (those may flip on
  rounding either way);
- best_gap: ‖best - end‖ / ‖end - p0‖, the best prompt `train()` returns
  against the program's own prompt at the end of the epoch its metrics
  pick (the first maximum); a copy reads 0;
- final_gap (where the cell limits it): the prompt's change over the whole
  call against the reference's whole call from the same prompt.
Leaves whose reference gradient is under a thousandth of the median leaf's
move by round-off alone and are left out of the gradient and change gaps.

A pass (a sample of the pool drawn from the seed, and the whole selection):
- feature_gap: the largest ‖f - f_ref‖ over the sampled rows' normalised
  image features, and text_gap over the classes' normalised text features;
- prob_gap: the largest |p - p_ref| over the sampled rows' probabilities;
- selection_diff: rows where the program's pseudolabels differ from the
  frozen leaderboard's on the program's own probabilities.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def _norm(x) -> float:
    return float(np.linalg.norm(np.asarray(x, np.float64)))


def leaf_gaps(prog: Dict[str, np.ndarray], ref: Dict[str, np.ndarray],
              ref_grad: Dict[str, np.ndarray]) -> float:
    """Worst leaf's |‖prog‖ - ‖ref‖| / max(‖ref leaf‖, median leaf's ‖ref‖),
    over the leaves that the reference's gradient moves."""
    gnorms = {k: _norm(v) for k, v in ref_grad.items()}
    med_g = float(np.median(list(gnorms.values())))
    keep = [k for k in ref if gnorms[k] >= 1e-3 * med_g]
    med = float(np.median([_norm(ref[k]) for k in keep]))
    return max(abs(_norm(prog[k]) - _norm(ref[k])) / max(_norm(ref[k]), med, 1e-30)
               for k in keep)


def val_counts(logits, labels, margin: float) -> Tuple[int, int]:
    """(rows whose argmax is the label, rows within `margin` of flipping):
    logits (N, C), labels (N,)."""
    x = np.asarray(logits, np.float64)
    y = np.asarray(labels)
    own = x[np.arange(len(y)), y]
    other = x.copy()
    other[np.arange(len(y)), y] = -np.inf
    gap = own - other.max(1)
    return int((x.argmax(1) == y).sum()), int((np.abs(gap) < margin).sum())


def training(prog: Dict, ref: Dict) -> Dict[str, float]:
    """prog: {"epochs": [{"start", "losses", "grad1", "p_first", "end",
    "val_correct"}], "best", "final"}, prompts as {leaf: array};
    ref: {"epochs": [{"losses", "grad1", "p_first", "val_correct",
    "val_ambiguous"}] from the program's epoch starts[, "final"]}."""
    loss_gap = grad_gap = change_gap = off = 0.0
    for pe, re in zip(prog["epochs"], ref["epochs"]):
        loss_gap = max([loss_gap] + [abs(a - b) / max(abs(b), 1e-30)
                                     for a, b in zip(pe["losses"], re["losses"])])
        grad_gap = max(grad_gap, leaf_gaps(pe["grad1"], re["grad1"], re["grad1"]))
        change_gap = max(change_gap, leaf_gaps(_sub(pe["p_first"], pe["start"]),
                                               _sub(re["p_first"], pe["start"]), re["grad1"]))
        off = max(off, abs(pe["val_correct"] - re["val_correct"]) - re["val_ambiguous"])
    if len(prog["epochs"]) != len(ref["epochs"]):
        off = float("inf")
    p0 = prog["epochs"][0]["start"]
    end = prog["epochs"][int(np.argmax([e["val_correct"] for e in prog["epochs"]]))]["end"]
    out = {"loss_gap": float(loss_gap), "grad_gap": grad_gap, "change_gap": change_gap,
           "val_rows_off": float(off),
           "best_gap": _tree_norm(_sub(prog["best"], end)) / max(_tree_norm(_sub(end, p0)), 1e-30)}
    if "final" in ref:
        out["final_gap"] = leaf_gaps(_sub(prog["final"], p0), _sub(ref["final"], p0),
                                     ref["epochs"][0]["grad1"])
    return out


def _tree_norm(t: Dict) -> float:
    return float(np.sqrt(sum(_norm(v) ** 2 for v in t.values())))


def _sub(a: Dict, b: Dict) -> Dict:
    return {k: np.asarray(a[k], np.float64) - np.asarray(b[k], np.float64) for k in a}


def pass_gaps(prog: Dict, ref: Dict) -> Dict[str, float]:
    """prog/ref: {"img": (S, E), "txt": (C, E), "probs": (S, C)} on the sampled rows."""
    def rows(a, b):
        return float(np.linalg.norm(np.asarray(a, np.float64) - np.asarray(b, np.float64),
                                    axis=-1).max())
    return {
        "feature_gap": rows(prog["img"], ref["img"]),
        "text_gap": rows(prog["txt"], ref["txt"]),
        "prob_gap": float(np.abs(np.asarray(prog["probs"], np.float64)
                                 - np.asarray(ref["probs"], np.float64)).max()),
    }


def selection_diff(prog: Tuple[List[str], List[int]], ref: Tuple[List[str], List[int]]) -> int:
    """Rows in which two (paths, labels) selections differ (a length
    difference counts every missing row)."""
    (pp, pl), (rp, rl) = prog, ref
    diff = sum(1 for a, b, c, d in zip(pp, pl, rp, rl) if a != c or int(b) != int(d))
    return diff + abs(len(pp) - len(rp))


def judge(readings: Dict[str, float], limits: Dict[str, float]) -> List[Tuple[str, float, float]]:
    """(name, reading, limit) for every limited number; a number with no
    reading (NaN) fails."""
    return [(k, float(readings.get(k, float("nan"))), float(v)) for k, v in limits.items()]


def is_correct(checks) -> bool:
    return all(v == v and v <= lim for _, v, lim in checks)
