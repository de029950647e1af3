"""The pseudolabel leaderboard, frozen: per-class top-K with the cascade.

A plain copy of the reference method's selection (the paper's code,
utils/clip_pseudolabels.py:47-109), kept here so that later changes to the
program cannot move the yardstick.  Each pool row goes, in order, to the
board of its most probable class; a full board takes it only if it beats the
board's last entry (a board is sorted only once it overflows, so while it
fills its last entry is the latest arrival); a row refused there is offered
to every other class by descending probability.  The result is each class's
board in class order.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def top_k(probs: np.ndarray, filepaths: Sequence[str], k: int, class_ids: Sequence[int]
          ) -> Tuple[List[str], List[int]]:
    n, c = probs.shape
    class_ids = list(class_ids)
    boards = {cid: [] for cid in class_ids}
    argmax = probs.argmax(axis=1)
    for i in range(n):
        col = int(argmax[i])
        row = probs[i]
        score, path = float(row[col]), filepaths[i]
        board = boards[class_ids[col]]
        if len(board) < k:
            board.append((score, path))
        elif board[-1][0] < score:
            boards[class_ids[col]] = sorted(board + [(score, path)], reverse=True)[:k]
        else:
            for s, j in sorted([(float(row[j]), j) for j in range(c) if j != col], reverse=True):
                b = boards[class_ids[j]]
                if len(b) < k:
                    b.append((s, path))
                elif b[-1][0] < s:
                    boards[class_ids[j]] = sorted(b + [(s, path)], reverse=True)[:k]
    paths: List[str] = []
    labels: List[int] = []
    for cid, board in boards.items():
        paths += [p for _, p in board]
        labels += [cid] * len(board)
    return paths, labels
