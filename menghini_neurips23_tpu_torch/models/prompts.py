"""Prompt helpers shared by the zero-shot path and, later, prompt tuning.

Only `truncate_context` is needed by the zero-shot slice; the CoOp, VPT and
UPT prompt parameterizations arrive with the training slices.
"""

from __future__ import annotations

import numpy as np


def truncate_context(token_ids: np.ndarray, multiple: int = 8) -> np.ndarray:
    """Drop all-padding context positions after the batch's last EOT token.

    EXACT for CLIP's text tower: attention is causal, so no kept position
    attends to a dropped one, and the dropped rows are pure zero-padding the
    reference computes anyway (torch CLIP always runs all 77 positions,
    reference via clip.encode_text).  With a 16-token prefix and short class
    names this cuts the per-step text tower ~3x (T 77 -> ~24).  The kept
    length is rounded up to `multiple`.  Host-side (NumPy).
    """
    ids = np.asarray(token_ids)
    eot = int(ids.argmax(axis=-1).max())
    t_eff = min(ids.shape[1], -(-(eot + 1) // multiple) * multiple)
    return ids[:, :t_eff]
