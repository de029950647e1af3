"""Two-group masked cross-entropy.

Unifies the reference's three paradigm loss variants into one form.  The
reference decides group membership with Python (path-in-list for SSL/UL FPL,
reference methods/semi_supervised_learning/textual_fpl.py:142-157;
label-in-seen-set for TRZSL, methods/transductive_zsl/textual_fpl.py:124-147)
and computes a separate mean CE per group, then a weighted sum:

    SSL FPL:   balance * CE(labeled) + CE(pseudo),   balance = N_unseen/N_seen
    TRZSL FPL: CE(seen) + balance * CE(unseen),      balance = N_seen/N_unseen
    UL FPL:    CE(all)
    prompt-only (any paradigm): CE(all labeled)

Here membership is *data*: a per-sample group flag (0 or 1) rides with the
batch, so padded fixed-shape batches need no Python branching.  An empty group
contributes 0 (reference behavior when `samples` is empty).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def cross_entropy_per_sample(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """(B, C) logits x (B,) int labels -> (B,) fp32 CE. Labels < 0 yield 0."""
    logits = logits.float()
    top = logits.max(-1, keepdim=True).values
    logz = torch.log(torch.exp(logits - top).sum(-1)) + top[:, 0]
    safe = labels.long().clamp(0, logits.shape[-1] - 1)
    gold = logits.gather(1, safe[:, None])[:, 0]
    ce = logz - gold
    return torch.where(labels >= 0, ce, torch.zeros_like(ce))


def masked_mean(values: torch.Tensor, mask: torch.Tensor,
                count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean over mask; 0 when the mask is empty.  With `count` the sum over
    the mask is divided by it instead of by the mask's own count: a rank's
    share of a mean over a batch that the ranks split."""
    if count is None:
        count = mask.sum()
    mean = (values * mask).sum() / count.clamp(min=1)
    return torch.where(count > 0, mean, torch.zeros_like(mean))


def two_group_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    group: torch.Tensor,
    valid: torch.Tensor,
    w0: float,
    w1: float,
    counts: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """w0 * meanCE(group==0) + w1 * meanCE(group==1), over valid samples.

    :param group: (B,) int - 0 = labeled/seen term, 1 = pseudo/unseen term
    :param valid: (B,) 0/1 float - padding mask
    :param counts: the valid rows of each group in the whole batch, when
        these rows are one rank's block of it: the ranks' losses then sum
        to the whole batch's (their gradients too, by one all-reduce)
    """
    ce = cross_entropy_per_sample(logits, labels)
    m0 = valid * (group == 0)
    m1 = valid * (group == 1)
    n0, n1 = counts if counts is not None else (None, None)
    return w0 * masked_mean(ce, m0, n0) + w1 * masked_mean(ce, m1, n1)
