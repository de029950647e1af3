"""The plain reference's training call.

Training follows the paper's prompt tuning: logits = exp(logit_scale) *
normalize(image features) @ normalize(text features)^T; the loss is the
two-group cross-entropy w0 * mean CE(group 0) + w1 * mean CE(group 1) over a
batch's rows; the update is torch.optim.SGD's with weight decay and no
momentum, p <- p - lr * (grad + wd * p).  Gradients come from autograd.

A call runs every epoch's batches at that epoch's learning rate; after each
epoch it may take the validation logits at the epoch's prompt.

`fault="half"` puts a fault the correctness check has to catch in the
reference's place: the second half of every batch left out, the mean taken
over the rest.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

from portbench.reference import clip


def two_group_loss(logits, labels, groups, w0: float, w1: float):
    """w0 * mean CE(group 0) + w1 * mean CE(group 1)."""
    ce = F.cross_entropy(logits, labels, reduction="none")
    loss = logits.new_zeros(())
    for g, w in ((0, w0), (1, w1)):
        m = groups == g
        n = int(m.sum())
        if w and n:
            loss = loss + w * ce[m].sum() / n
    return loss


def train_call(logits_fn: Callable, make_batch: Callable, p0: torch.Tensor,
               epochs: List[List], lrs: List[float], wd: float, w0: float, w1: float,
               first: int, val_fn: Optional[Callable] = None, fault: str = "") -> List[Dict]:
    """One call from `p0`: epoch e runs the batches `make_batch(b)` for b in
    `epochs[e]` at lr `lrs[e]`.  For each epoch: its start and end prompts,
    its first `first` steps' losses, its first step's gradient, its prompt
    after step `first`, and (with `val_fn`) the validation logits at its end."""
    p = p0.clone()
    out = []
    for batches, lr in zip(epochs, lrs):
        rec = {"start": p.clone(), "losses": []}
        for j, rows in enumerate(batches):
            b = make_batch(rows)
            keep = slice(0, len(b["labels"]) // 2) if fault == "half" else slice(None)
            q = p.clone().requires_grad_(True)
            loss = two_group_loss(logits_fn(q, b, keep), b["labels"][keep], b["groups"][keep],
                                  w0, w1)
            (g,) = torch.autograd.grad(loss, q)
            with torch.no_grad():
                p = p - lr * (g + wd * p)
            if j < first:
                rec["losses"].append(float(loss.detach()))
            if j == 0:
                rec["grad1"] = g.detach().clone()
            if j == first - 1:
                rec["p_first"] = p.clone()
        rec["end"] = p.clone()
        if val_fn is not None:
            with torch.no_grad():
                rec["val_logits"] = val_fn(p)
        out.append(rec)
    return out


def coop_logits_fn(sd, cfg, ids, scale):
    """CoOp: the prompted text tower over every class, image features fixed."""
    def fn(prefix, batch, rows):
        tf = clip.normalize(clip.text_features(sd, cfg, ids, prefix))
        return scale * batch["feats"][rows] @ tf.T
    return fn


def vpt_logits_fn(sd, cfg, text_feats, scale):
    """VPT: the prompted image tower over the batch, text features fixed."""
    def fn(prefix, batch, rows):
        img = clip.normalize(clip.image_features(sd, cfg, batch["tokens"][rows], prefix))
        return scale * img @ text_feats.T
    return fn
