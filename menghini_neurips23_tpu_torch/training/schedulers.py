"""Learning-rate schedules, numerically identical to the reference.

The reference steps its torch scheduler once per EPOCH (`update_scheduler()`
at methods/semi_supervised_learning/textual_prompt.py:152), so the schedule is
a pure function of the epoch index; the trainer sets the epoch's lr on the
optimizer's param groups.

Semantics (reference utils/schedulers.py:11-65):
- "cosine":  WarmupCosineSchedule - factor = e/warmup for e < warmup (note
  epoch 0 trains at lr 0, a quirk of torch LambdaLR initialization that is
  reproduced), then 0.5*(1+cos(pi * progress)) with cycles=0.5.
- "one_warmup_epoch": WARMUP_LR at epoch 0, LR afterwards.
- anything else: StepLR(step_size=STEP_SIZE, gamma=0.1).
"""

from __future__ import annotations

import math


def lr_factor(scheduler: str, epoch: int, *, warmup: int, total: int,
              warmup_lr: float = 0.0, base_lr: float = 1.0, step_size: int = 1,
              cycles: float = 0.5) -> float:
    if scheduler == "cosine":
        if epoch < warmup:
            return float(epoch) / float(max(1.0, warmup))
        progress = float(epoch - warmup) / float(max(1, total - warmup))
        return max(0.0, 0.5 * (1.0 + math.cos(math.pi * cycles * 2.0 * progress)))
    if scheduler == "one_warmup_epoch":
        return warmup_lr / base_lr if epoch == 0 else 1.0
    return 0.1 ** (epoch // step_size)


def lr_for_epoch(cfg, epoch: int) -> float:
    """The learning rate used during `epoch` (0-based), matching the
    reference's per-epoch scheduler stepping."""
    return cfg.LR * lr_factor(
        cfg.SCHEDULER,
        epoch,
        warmup=cfg.WARMUP_EPOCHS,
        total=cfg.EPOCHS,
        warmup_lr=cfg.WARMUP_LR,
        base_lr=cfg.LR,
        step_size=cfg.STEP_SIZE,
    )
