"""Prompt artifacts in the reference's torch format (textual and visual
prompts).

The reference persists a trained prompt as a pickled list of torch
tensors (reference utils/compute_metrics.py:105-147).  These helpers convert
between that list and the numpy list the strategies produce, in both
directions.  The multimodal state_dict layouts arrive with the UPT slice.
"""

from __future__ import annotations

import numpy as np
import torch


def to_numpy(x):
    """torch.Tensor / np.ndarray -> np.ndarray (None passes through)."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def tensor_list_to_torch(params):
    """[np.ndarray, ...] -> the reference's list of CPU torch tensors, each
    owning a writable copy of its data."""
    return [None if p is None else torch.from_numpy(np.array(p)) for p in params]


def tensor_list_from_torch(obj):
    """A reference prompt artifact (list/tuple of tensors or arrays, or a
    bare tensor) -> list of np.ndarray."""
    if not isinstance(obj, (list, tuple)):
        obj = [obj]
    return [to_numpy(p) for p in obj]
