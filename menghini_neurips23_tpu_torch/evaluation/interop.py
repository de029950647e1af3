"""Prompt artifacts in the reference's torch format.

The reference persists a textual or visual prompt as a pickled list of
torch tensors, and a multimodal one as 5 `torch.save` state_dicts plus 3
numpy pickles (reference utils/compute_metrics.py:105-147 and
methods/semi_supervised_learning/multimodal_prompt.py:148-158).  These
helpers convert between those layouts and the ones the strategies produce
(numpy arrays; for the UPT mixer, the JAX package's flax-layout parameter
dicts), in both directions.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from menghini_neurips23_tpu_torch.models.convert import (
    linear_from_flax,
    linear_to_flax,
    transformer_from_flax,
    transformer_to_flax,
)


def to_numpy(x):
    """torch.Tensor / np.ndarray -> np.ndarray (None passes through)."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _owned(arr) -> torch.Tensor:
    """A CPU tensor owning a writable copy of `arr`."""
    return torch.from_numpy(np.array(arr))


def tensor_list_to_torch(params):
    """[np.ndarray, ...] -> the reference's list of CPU torch tensors, each
    owning a writable copy of its data."""
    return [None if p is None else _owned(p) for p in params]


def tensor_list_from_torch(obj):
    """A reference prompt artifact (list/tuple of tensors or arrays, or a
    bare tensor) -> list of np.ndarray."""
    if not isinstance(obj, (list, tuple)):
        obj = [obj]
    return [to_numpy(p) for p in obj]


def mixer_transformer_to_torch_sd(flax_tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The mixer transformer's flax-layout parameters -> the reference's
    `transformer.state_dict()` layout (torch tensors)."""
    return {k: _owned(v) for k, v in transformer_from_flax(flax_tree).items()}


def mixer_transformer_from_torch_sd(sd: Dict[str, Any]) -> Dict[str, Any]:
    """The reference's `transformer.state_dict()` -> the flax layout."""
    return transformer_to_flax({k: to_numpy(v) for k, v in sd.items()})


def linear_to_torch_sd(flax_dense: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """flax Dense {kernel (in, out), bias} -> an nn.Linear state_dict."""
    return {k: _owned(v) for k, v in linear_from_flax(flax_dense).items()}


def linear_from_torch_sd(sd: Dict[str, Any]) -> Dict[str, np.ndarray]:
    return linear_to_flax({k: to_numpy(v) for k, v in sd.items()})


def multi_part_to_torch(idx: int, part):
    """Our multimodal epoch_parameters[idx] -> the reference's saved object:
    a state_dict for the transformer (0) and the four projections (1-4),
    numpy for the coop / deep / vpt embeddings (5-7)."""
    if part is None:
        return None
    if idx == 0:
        return mixer_transformer_to_torch_sd(part)
    if idx in (1, 2, 3, 4):
        return linear_to_torch_sd(part)
    return np.asarray(part)


def multi_part_from_torch(idx: int, obj):
    """The reference's saved object -> our epoch_parameters[idx] layout."""
    if obj is None:
        return None
    if idx == 0:
        return mixer_transformer_from_torch_sd(obj)
    if idx in (1, 2, 3, 4):
        return linear_from_torch_sd(obj)
    return to_numpy(obj)
