"""The layout of a run: how many ranks split each batch, and how many share
out the tower weights.

The counterpart of the JAX package's parallel/mesh.py, whose `Mesh` spans
every chip with a 'data' axis (batches sharded) and an optional 'model'
axis (tower weights sharded, `clip_param_sharding`).  Here a rank is one
process on one device: the d*m ranks of a "d,m" layout are laid out model
innermost (parallel/multihost.py `set_layout`), each model group holds
one shard each of every tower block (parallel/tensor.py) and each data
group splits the batches.  `MESH_SHAPE` keeps its meaning:

- ""     data parallelism over the whole process group (1 without one);
- "N"    the same, and N must be the group's size;
- "d,m"  d data x m model ranks, d*m the group's size; m must divide both
         towers' head counts (`check_model_axis`), since the port's shards
         follow heads.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from menghini_neurips23_tpu_torch.parallel import multihost


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks' layout: `data` ranks split every batch, `model` ranks
    share out the tower weights."""

    data: int = 1
    model: int = 1

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}


def mesh_from_config(cfg) -> Mesh:
    """The layout `MESH_SHAPE` asks for, checked against the process group,
    with the group's subgroups formed for it (every rank must call this)."""
    world = multihost.process_count()
    spec = str(getattr(cfg, "MESH_SHAPE", "") or "").strip()
    if not spec:
        mesh = Mesh(data=world)
    else:
        try:
            shape = tuple(int(s) for s in spec.split(","))
        except ValueError:
            raise ValueError(f"MESH_SHAPE {spec!r}: expected 'N' or 'd,m' with integers") from None
        if len(shape) not in (1, 2) or min(shape) < 1:
            raise ValueError(f"MESH_SHAPE {spec!r}: expected 'N' or 'd,m' with positive integers")
        mesh = Mesh(*shape)
        if mesh.model == 1 and mesh.data != world:
            raise ValueError(
                f"MESH_SHAPE {spec!r} asks for {mesh.data} data ranks, but the process group has "
                f"{world} (launch that many processes, or leave MESH_SHAPE empty)"
            )
        if mesh.data * mesh.model != world:
            raise ValueError(
                f"MESH_SHAPE {spec!r} asks for {mesh.data * mesh.model} ranks ({mesh.data} data x "
                f"{mesh.model} model), but the process group has {world}"
            )
    multihost.set_layout(mesh.data, mesh.model)
    return mesh


def check_model_axis(model: int, arch) -> None:
    """Refuse a 'model' axis that does not divide both towers' heads: each
    model rank runs whole heads (parallel/tensor.py), so m must divide the
    vision and the text head counts alike."""
    if model > 1 and (arch.vision_heads % model or arch.transformer_heads % model):
        raise ValueError(
            f"MESH_SHAPE's model axis of {model} must divide both towers' head counts, but "
            f"{arch.name} has {arch.vision_heads} vision heads and {arch.transformer_heads} "
            "text heads"
        )


def data_parallelism(mesh: Mesh = None) -> int:
    """Ranks that split each batch (the group's size without a mesh)."""
    return mesh.data if mesh is not None else multihost.process_count()


def model_parallelism(mesh: Mesh = None) -> int:
    """Ranks that share out the tower weights (1 without a mesh)."""
    return mesh.model if mesh is not None else 1


def pad_to_multiple(arr: np.ndarray, multiple: int, fill=0):
    """Pad axis 0 to a multiple (so shards are equal); returns (padded, n)."""
    n = arr.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return arr, n
    pad = [(0, rem)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad, constant_values=fill), n
