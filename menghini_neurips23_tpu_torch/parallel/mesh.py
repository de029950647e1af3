"""The data layout of a run: how many ranks split each batch.

The counterpart of the JAX package's parallel/mesh.py, whose `Mesh` spans
every chip with a 'data' axis (batches sharded) and an optional 'model'
axis (tower weights sharded).  This package has the data axis alone: one
rank per device, each taking its block of every batch and all-reducing the
gradient (parallel/multihost.py).  `MESH_SHAPE` keeps its meaning:

- ""     data parallelism over the whole process group (1 without one);
- "N"    the same, and N must be the group's size;
- "d,m"  m = 1 as "d"; m > 1 (tensor parallelism of the tower weights, the
         JAX package's `clip_param_sharding`) is not ported and raises.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from menghini_neurips23_tpu_torch.parallel.multihost import process_count


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks' layout: `data` ranks split every batch."""

    data: int = 1

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data}


def mesh_from_config(cfg) -> Mesh:
    """The layout `MESH_SHAPE` asks for, checked against the process group."""
    world = process_count()
    spec = str(getattr(cfg, "MESH_SHAPE", "") or "").strip()
    if not spec:
        return Mesh(data=world)
    try:
        shape = tuple(int(s) for s in spec.split(","))
    except ValueError:
        raise ValueError(f"MESH_SHAPE {spec!r}: expected 'N' or 'd,m' with integers") from None
    if len(shape) not in (1, 2) or min(shape) < 1:
        raise ValueError(f"MESH_SHAPE {spec!r}: expected 'N' or 'd,m' with positive integers")
    if len(shape) == 2 and shape[1] > 1:
        raise NotImplementedError(
            f"MESH_SHAPE {spec!r} asks for a 'model' axis of {shape[1]}: tensor parallelism "
            "of the tower weights (the JAX package's clip_param_sharding) is not ported yet; "
            "this package splits batches only"
        )
    if shape[0] != world:
        raise ValueError(
            f"MESH_SHAPE {spec!r} asks for {shape[0]} data ranks, but the process group has "
            f"{world} (launch that many processes, or leave MESH_SHAPE empty)"
        )
    return Mesh(data=world)


def data_parallelism(mesh: Mesh = None) -> int:
    """Ranks that split each batch (the group's size without a mesh)."""
    return mesh.data if mesh is not None else process_count()


def pad_to_multiple(arr: np.ndarray, multiple: int, fill=0):
    """Pad axis 0 to a multiple (so shards are equal); returns (padded, n)."""
    n = arr.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return arr, n
    pad = [(0, rem)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad, constant_values=fill), n
