"""Tensor parallelism of the CLIP towers over a model group.

The counterpart of the JAX package's `clip_param_sharding`
(menghini_neurips23_tpu/parallel/mesh.py), which shards the fused qkv
kernel and `c_fc` on columns and `out_proj` and `c_proj` on rows across
the 'model' axis and leaves the all-reduces to XLA.  Here the split is
written out, Megatron style, and follows heads: the hand-written attention
kernels take whole heads, and the JAX package's contiguous columns of the
(W, 3W) kernel are not aligned to heads across q, k and v.  Model rank i of
m holds, of every tower block:

- heads [i*H/m, (i+1)*H/m) of each of q, k and v: those rows of the torch
  layout's `in_proj_weight` (3W, W) and `in_proj_bias`, and the matching
  W/m input columns of `out_proj.weight`;
- rows [i*4W/m, (i+1)*4W/m) of `c_fc` (weight and bias) and the matching
  columns of `c_proj.weight`;
- `out_proj.bias` and `c_proj.bias` whole: they are added once, after the
  sum.

Everything else (embeddings, LayerNorms, projections, the UPT mixer) is
replicated, and so are the activations between the blocks: `copy` (before
`in_proj` and `c_fc`) all-reduces the gradient in the backward, `reduce`
(after `out_proj` and `c_proj`, before the bias) all-reduces the partial
products in the forward.  The sums run in fp32 and are rounded once to the
compute type, after the bias.  The results equal one process's up to the
order of the sums (and, in bf16, the rounding of each shard's partial
product).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Mapping, Optional

import torch

from menghini_neurips23_tpu_torch.parallel import multihost


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """This rank's place on the model axis: `rank` of `size`, over
    `group`, a torch.distributed group.  Without one (None) a sharded
    module's `partial` methods run, and its forward raises."""

    size: int = 1
    rank: int = 0
    group: Optional[object] = None


def from_layout() -> Optional[TensorParallel]:
    """This rank's model axis under the current layout (None at size 1)."""
    m = multihost.model_count()
    if m == 1:
        return None
    return TensorParallel(m, multihost.model_index(), multihost.model_group())


_BLOCK = re.compile(r"^(visual|text)\.transformer\.resblocks\.\d+\.")


def shard_state_dict(sd: Mapping[str, torch.Tensor], size: int,
                     rank: int) -> Dict[str, torch.Tensor]:
    """Model rank `rank` of `size`'s shard of a full CLIP state dict (this
    package's names: `convert_state_dict`, `from_jax_params` or
    `init_clip_params`).  Keys outside the towers' blocks are kept whole.
    Size 1 returns a copy of `sd`."""
    if size == 1:
        return dict(sd)
    out = {}
    for key, v in sd.items():
        m = _BLOCK.match(key)
        suffix = key[m.end():] if m else None
        if suffix in ("attn.in_proj_weight", "attn.in_proj_bias"):
            w = v.shape[0] // 3
            if w % size:
                raise ValueError(f"{key}: width {w} does not split into {size} shards")
            s = w // size
            v = torch.cat([v[j * w + rank * s: j * w + (rank + 1) * s] for j in range(3)])
        elif suffix in ("mlp.c_fc.weight", "mlp.c_fc.bias"):
            s = v.shape[0] // size
            v = v[rank * s: (rank + 1) * s]
        elif suffix in ("attn.out_proj.weight", "mlp.c_proj.weight"):
            s = v.shape[1] // size
            v = v[:, rank * s: (rank + 1) * s].contiguous()
        out[key] = v
    return out


def model_all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """Sum `x` over the model group, in place.  Each call counts in
    `model_all_reduce_.calls`, forward and backward alike (and in
    `multihost.all_reduce_sum_.calls`, which counts every all-reduce)."""
    if group is None:
        raise ValueError("a model axis of more than one rank needs its process group")
    multihost.all_reduce_sum_(x, group)
    model_all_reduce_.calls += 1
    return x


model_all_reduce_.calls = 0


class _Copy(torch.autograd.Function):
    """Identity forward; the gradient summed over the model group, in fp32."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        total = model_all_reduce_(g.to(torch.float32, copy=True).contiguous(), ctx.group)
        return total.to(g.dtype), None


class _Reduce(torch.autograd.Function):
    """The partial products summed over the model group, in fp32 (the
    output is fp32); identity backward."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.dtype = x.dtype
        return model_all_reduce_(x.to(torch.float32, copy=True).contiguous(), group)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g.to(ctx.dtype), None


def copy(x: torch.Tensor, tp: Optional[TensorParallel]) -> torch.Tensor:
    """Enter a column-parallel matmul: `x` itself at size 1."""
    if tp is None or tp.size == 1:
        return x
    return _Copy.apply(x, tp.group)


def reduce(x: torch.Tensor, tp: Optional[TensorParallel]) -> torch.Tensor:
    """Leave a row-parallel matmul: every rank's partial `x` summed, fp32."""
    if tp is None or tp.size == 1:
        return x
    return _Reduce.apply(x, tp.group)
