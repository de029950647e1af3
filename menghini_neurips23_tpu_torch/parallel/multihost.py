"""Multi-process data and tensor parallelism over `torch.distributed`.

The counterpart of the JAX package's parallel/multihost.py, which replaces
the reference's `accelerate launch` process group (reference
methods_config/accelerate_config.yml: 4 single-node GPU processes) with
`jax.distributed`.  Here the group is torch's own: one process per device,
launched by torchrun (or any launcher that sets its variables), NCCL on the
card and gloo on the CPU.

    torchrun --nproc_per_node=N run_main_ssl.py --model_config ... --learning_paradigm ssl

What the ranks share and split:
- every rank holds the same frozen CLIP, the same prompt and the same host
  data (the numpy permutations and the prompt draw are seeded without the
  rank), so replicated work gives the same bits on every rank;
- each global batch of a frozen-tower pass or a training step is split into
  contiguous, host-major blocks of ceil(B / world) rows
  (`shard_filelist_for_batch`); a pass gathers its rows back with exact
  unpadding (`all_gather_rows`), a step all-reduces its flat gradient
  (`all_reduce_sum_`);
- rank 0 alone writes artifacts, checkpoints and log records.

With a 'model' axis (`MESH_SHAPE "d,m"`, m > 1; parallel/mesh.py) the
world of d*m ranks is laid out model-innermost, rank = data_index * m +
model_index (the order of the JAX package's `create_device_mesh`): the m
ranks of a model group hold one shard each of the tower weights
(parallel/tensor.py) and see the same rows, and the d ranks of a data group
split the batches as above.  `set_layout` forms both kinds of subgroup;
everything above that speaks of "the ranks" then speaks of the data group.

Launcher variables (torchrun's): RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT.  The JAX package reads JAX_PROCESS_ID, JAX_NUM_PROCESSES and
JAX_COORDINATOR_ADDRESS for the same three facts.
"""

from __future__ import annotations

import logging
import os
from typing import List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

log = logging.getLogger(__name__)


def is_initialized() -> bool:
    """Whether this process belongs to a process group."""
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def is_main_process() -> bool:
    """Rank-0 IO guard (replaces accelerator.is_local_main_process)."""
    return process_index() == 0


class _Layout:
    """The (data, model) layout of the current process group and this
    rank's two subgroups.  Bound to the group it was formed in: once that
    group is destroyed the layout no longer applies."""

    def __init__(self, world_group, data: int, model: int, data_group, model_group):
        self.world_group = world_group
        self.data, self.model = data, model
        self.data_group, self.model_group = data_group, model_group


_layout: Optional[_Layout] = None


def _current_layout() -> Optional[_Layout]:
    if _layout is None or not is_initialized() or _layout.world_group is not dist.group.WORLD:
        return None
    return _layout


def set_layout(data: int, model: int) -> None:
    """Lay the group's d*m ranks out as (data, model), model innermost.

    With model 1 the data group is the whole group and no subgroup is
    formed.  Otherwise every rank forms every data group ({i, i+m, ...})
    and every model group ({j*m, ..., j*m+m-1}), in the same order (as
    `dist.new_group` requires), and warms its own two with one all-reduce
    each: NCCL builds a communicator at its first collective, which must
    come before any CUDA-graph capture does.  Forming the same layout again
    in the same group reuses it."""
    global _layout
    if not is_initialized():
        if (data, model) != (1, 1):
            raise ValueError(f"a ({data}, {model}) layout needs a process group")
        return
    world = dist.get_world_size()
    if data * model != world:
        raise ValueError(f"a ({data}, {model}) layout needs {data * model} ranks, not {world}")
    current = _current_layout()
    if current is not None and (current.data, current.model) == (data, model):
        return
    if model == 1:
        _layout = _Layout(dist.group.WORLD, data, 1, None, None)
        return
    rank = dist.get_rank()
    mine = {}
    for i in range(model):
        ranks = list(range(i, world, model))
        g = dist.new_group(ranks)
        if rank in ranks:
            mine["data"] = g
    for j in range(data):
        ranks = list(range(j * model, (j + 1) * model))
        g = dist.new_group(ranks)
        if rank in ranks:
            mine["model"] = g
    _layout = _Layout(dist.group.WORLD, data, model, mine["data"], mine["model"])
    warm_collectives(mine["data"])
    warm_collectives(mine["model"])
    log.info("process group laid out as %d data x %d model ranks: rank %d is data %d, model %d",
             data, model, rank, data_index(), model_index())


def data_group():
    """The group this rank's batch rows are split over: its data subgroup
    under a 'model' axis, the whole group (None) otherwise."""
    layout = _current_layout()
    return None if layout is None else layout.data_group


def model_group():
    """This rank's model subgroup (None without a 'model' axis)."""
    layout = _current_layout()
    return None if layout is None else layout.model_group


def model_count() -> int:
    """Ranks that share out the tower weights (1 without a 'model' axis)."""
    layout = _current_layout()
    return 1 if layout is None else layout.model


def model_index() -> int:
    return process_index() % model_count()


def data_count() -> int:
    """Ranks that split each batch: the group's size over the model axis."""
    return process_count() // model_count()


def data_index() -> int:
    return process_index() // model_count()


def _collective_device() -> torch.device:
    """Where a collective's tensors live: the rank's card under NCCL, the
    CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def initialize_distributed(rank: int, world_size: int, device, init_method: str) -> torch.device:
    """Join the process group as `rank` of `world_size` and return this
    process's device.  A CUDA `device` takes NCCL on that card (the index
    is the launcher's local rank); a CPU one takes gloo.  Right after the
    group forms, one all-reduce runs on every rank: NCCL builds its
    communicator there, before any CUDA graph could capture a collective,
    and gloo its connections, while the ranks are still in step."""
    from menghini_neurips23_tpu_torch.utils.logging import set_process_rank

    device = torch.device(device)
    set_process_rank(rank)  # known now: records logged while joining are filtered
    if device.type == "cuda":
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", init_method=init_method, rank=rank,
                                world_size=world_size, device_id=device)
    elif device.type == "cpu":
        dist.init_process_group("gloo", init_method=init_method, rank=rank,
                                world_size=world_size)
    else:
        raise ValueError(f"no process-group backend for device {device}")
    warm_collectives()
    log.info("distributed initialized: process %d/%d on %s (%s)", rank, world_size, device,
             dist.get_backend())
    return device


def warm_collectives(group=None) -> None:
    """One all-reduce over `group` (None: the whole group), which must give
    the group's size (the JAX package's `_establish_collectives` and
    `warm_axis_collectives`)."""
    x = torch.ones(1, device=_collective_device())
    dist.all_reduce(x, group=group)
    if int(x.item()) != dist.get_world_size(group):
        raise RuntimeError(f"warm-up all-reduce gave {x.item()}, not the group's size")


def initialize_from_env(env: Optional[Mapping[str, str]] = None,
                        device=None) -> Optional[torch.device]:
    """Join the process group that the launcher's variables describe
    (torchrun's RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) and
    return this process's device: `cuda:LOCAL_RANK` for `device` None or a
    CUDA device, the CPU for a CPU one.  WORLD_SIZE unset or 1 forms no
    group and returns None, as JAX_NUM_PROCESSES <= 1 does.  Must run
    before any work on the device."""
    env = os.environ if env is None else env
    world = int(env.get("WORLD_SIZE", "1") or 1)
    if world <= 1:
        return None
    if is_initialized():
        raise RuntimeError("a process group is already initialized in this process")
    rank = int(env["RANK"])
    local = int(env.get("LOCAL_RANK", rank))
    addr = env.get("MASTER_ADDR", "127.0.0.1")
    port = env["MASTER_PORT"]
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available for rank %d; this package runs on the GPU by "
                "default - pass device='cpu' to run the group on the CPU (gloo)" % rank
            )
        dev = torch.device("cuda", local)
    return initialize_distributed(rank, world, dev, f"tcp://{addr}:{port}")


def shard_filelist_for_batch(batch_files: Sequence[str], per_host: int,
                             process_index: Optional[int] = None) -> List[str]:
    """This rank's contiguous slice of ONE global batch's file list.

    The global batch's row blocks are host-major (rank i owns rows
    [i*per_host, (i+1)*per_host)), so the slice is the fixed-size block at
    that offset - not an equalized split of the remainder.  A short final
    batch simply truncates (the last ranks may get fewer rows, or none);
    the caller pads its slice.  `process_index` defaults to this rank's
    index in its data group (the model ranks of a group take one block)."""
    if process_index is None:
        process_index = data_index()
    pi = process_index
    lo = min(pi * per_host, len(batch_files))
    hi = min(lo + per_host, len(batch_files))
    return list(batch_files[lo:hi])


def barrier() -> None:
    """Wait for every rank (nothing outside a group)."""
    if is_initialized():
        dist.barrier()


def broadcast_int(value: int, src: int = 0) -> int:
    """Rank `src`'s `value` on every rank (the value itself outside a group)."""
    if not is_initialized():
        return int(value)
    x = torch.tensor([int(value)], dtype=torch.int64, device=_collective_device())
    dist.broadcast(x, src)
    return int(x.item())


def all_gather_rows(local: np.ndarray, group=None) -> np.ndarray:
    """Every rank's rows of `group` (None: this rank's data group),
    concatenated in rank order, on every rank.

    The ranks may hold different row counts: the counts are gathered first,
    each block is padded to the largest, gathered, and cut back to its own
    count, so no padding row survives (the reference's gather + padding
    truncation, textual_prompt.py:139-149, without its drop_duplicates
    heuristic).  Outside a group the rows come back as they are."""
    local = np.ascontiguousarray(local)
    if not is_initialized():
        return local
    dev = _collective_device()
    group = data_group() if group is None else group
    world = dist.get_world_size(group)
    n = torch.tensor([local.shape[0]], dtype=torch.int64, device=dev)
    counts = [torch.zeros_like(n) for _ in range(world)]
    dist.all_gather(counts, n, group=group)
    counts = [int(c.item()) for c in counts]
    rows = max(counts)
    block = torch.zeros((rows,) + local.shape[1:], dtype=torch.from_numpy(local[:0]).dtype,
                        device=dev)
    block[: local.shape[0]].copy_(torch.from_numpy(local))
    blocks = [torch.empty_like(block) for _ in range(world)]
    dist.all_gather(blocks, block, group=group)
    return np.concatenate([b[:c].cpu().numpy() for b, c in zip(blocks, counts)])


def all_reduce_sum_(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum `x` over the ranks of `group` (None: this rank's data group), in
    place, and return it; a CUDA tensor may be all-reduced inside a CUDA
    graph's capture (NCCL records the collective into the graph).  Outside
    a group `x` is left as it is.  Each call in a group counts in
    `all_reduce_sum_.calls` (a graph replay adds what its capture counted,
    as the kernels' launch counts do)."""
    if is_initialized():
        dist.all_reduce(x, group=data_group() if group is None else group)
        all_reduce_sum_.calls += 1
    return x


all_reduce_sum_.calls = 0
