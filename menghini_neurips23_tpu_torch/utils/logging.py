"""Rank-0 logging (reference main_SSL.py:49-61 AccelerateHandler + per-run
FileHandler, :475-481).  The process rank replaces
accelerator.is_local_main_process: in a process group (parallel/) only rank
0's records reach the console and the run's log file.

The rank is a module global that `set_process_rank` records once it is
known (parallel.initialize_distributed sets it before the group forms).
Before that the launcher's variables decide: torchrun's RANK, counted only
beside a sign of a multi-process launch (WORLD_SIZE > 1, LOCAL_RANK, or a
SLURM / Open MPI task count above 1), so a stale RANK=1 left by an unrelated
wrapper does not mute a one-process run.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional

_RANK: Optional[int] = None


def set_process_rank(rank: Optional[int]) -> None:
    """Record this process's rank (None: decide from the launcher's
    variables again)."""
    global _RANK
    _RANK = None if rank is None else int(rank)


def _int_env(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def is_main_process() -> bool:
    if _RANK is not None:
        return _RANK == 0
    multi = (_int_env("WORLD_SIZE", 1) > 1 or os.environ.get("LOCAL_RANK", "") != ""
             or any(_int_env(v, 1) > 1 for v in ("SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE")))
    return not multi or _int_env("RANK", 0) == 0


class MainProcessHandler(logging.StreamHandler):
    """A stream handler that emits on rank 0 only."""

    def emit(self, record):
        if is_main_process():
            super().emit(record)


class MainProcessFileHandler(logging.FileHandler):
    """The run's log file, written by rank 0 only (the ranks share it)."""

    def emit(self, record):
        if is_main_process():
            super().emit(record)


def setup_logging(config=None, log_dir: str = "logs") -> None:
    root = logging.getLogger()
    root.setLevel(logging.INFO)
    formatter = logging.Formatter(
        "%(asctime)s - %(levelname)s - %(name)s - %(message)s"
    )
    handler = MainProcessHandler(sys.stdout)
    handler.setLevel(logging.INFO)
    handler.setFormatter(formatter)
    root.addHandler(handler)
    if config is not None and getattr(config, "DATASET_NAME", ""):
        os.makedirs(log_dir, exist_ok=True)
        log_file = (
            f"{log_dir}/{config.DATASET_NAME}_{config.MODEL}_"
            f"{config.VIS_ENCODER.replace('/', '-')}.log"
        )
        fh = MainProcessFileHandler(log_file, delay=True)
        fh.setFormatter(formatter)
        root.addHandler(fh)
