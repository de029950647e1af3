"""Run logging (reference main_SSL.py:49-61 handler + per-run FileHandler,
:475-481).  This package runs one process on one device, so that process is
rank 0 and every record is emitted."""

from __future__ import annotations

import logging
import os
import sys


def setup_logging(config=None, log_dir: str = "logs") -> None:
    root = logging.getLogger()
    root.setLevel(logging.INFO)
    formatter = logging.Formatter(
        "%(asctime)s - %(levelname)s - %(name)s - %(message)s"
    )
    handler = logging.StreamHandler(sys.stdout)
    handler.setLevel(logging.INFO)
    handler.setFormatter(formatter)
    root.addHandler(handler)
    if config is not None and getattr(config, "DATASET_NAME", ""):
        os.makedirs(log_dir, exist_ok=True)
        log_file = (
            f"{log_dir}/{config.DATASET_NAME}_{config.MODEL}_"
            f"{config.VIS_ENCODER.replace('/', '-')}.log"
        )
        fh = logging.FileHandler(log_file)
        fh.setFormatter(formatter)
        root.addHandler(fh)
