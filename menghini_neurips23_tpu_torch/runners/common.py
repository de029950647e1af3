"""Shared driver plumbing for the workflows.

Mirrors the reference entry points' arg/env handling (reference
main_SSL.py:430-505).  This slice runs MODEL=clip_baseline; the prompt
training MODELs are known names that raise until their slice lands.
"""

from __future__ import annotations

import argparse
import logging
import random
from pathlib import Path

import numpy as np

from menghini_neurips23_tpu_torch.config import Config
from menghini_neurips23_tpu_torch.data import DATASET_CUSTOM_PROMPTS
from menghini_neurips23_tpu_torch.utils import setup_logging

log = logging.getLogger(__name__)

# MODEL names of the prompt-training workflows (reference main_SSL.py:203-396,
# main_UL.py:168-310, main_TRZSL.py:170-355)
TRAINING_MODELS = (
    "textual_prompt", "visual_prompt", "multimodal_prompt",
    "textual_fpl", "visual_fpl", "multimodal_fpl",
    "iterative_textual_fpl", "iterative_visual_fpl", "iterative_multimodal_fpl",
    "grip_textual", "grip_visual", "grip_multimodal",
)


def check_model(model: str) -> None:
    """Accept MODEL=clip_baseline; raise for everything else."""
    if model == "clip_baseline":
        return
    if model in TRAINING_MODELS:
        raise NotImplementedError(
            f"MODEL={model!r} trains prompts, which this package cannot do yet: the "
            "CoOp training slice (ROADMAP M6, with the attention backward kernel) "
            "brings it.  MODEL=clip_baseline runs now."
        )
    raise ValueError(
        f"Unknown MODEL {model!r}; known: clip_baseline, " + ", ".join(sorted(TRAINING_MODELS))
    )


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Run CLIP prompt-tuning task")
    parser.add_argument(
        "--model_config", type=str, default="model_config.yml",
        help="Name of model config file (under methods_config/ or an absolute path)",
    )
    parser.add_argument(
        "--learning_paradigm", type=str, default="trzsl",
        help="Choose among trzsl, ssl, and ul",
    )
    return parser.parse_args(argv)


def load_config(args, env=None) -> Config:
    path = args.model_config
    if not Path(path).exists():
        path = f"methods_config/{args.model_config}"
    if not Path(path).exists():
        # fall back to this repo's bundled configs
        path = str(Path(__file__).resolve().parents[2] / "configs" / args.model_config)
    cfg = Config.from_yaml(path, env=env, LEARNING_PARADIGM=args.learning_paradigm)
    cfg.PROMPT_TEMPLATE = DATASET_CUSTOM_PROMPTS.get(
        cfg.DATASET_NAME, "a photo of a {}"
    )
    return cfg


def seed_everything(cfg: Config):
    """Host RNG seeding (reference main_SSL.py:491-503)."""
    np.random.seed(cfg.OPTIM_SEED)
    random.seed(cfg.OPTIM_SEED)


def main_template(workflow, argv=None, env=None, device=None):
    """Parse args, load the config, check it, and run `workflow` on `device`
    (None = CUDA)."""
    args = parse_args(argv)
    cfg = load_config(args, env=env)
    # validate cheap preconditions BEFORE any logging/device work
    check_model(cfg.MODEL)
    if not Path(cfg.DATASET_DIR).exists():
        raise FileNotFoundError(f"`dataset_dir` does not exist: {cfg.DATASET_DIR}")
    for key in ("COMPILE_CACHE_DIR", "PROFILE_DIR"):
        if getattr(cfg, key):
            raise NotImplementedError(
                f"{key} is set, but this package has no counterpart for it yet "
                "(there is no compile cache to keep, and the profiler hook arrives "
                "with the tracing work); unset it"
            )
    setup_logging(cfg)
    seed_everything(cfg)
    return workflow(cfg.DATASET_DIR, cfg, device=device)
