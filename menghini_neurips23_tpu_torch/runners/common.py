"""Shared driver plumbing for the workflows.

Mirrors the reference entry points' arg/env handling (reference
main_SSL.py:430-505) and the MODEL-name dispatch tables (main_SSL.py:203-396,
main_UL.py:168-310, main_TRZSL.py:170-355).  Every MODEL runs: clip_baseline
and the 3 x 4 grid of CoOp / VPT / UPT prompts under prompt-only, FPL, IFPL
and GRIP training.
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import os
import random
from pathlib import Path

import numpy as np

from menghini_neurips23_tpu_torch.config import Config
from menghini_neurips23_tpu_torch.data import DATASET_CUSTOM_PROMPTS
from menghini_neurips23_tpu_torch.evaluation import (
    evaluate_predictions,
    save_parameters,
    save_predictions,
    store_results,
)
from menghini_neurips23_tpu_torch.training import strategy_class
from menghini_neurips23_tpu_torch.utils import setup_logging

log = logging.getLogger(__name__)

# MODEL name -> (modality, training method)
MODEL_DISPATCH = {
    "textual_prompt": ("text", "train"),
    "visual_prompt": ("image", "train"),
    "multimodal_prompt": ("multi", "train"),
    "textual_fpl": ("text", "train_fpl"),
    "visual_fpl": ("image", "train_fpl"),
    "multimodal_fpl": ("multi", "train_fpl"),
    "iterative_textual_fpl": ("text", "fixed_iterative_train"),
    "iterative_visual_fpl": ("image", "fixed_iterative_train"),
    "iterative_multimodal_fpl": ("multi", "fixed_iterative_train"),
    "grip_textual": ("text", "grip_train"),
    "grip_visual": ("image", "grip_train"),
    "grip_multimodal": ("multi", "grip_train"),
}

RUNNABLE_MODELS = ("clip_baseline",) + tuple(MODEL_DISPATCH)


def check_model(model: str) -> None:
    """Accept the MODELs this package runs; raise ValueError for unknown ones."""
    if model in RUNNABLE_MODELS:
        return
    raise ValueError(
        f"Unknown MODEL {model!r}; known: clip_baseline, " + ", ".join(sorted(MODEL_DISPATCH))
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


def build_strategy(cfg: Config, label_to_idx, dict_classes, data_folder,
                   unlabeled_files=None, runtime=None, device=None):
    check_model(cfg.MODEL)
    modality, method = MODEL_DISPATCH[cfg.MODEL]
    cfg.MODALITY = modality
    strategy = strategy_class(modality)(
        cfg,
        label_to_idx,
        dict_classes["classes"],
        dict_classes["seen_classes"],
        dict_classes["unseen_classes"],
        device=device,
        data_folder=data_folder,
        unlabeled_files=unlabeled_files,
        runtime=runtime,
    )
    return strategy, method


def run_strategy(strategy, method, train_ds, val_ds, unlabeled_ds):
    if method == "train":
        return strategy.train(train_ds, val_ds, only_seen=True)
    if method == "train_fpl":
        return strategy.train(train_ds, val_ds, unlabeled_ds, only_seen=False)
    if method == "fixed_iterative_train":
        return strategy.fixed_iterative_train(train_ds, val_ds, unlabeled_ds, only_seen=False)
    if method == "grip_train":
        return strategy.grip_train(train_ds, val_ds, unlabeled_ds, only_seen=False)
    raise ValueError(f"Unknown training method {method}")


def finish_workflow(cfg, model, optimal_prompt, test_dataset, test_files, test_labels,
                    dict_classes):
    """Post-training: save prompts, standard ZSL eval, results JSONL, full
    evaluation pickle (reference main_SSL.py:398-427)."""
    if cfg.MODEL != "clip_baseline":
        save_parameters(optimal_prompt, cfg)
    std_predictions = model.test_predictions(test_dataset, standard_zsl=True)
    std_response = evaluate_predictions(
        cfg,
        std_predictions,
        test_files,
        test_labels,
        dict_classes["unseen_classes"],
        dict_classes["seen_classes"],
    )
    log.info("ZSL accuracy: %s", std_response)
    store_results(cfg, std_response)
    images, predictions, prob_preds = model.evaluation(test_dataset)
    save_predictions(
        {
            "images": images,
            "predictions": predictions,
            "labels": list(test_labels),
            "logits": prob_preds,
        },
        cfg,
        iteration=None,
    )
    return std_response


def paradigm_workflow(dataset_dir, obj_conf, assemble, adjust_classes=None,
                      runtime=None, device=None):
    """One parametrized workflow for SSL/UL/TRZSL (the reference triplicates
    ~400 lines across main_SSL/main_UL/main_TRZSL; only the data-assembly
    policy differs).

    :param assemble: hook (obj_conf, classes, seen, unseen, labeled_data,
        unlabeled_data) -> (seen, unseen, train_files, train_labs, val_files,
        val_labs, pool_files) - the paradigm's labeled/unlabeled composition.
    :param adjust_classes: optional hook (classes, seen, unseen) -> (seen,
        unseen) applied BEFORE pool parsing (SSL treats every class as both
        seen and unseen, reference main_SSL.py:74-75).
    :param device: where the strategy's runtime lives when `runtime` is None
        (None = CUDA).
    """
    from menghini_neurips23_tpu_torch.data import (
        dataset_object,
        get_class_names,
        get_labeled_and_unlabeled_data,
    )

    dataset = obj_conf.DATASET_NAME
    classes, seen_classes, unseen_classes = get_class_names(
        dataset, dataset_dir, obj_conf.SPLIT_SEED
    )
    if adjust_classes is not None:
        seen_classes, unseen_classes = adjust_classes(
            classes, seen_classes, unseen_classes
        )
    data_folder = f"{dataset_dir}/{dataset}"
    labeled_data, unlabeled_data, test_data = get_labeled_and_unlabeled_data(
        dataset, data_folder, seen_classes, unseen_classes, classes
    )
    test_labeled_files, test_labeles = zip(*test_data)
    label_to_idx = {c: idx for idx, c in enumerate(classes)}

    (
        seen_classes, unseen_classes,
        train_files, train_labs, val_files, val_labs, pool_files,
    ) = assemble(obj_conf, classes, seen_classes, unseen_classes,
                 labeled_data, unlabeled_data)
    dict_classes = {
        "classes": classes,
        "seen_classes": seen_classes,
        "unseen_classes": unseen_classes,
    }
    log.info(
        "classes: %d (seen %d / unseen %d); data folder: %s",
        len(classes), len(seen_classes), len(unseen_classes), data_folder,
    )
    log.info("labeled train: %d, val: %d; unlabeled pool: %d",
             len(train_files), len(val_files), len(pool_files))

    DatasetObject = dataset_object(dataset)
    train_seen_dataset = DatasetObject(
        train_files, data_folder, train=True, labels=train_labs, label_map=label_to_idx
    )
    train_unseen_dataset = DatasetObject(
        pool_files, data_folder, train=True, labels=None, label_map=label_to_idx
    )
    truncated_unseen = [f.split("/")[-1] for f in train_unseen_dataset.filepaths]
    val_seen_dataset = DatasetObject(
        val_files, data_folder, train=True, labels=val_labs, label_map=label_to_idx
    )
    test_dataset = DatasetObject(
        test_labeled_files, data_folder, train=False, labels=None, label_map=label_to_idx
    )

    model, method = build_strategy(
        obj_conf, label_to_idx, dict_classes, data_folder,
        unlabeled_files=truncated_unseen, runtime=runtime, device=device,
    )
    val_accuracy, optimal_prompt = run_strategy(
        model, method, train_seen_dataset, val_seen_dataset, train_unseen_dataset
    )
    log.info("best validation accuracy: %s", val_accuracy)
    return finish_workflow(
        obj_conf, model, optimal_prompt, test_dataset,
        test_labeled_files, test_labeles, dict_classes,
    )


TRACE_SUFFIX = ".pt.trace.json"


def profiled(run, profile_dir: str, device):
    """`run()` under torch.profiler (CPU activity, and CUDA activity on a
    CUDA `device`), its trace written under `profile_dir` as
    `rank<r>.<ns>.pt.trace.json` (the JAX package's `PROFILE_DIR`, which
    wraps the workflow in jax.profiler.trace).  When no NEW trace file
    appears - stale ones from earlier runs do not count - a warning says
    so.  Returns what `run` returns."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    from menghini_neurips23_tpu_torch.parallel import process_index

    root = Path(profile_dir)
    root.mkdir(parents=True, exist_ok=True)
    before = set(root.rglob(f"*{TRACE_SUFFIX}"))
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    handler = tensorboard_trace_handler(str(root), worker_name=f"rank{process_index()}")
    with profile(activities=activities, on_trace_ready=handler):
        result = run()
    if not set(root.rglob(f"*{TRACE_SUFFIX}")) - before:
        log.warning("PROFILE_DIR=%s: torch.profiler wrote no trace of the run on %s",
                    profile_dir, device)
    return result


def main_template(workflow, argv=None, env=None, device=None):
    """Parse args, load the config, check it, and run `workflow` on `device`
    (None = CUDA).  Launched as one of several processes (torchrun's
    WORLD_SIZE > 1 in the environment), the process first joins the group
    (parallel.initialize_from_env) and runs on `cuda:LOCAL_RANK`, or on the
    CPU under gloo when `device` is the CPU; the group is left at the end.

    `COMPILE_CACHE_DIR` puts the CUDA kernels' libraries (the port's only
    persistent compile; ops/_cuda.py) under <dir>/kernels, where a later run
    finds and reuses them; CUDA-graph captures cannot be kept and are made
    anew in every process.  `PROFILE_DIR` runs the workflow under
    torch.profiler (`profiled`)."""
    args = parse_args(argv)
    cfg = load_config(args, env=env)
    # validate cheap preconditions BEFORE any logging/device work
    check_model(cfg.MODEL)
    if not Path(cfg.DATASET_DIR).exists():
        raise FileNotFoundError(f"`dataset_dir` does not exist: {cfg.DATASET_DIR}")
    # the process group from the launcher's variables, before any device work
    from menghini_neurips23_tpu_torch.ops import _cuda
    from menghini_neurips23_tpu_torch.parallel import initialize_from_env

    group_device = initialize_from_env(device=device)
    try:
        setup_logging(cfg)
        if group_device is not None:
            import torch.distributed as dist

            log.info("process group: rank %d of %d (%s) on %s", dist.get_rank(),
                     dist.get_world_size(), dist.get_backend(), group_device)
        seed_everything(cfg)
        run_device = device if group_device is None else group_device
        with contextlib.ExitStack() as stack:
            if cfg.COMPILE_CACHE_DIR:
                stack.enter_context(
                    _cuda.build_dir_at(os.path.join(cfg.COMPILE_CACHE_DIR, "kernels")))

            def run():
                return workflow(cfg.DATASET_DIR, cfg, device=run_device)

            if cfg.PROFILE_DIR:
                return profiled(run, cfg.PROFILE_DIR,
                                "cuda" if run_device is None else run_device)
            return run()
    finally:
        if group_device is not None:
            import torch.distributed as dist

            dist.destroy_process_group()
