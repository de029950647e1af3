"""Shared driver plumbing for the workflows.

Mirrors the reference entry points' arg/env handling (reference
main_SSL.py:430-505) and the MODEL-name dispatch tables (main_SSL.py:203-396,
main_UL.py:168-310, main_TRZSL.py:170-355).  This package runs
MODEL=clip_baseline, the CoOp models textual_prompt and textual_fpl and the
VPT models visual_prompt and visual_fpl; the other training MODELs are known
names that raise naming their slice.
"""

from __future__ import annotations

import argparse
import logging
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
from menghini_neurips23_tpu_torch.training import PENDING_MODALITIES, strategy_class
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

# what this package runs; every other MODEL_DISPATCH entry names its slice
RUNNABLE_MODELS = (
    "clip_baseline", "textual_prompt", "textual_fpl", "visual_prompt", "visual_fpl",
)
_PENDING_SLICE = {
    **PENDING_MODALITIES,
    "fixed_iterative_train": "IFPL/GRIP slice (ROADMAP M9)",
    "grip_train": "IFPL/GRIP slice (ROADMAP M9)",
}


def check_model(model: str) -> None:
    """Accept the MODELs this package runs; raise for everything else."""
    if model in RUNNABLE_MODELS:
        return
    if model in MODEL_DISPATCH:
        modality, method = MODEL_DISPATCH[model]
        slice_name = _PENDING_SLICE.get(modality) or _PENDING_SLICE[method]
        raise NotImplementedError(
            f"MODEL={model!r} is not in this package yet: it arrives with the "
            f"{slice_name}.  Runnable now: {', '.join(RUNNABLE_MODELS)}."
        )
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
