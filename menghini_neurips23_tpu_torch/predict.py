"""Offline inference / serving CLI: zero-shot classification of images.

The reference has NO standalone inference path - predictions only exist as a
side effect of a training run (methods/main_SSL.py:398-427).  This module
classifies arbitrary images in one batched pass on the GPU:

    python -m menghini_neurips23_tpu_torch.predict \\
        --model_config clip_config.yml --learning_paradigm ssl \\
        --images /path/to/imgs_or_dir [--output predictions.json] [--top_k 5]

MODEL/DATASET_NAME/DATASET_DIR/VIS_ENCODER/OPTIM_SEED/SPLIT_SEED come from
the same env protocol as the training CLI; class names resolve through
`get_class_names` exactly as in training.  MODEL=clip_baseline classifies
zero-shot (no artifact needed); any trained MODEL loads its saved prompt
from ARTIFACT_DIR (`--iteration n` an IFPL/GRIP iteration's) and classifies
with it.
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path
from typing import List

import numpy as np

log = logging.getLogger(__name__)

IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".gif", ".webp", ".tif", ".tiff"}


def collect_images(spec: str) -> List[str]:
    """A directory (recursive), a single image, or a .txt list of paths."""
    p = Path(spec)
    if p.is_dir():
        files = sorted(
            str(f) for f in p.rglob("*") if f.suffix.lower() in IMAGE_EXTS
        )
        if not files:
            raise FileNotFoundError(f"no images under {spec!r}")
        return files
    if p.is_file():
        if p.suffix.lower() == ".txt":
            files = [l.strip() for l in p.read_text().splitlines() if l.strip()]
            if not files:
                raise FileNotFoundError(f"image list {spec!r} is empty")
            return files
        return [str(p)]
    raise FileNotFoundError(f"--images target does not exist: {spec!r}")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Classify images, zero-shot or with trained prompts")
    ap.add_argument("--model_config", type=str, default="model_config.yml")
    ap.add_argument("--learning_paradigm", type=str, default="ssl")
    ap.add_argument("--images", type=str, required=True,
                    help="image file, directory, or .txt list of paths")
    ap.add_argument("--iteration", type=int, default=None,
                    help="IFPL/GRIP iteration artifact to load (default: final)")
    ap.add_argument("--output", type=str, default="",
                    help="write predictions JSON here (default: stdout)")
    ap.add_argument("--top_k", type=int, default=1)
    return ap.parse_args(argv)


def main(argv=None, env=None, device=None):
    """Classify the images; returns the list of prediction dicts.  Runs on
    `device` (None = CUDA)."""
    from menghini_neurips23_tpu_torch.data import get_class_names
    from menghini_neurips23_tpu_torch.runners import common
    from menghini_neurips23_tpu_torch.runners.clip_baseline import ClipBaseline
    from menghini_neurips23_tpu_torch.utils import setup_logging

    args = parse_args(argv)
    ns = argparse.Namespace(
        model_config=args.model_config, learning_paradigm=args.learning_paradigm
    )
    cfg = common.load_config(ns, env=env)
    common.check_model(cfg.MODEL)
    setup_logging(cfg)
    files = collect_images(args.images)

    classes, seen, unseen = get_class_names(
        cfg.DATASET_NAME, cfg.DATASET_DIR, cfg.SPLIT_SEED
    )
    label_to_idx = {c: i for i, c in enumerate(classes)}
    log.info("classifying %d images over %d classes", len(files), len(classes))

    if cfg.MODEL == "clip_baseline":
        model = ClipBaseline(cfg, label_to_idx, classes, seen, unseen, device=device)

        class _D:  # minimal dataset shim for test_predictions
            filepaths = files
            transform = None

        _, _, _, logits = model.test_predictions(_D())
    else:
        dict_classes = {"classes": classes, "seen_classes": seen, "unseen_classes": unseen}
        strategy, _ = common.build_strategy(cfg, label_to_idx, dict_classes, data_folder=None,
                                            device=device)
        strategy.load_model_eval(iteration=args.iteration)
        logits = strategy._predict_logits(files, classes)

    probs = np.exp(logits - logits.max(1, keepdims=True))
    probs = probs / probs.sum(1, keepdims=True)
    k = max(1, min(args.top_k, len(classes)))
    order = np.argsort(-probs, axis=1)[:, :k]
    out = [
        {
            "image": f,
            "class": classes[int(order[i, 0])],
            "confidence": float(probs[i, order[i, 0]]),
            "top_k": [
                {"class": classes[int(j)], "confidence": float(probs[i, j])}
                for j in order[i]
            ],
        }
        for i, f in enumerate(files)
    ]
    payload = json.dumps(
        {"model": cfg.MODEL, "encoder": cfg.VIS_ENCODER, "predictions": out},
        indent=1,
    )
    if args.output:
        Path(args.output).write_text(payload + "\n")
        log.info("wrote %d predictions to %s", len(out), args.output)
    else:
        print(payload)
    return out


if __name__ == "__main__":
    main()
