"""TRZSL workflow (reference methods/main_TRZSL.py:66-375).

Transductive zero-shot: labeled data covers seen classes (80/20 train/val),
the unlabeled pool covers unseen classes; evaluation reports unseen/seen
accuracy and their harmonic mean.

    python -m menghini_neurips23_tpu_torch.runners.main_trzsl \\
        --model_config visual_fpl_config.yml --learning_paradigm trzsl

runs on the GPU; `main(..., device="cpu")` runs it on the CPU.
"""

from __future__ import annotations

import logging

from menghini_neurips23_tpu_torch.data import train_val_split
from menghini_neurips23_tpu_torch.runners import common

log = logging.getLogger(__name__)


def _assemble(obj_conf, classes, seen_classes, unseen_classes,
              labeled_data, unlabeled_data):
    labeled_files, labeles = zip(*labeled_data)
    pool_files = [f for f, _ in unlabeled_data]
    train_files, train_labs, val_files, val_labs = train_val_split(
        labeled_files, labeles, obj_conf.ratio_train_val, obj_conf.validation_seed
    )
    return (seen_classes, unseen_classes,
            train_files, train_labs, val_files, val_labs, pool_files)


def workflow(dataset_dir, obj_conf, runtime=None, device=None):
    return common.paradigm_workflow(
        dataset_dir, obj_conf, _assemble, runtime=runtime, device=device
    )


def main(argv=None, env=None, device=None):
    return common.main_template(workflow, argv=argv, env=env, device=device)


if __name__ == "__main__":
    main()
