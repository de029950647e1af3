"""SSL workflow (reference methods/main_SSL.py:66-427).

All classes are both seen and unseen; N_LABEL few-shots per class form the
labeled set, the rest of the labeled pool becomes the "unlabeled" set; 80/20
train/val split on the few shots.

    python -m menghini_neurips23_tpu_torch.runners.main_ssl \\
        --model_config textual_fpl_config.yml --learning_paradigm ssl

runs on the GPU; `main(..., device="cpu")` runs it on the CPU.
"""

from __future__ import annotations

import logging

from menghini_neurips23_tpu_torch.data import sample_few_shots, train_val_split
from menghini_neurips23_tpu_torch.runners import common

log = logging.getLogger(__name__)


def _assemble(obj_conf, classes, seen_classes, unseen_classes,
              labeled_data, unlabeled_data):
    # SSL: no seen/unseen distinction (reference main_SSL.py:74-75)
    labeled_files, labeles = zip(*labeled_data)
    # Few-shot sampling (reference main_SSL.py:100-116)
    few_shots_files, few_shots_labs = sample_few_shots(
        labeled_files, labeles, classes, obj_conf.N_LABEL, obj_conf.validation_seed
    )
    # Remaining labeled pool becomes the unlabeled set (reference :119-124)
    few_set = set(few_shots_files)
    pool_files = [f for f in labeled_files if f not in few_set]
    log.info("shots: %d; unlabeled pool: %d", len(few_shots_labs), len(pool_files))
    train_files, train_labs, val_files, val_labs = train_val_split(
        few_shots_files, few_shots_labs, obj_conf.ratio_train_val, obj_conf.validation_seed
    )
    return classes, classes, train_files, train_labs, val_files, val_labs, pool_files


def workflow(dataset_dir, obj_conf, runtime=None, device=None):
    return common.paradigm_workflow(
        dataset_dir, obj_conf, _assemble,
        adjust_classes=lambda classes, seen, unseen: (classes, classes),
        runtime=runtime, device=device,
    )


def main(argv=None, env=None, device=None):
    return common.main_template(workflow, argv=argv, env=env, device=device)


if __name__ == "__main__":
    main()
