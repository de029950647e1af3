"""UL workflow (reference methods/main_UL.py:66-310).

Seen/unseen classes come from the split, but ALL labeled data (train + val)
is folded into the unlabeled pool (reference main_UL.py:114-115): training
uses pseudolabels over all classes only; the labeled val split is still used
for validation.

    python -m menghini_neurips23_tpu_torch.runners.main_ul \\
        --model_config visual_fpl_config.yml --learning_paradigm ul

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
    # Fold ALL labeled data into the unlabeled pool (reference main_UL.py:114-115)
    pool_files = pool_files + list(train_files) + list(val_files)
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
