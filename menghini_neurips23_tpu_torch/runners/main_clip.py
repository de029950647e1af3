"""Zero-shot CLIP eval workflow (reference methods/main_CLIP.py:58-216).

    python -m menghini_neurips23_tpu_torch.runners.main_clip \\
        --model_config clip_config.yml --learning_paradigm ssl

runs on the GPU; `main(..., device="cpu")` runs it on the CPU.
"""

from __future__ import annotations

import logging

from menghini_neurips23_tpu_torch.data import (
    dataset_object,
    get_class_names,
    get_labeled_and_unlabeled_data,
)
from menghini_neurips23_tpu_torch.evaluation import (
    evaluate_predictions,
    save_predictions,
    store_results,
)
from menghini_neurips23_tpu_torch.runners import common
from menghini_neurips23_tpu_torch.runners.clip_baseline import ClipBaseline

log = logging.getLogger(__name__)


def workflow(dataset_dir, obj_conf, runtime=None, device=None):
    dataset = obj_conf.DATASET_NAME
    classes, seen_classes, unseen_classes = get_class_names(
        dataset, dataset_dir, obj_conf.SPLIT_SEED
    )
    dict_classes = {
        "classes": classes,
        "seen_classes": seen_classes,
        "unseen_classes": unseen_classes,
    }
    data_folder = f"{dataset_dir}/{dataset}"
    _, _, test_data = get_labeled_and_unlabeled_data(
        dataset, data_folder, seen_classes, unseen_classes, classes
    )
    test_labeled_files, test_labeles = zip(*test_data)
    label_to_idx = {c: idx for idx, c in enumerate(classes)}

    DatasetObject = dataset_object(dataset)
    test_dataset = DatasetObject(
        test_labeled_files, data_folder, train=False, labels=None, label_map=label_to_idx
    )
    log.info("test data: %d images, %d classes", len(test_dataset), len(classes))

    model = ClipBaseline(
        obj_conf, label_to_idx, device=device, runtime=runtime, **dict_classes
    )
    std_predictions, images, predictions, prob_preds = model.test_predictions(
        test_dataset
    )
    std_response = evaluate_predictions(
        obj_conf,
        std_predictions,
        test_labeled_files,
        test_labeles,
        unseen_classes,
        seen_classes,
    )
    log.info("ZSL accuracy: %s", std_response)
    store_results(obj_conf, std_response)
    save_predictions(
        {
            "images": images,
            "predictions": predictions,
            "labels": list(test_labeles),
            "logits": prob_preds,
        },
        obj_conf,
        iteration=None,
    )
    return std_response


def main(argv=None, env=None, device=None):
    return common.main_template(workflow, argv=argv, env=env, device=device)


if __name__ == "__main__":
    main()
