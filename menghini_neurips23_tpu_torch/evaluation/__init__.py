from menghini_neurips23_tpu_torch.evaluation.metrics import evaluate_predictions  # noqa: F401
from menghini_neurips23_tpu_torch.evaluation.persist import (  # noqa: F401
    load_saved_parameters,
    save_parameters,
    save_predictions,
    save_pseudo_labels,
    store_results,
)
