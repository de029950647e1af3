from menghini_neurips23_tpu_torch.evaluation.metrics import evaluate_predictions  # noqa: F401
from menghini_neurips23_tpu_torch.evaluation.persist import (  # noqa: F401
    save_predictions,
    store_results,
)
