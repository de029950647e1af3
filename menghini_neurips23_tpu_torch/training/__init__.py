"""Training strategies.  This slice holds the zero-shot part of the base
class; the modality strategies (CoOp, VPT, UPT) arrive with the training
slices."""

from menghini_neurips23_tpu_torch.training.strategy import TrainingStrategy  # noqa: F401
