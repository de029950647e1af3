"""Training strategies.

The reference exposes per-paradigm classes {Textual,Visual,Multimodal}Prompt
and {Textual,Visual,Multimodal}FPL in three near-identical packages; here one
strategy class per modality covers all paradigms (the paradigm is
config.LEARNING_PARADIGM) and "FPL vs prompt-only" is just whether an
unlabeled dataset is passed to train().  IFPL and GRIP are methods of the
base class (fixed_iterative_train, grip_train), so every modality runs them.
"""

from menghini_neurips23_tpu_torch.training.losses import (  # noqa: F401
    cross_entropy_per_sample,
    masked_mean,
    two_group_loss,
)
from menghini_neurips23_tpu_torch.training.schedulers import lr_factor, lr_for_epoch  # noqa: F401
from menghini_neurips23_tpu_torch.training.multimodal import MultimodalStrategy
from menghini_neurips23_tpu_torch.training.strategy import EpochData, TrainingStrategy  # noqa: F401
from menghini_neurips23_tpu_torch.training.textual import TextualStrategy
from menghini_neurips23_tpu_torch.training.visual import VisualStrategy

# Reference-compatible aliases (reference methods/*/__init__.py)
TextualPrompt = TextualStrategy
TextualFPL = TextualStrategy
VisualPrompt = VisualStrategy
VisualFPL = VisualStrategy

MultimodalPrompt = MultimodalStrategy
MultimodalFPL = MultimodalStrategy

MODALITY_STRATEGIES = {
    "text": TextualStrategy,
    "image": VisualStrategy,
    "multi": MultimodalStrategy,
}


def strategy_class(modality: str):
    """The strategy class for a modality."""
    return MODALITY_STRATEGIES[modality]
