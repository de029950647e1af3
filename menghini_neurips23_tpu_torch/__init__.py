"""PyTorch/CUDA port of menghini_neurips23_tpu for one NVIDIA H100.

CLIP prompt tuning with pseudolabels ("Enhancing CLIP with CLIP", NeurIPS
2023), rebuilt on PyTorch beside the JAX package, which stays the reference.
Plain tensor code is PyTorch; each Pallas kernel of the JAX package becomes a
hand-written Hopper kernel (csrc/), built with nvcc on first use and loaded
with ctypes.  Every kernel keeps a plain PyTorch version beside it: a CPU
tensor takes that version, a CUDA tensor launches the kernel or raises.

This slice carries the zero-shot / pseudolabel forward path:
runners.main_clip (zero-shot evaluation), predict (serving),
training.TrainingStrategy's zero-shot probabilities and pseudo.engine (FPL
pseudolabels), through the attention-forward (K1) and CLIP-head (K3)
kernels.  Entry points run on CUDA unless the caller passes device="cpu".
The package imports torch, never jax, and nothing of menghini_neurips23_tpu.
"""

__version__ = "0.1.0"

from menghini_neurips23_tpu_torch.config import Config  # noqa: F401
