"""PyTorch/CUDA port of menghini_neurips23_tpu for one NVIDIA H100.

CLIP prompt tuning with pseudolabels ("Enhancing CLIP with CLIP", NeurIPS
2023), rebuilt on PyTorch beside the JAX package, which stays the reference.
Plain tensor code is PyTorch; each Pallas kernel of the JAX package becomes a
hand-written Hopper kernel (csrc/), built with nvcc on first use and loaded
with ctypes.  Every kernel keeps a plain PyTorch version beside it: a CPU
tensor takes that version, a CUDA tensor launches the kernel or raises.

It runs zero-shot evaluation (runners.main_clip), serving (predict), and
CoOp, VPT and UPT prompt training with FPL, IFPL and GRIP pseudolabels
under SSL, UL and TRZSL (runners.main_ssl, main_ul, main_trzsl), at
ViT-B/32 and ViT-L/14, through the attention forward (K1) and backward (K2)
and CLIP-head (K3) kernels; `doctor` checks a host and `aggregate` averages
results across seeds.
Entry points run on CUDA unless the caller passes device="cpu".
The package imports torch, never jax, and nothing of menghini_neurips23_tpu.
"""

__version__ = "0.1.0"

from menghini_neurips23_tpu_torch.config import Config  # noqa: F401
