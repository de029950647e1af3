"""gemm_ms_per_step.train: device ms of the matrix-product kernels (cuBLAS,
CUTLASS) per training step of the traced call."""

from portbench.harness.readers import is_gemm


def read(trace):
    steps = trace.facts.get("steps")
    ms = trace.seconds(is_gemm) * 1e3
    return ms / steps if steps and ms > 0 else None
