"""mfu.train: the training step's algorithm operations over the traced call's
wall time, as % of the dtype's dense tensor peak (fp32 against TF32's)."""

from portbench.harness.readers import mfu


def read(trace):
    return mfu(trace)
