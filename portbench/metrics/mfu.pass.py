"""mfu.pass: the pass's algorithm operations (text features, encode, K3) over
the traced pass's wall time, as % of the dtype's dense tensor peak."""

from portbench.harness.readers import mfu


def read(trace):
    return mfu(trace)
