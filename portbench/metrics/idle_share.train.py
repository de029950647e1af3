"""idle_share.train: % of the traced training call in which no device
operation ran (1 - union of device intervals / window)."""

from portbench.harness.readers import idle_share


def read(trace):
    return idle_share(trace)
