"""idle_share.pass: % of the traced pass in which no device operation ran."""

from portbench.harness.readers import idle_share


def read(trace):
    return idle_share(trace)
