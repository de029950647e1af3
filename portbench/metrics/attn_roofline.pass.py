"""attn_roofline.pass: K1 in the pass (text features and the vision encode),
the sum of each launch's roofline bound over its device time, in %."""

from portbench.harness.readers import attention_roofline


def read(trace):
    return attention_roofline(trace)
