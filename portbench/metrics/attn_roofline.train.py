"""attn_roofline.train: K1 and K2 in the training call, the sum of each
launch's roofline bound over their device time, in %."""

from portbench.harness.readers import attention_roofline


def read(trace):
    return attention_roofline(trace)
