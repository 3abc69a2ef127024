"""k4_roofline: the least time of the region batches (K4) at the HBM rate,
each batch's adj and w read once and its costs and sets written once,
over K4's device time in the trace, in percent."""

from perfbench.yardstick.readers import k4_roofline


def read(ctx):
    return k4_roofline(ctx)
