"""k1_roofline.train: the least time of the training window's neighbour
sums (K1 forward and backward, at each graph's shape) at the HBM rate,
over K1's device time in the trace, in percent."""

from perfbench.yardstick.readers import k1_train_roofline


def read(ctx):
    return k1_train_roofline(ctx)
