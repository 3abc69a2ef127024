"""train_mfu: the FLOPs of every completed pass's forwards and
backwards (training graphs: the linears three times the forward's and the
neighbour sums both ways; evaluation: one forward per graph) over the
window's seconds at the float32 peak, in percent."""

from perfbench.yardstick.readers import train_mfu


def read(ctx):
    return train_mfu(ctx)
