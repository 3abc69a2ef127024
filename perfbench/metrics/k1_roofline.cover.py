"""k1_roofline.cover: the least time of the phase-1 neighbour sums (K1) at
the HBM rate, each launch's inputs read once and output written once at
its shape (from the benchmark's span around each scorer call), over
K1's device time in the trace, in percent."""

from perfbench.yardstick.readers import k1_solve_roofline


def read(ctx):
    return k1_solve_roofline(ctx)
