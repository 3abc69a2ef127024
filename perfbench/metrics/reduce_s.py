"""reduce_s: the program's phase-1 timer ``t_reduce0_s`` (host clock),
mean per solve."""

from perfbench.yardstick.readers import phase1_mean


def read(ctx):
    return phase1_mean(ctx, "t_reduce0_s")
