"""peel_s: the program's phase-1 timer ``t_peel_s`` (host clock),
mean per solve."""

from perfbench.yardstick.readers import phase1_mean


def read(ctx):
    return phase1_mean(ctx, "t_peel_s")
