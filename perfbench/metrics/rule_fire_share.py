"""rule_fire_share: the core's worklists' useful share, fires over
evaluations (%) of its seven local rules in the initial reduction and the
peel, summed over the window (the program's ``core_counts`` fires and its
rule spans' calls)."""

from perfbench.yardstick.core_profile import fire_share


def read(ctx):
    return fire_share(ctx)
