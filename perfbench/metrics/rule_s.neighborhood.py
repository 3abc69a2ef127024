"""rule_s.neighborhood: seconds per solve on the core's ``neighborhood`` rule,
its worklist in the initial reduction and in the peel (the program's spans
``reduce.neighborhood`` + ``peel.neighborhood``, from the core's clock)."""

from perfbench.yardstick.core_profile import rule_seconds


def read(ctx):
    return rule_seconds(ctx, "neighborhood")
