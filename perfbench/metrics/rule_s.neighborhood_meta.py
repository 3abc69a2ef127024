"""rule_s.neighborhood_meta: seconds per solve on the core's
``neighborhood_meta`` rule, its worklist in the initial reduction and in the
peel (the program's spans ``reduce.neighborhood_meta`` +
``peel.neighborhood_meta``, from the core's clock)."""

from perfbench.yardstick.core_profile import rule_seconds


def read(ctx):
    return rule_seconds(ctx, "neighborhood_meta")
