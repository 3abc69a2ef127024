"""rule_s.neighbor_meta: seconds per solve on the core's ``neighbor_meta``
rule, its worklist in the initial reduction and in the peel (the program's
spans ``reduce.neighbor_meta`` + ``peel.neighbor_meta``, from the core's
clock)."""

from perfbench.yardstick.core_profile import rule_seconds


def read(ctx):
    return rule_seconds(ctx, "neighbor_meta")
