"""rule_s.isolated: seconds per solve on the core's ``isolated`` rule, its
worklist in the initial reduction and in the peel (the program's spans
``reduce.isolated`` + ``peel.isolated``, from the core's clock)."""

from perfbench.yardstick.core_profile import rule_seconds


def read(ctx):
    return rule_seconds(ctx, "isolated")
