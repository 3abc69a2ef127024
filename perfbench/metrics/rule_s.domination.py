"""rule_s.domination: seconds per solve on the core's ``domination`` rule, its
worklist in the initial reduction and in the peel (the program's spans
``reduce.domination`` + ``peel.domination``, from the core's clock)."""

from perfbench.yardstick.core_profile import rule_seconds


def read(ctx):
    return rule_seconds(ctx, "domination")
