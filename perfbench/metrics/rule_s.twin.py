"""rule_s.twin: seconds per solve on the core's ``twin`` rule, its worklist in
the initial reduction and in the peel (the program's spans ``reduce.twin`` +
``peel.twin``, from the core's clock)."""

from perfbench.yardstick.core_profile import rule_seconds


def read(ctx):
    return rule_seconds(ctx, "twin")
