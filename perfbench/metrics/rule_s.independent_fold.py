"""rule_s.independent_fold: seconds per solve on the core's
``independent_fold`` rule, its worklist in the initial reduction and in the
peel (the program's spans ``reduce.independent_fold`` +
``peel.independent_fold``, from the core's clock)."""

from perfbench.yardstick.core_profile import rule_seconds


def read(ctx):
    return rule_seconds(ctx, "independent_fold")
