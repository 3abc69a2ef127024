"""critical_s: seconds per solve in the core's critical-weight flow
(``rule_critical_weight``, run where fewer than 1,000 vertices are live):
the program's spans ``reduce.critical`` + ``peel.critical``, from the
core's clock."""

from perfbench.yardstick.core_profile import span_seconds


def read(ctx):
    return span_seconds(ctx, ["reduce.critical", "peel.critical"])
