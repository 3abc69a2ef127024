"""score_s: the program's phase-1 timer ``t_score_s`` (host clock) less the
check's snapshots taken inside it, mean per solve."""

from perfbench.yardstick.readers import score_seconds


def read(ctx):
    solves = ctx["counters"]["solves"]
    if not solves:
        return None
    return sum(score_seconds(s) for s in solves) / len(solves)
