"""phase1_other_s: the caller's seconds per solve less the program's
reduce, score and peel timers: the phase-1 work outside them (relabel,
the core's construction, small components, the confidence order, the
unfold), mean per solve."""


def read(ctx):
    solves = ctx["counters"]["solves"]
    if not solves:
        return None
    return sum(s["seconds"] - sum(s["phase1"].get(k, 0.0) for k in (
        "t_reduce0_s", "t_score_s", "t_peel_s")) for s in solves) / len(solves)
