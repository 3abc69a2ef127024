"""meta_bound_share: the share of the core's meta-rule small instances that
a weight bound decided without building them, the program's counters
``meta_bound_decided / meta_evals`` summed over the window's solves;
nothing where the program keeps no such counters."""


def read(ctx):
    solves = ctx["counters"]["solves"]
    if not solves or any("meta_evals" not in s["phase1"] for s in solves):
        return None
    evals = sum(s["phase1"]["meta_evals"] for s in solves)
    decided = sum(s["phase1"]["meta_bound_decided"] for s in solves)
    return decided / evals if evals else None
