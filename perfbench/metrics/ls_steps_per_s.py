"""ls_steps_per_s: the local search's steps (the program's
SolveResult.ls_steps) over the phase-2 seconds, the caller's solve time
less the program's phase-1 time."""


def read(ctx):
    solves = ctx["counters"]["solves"]
    if not solves:
        return None
    s = solves[-1]
    phase2 = s["seconds"] - s["time_gnn"]
    return s["ls_steps"] / phase2 if phase2 > 0 and s["ls_steps"] else None
