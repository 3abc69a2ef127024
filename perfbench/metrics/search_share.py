"""search_share: the program's ``search`` spans (each
``CoreLocalSearch.search`` batch) over the phase-2 seconds (the caller's
solve time less the program's phase-1 time), in percent."""


def read(ctx):
    solves = ctx["counters"]["solves"]
    if not solves:
        return None
    s = solves[-1]
    span = s["phase1"].get("spans", {}).get("search")
    phase2 = s["seconds"] - s["time_gnn"]
    if span is None or phase2 <= 0:
        return None
    return 100.0 * span["seconds"] / phase2
