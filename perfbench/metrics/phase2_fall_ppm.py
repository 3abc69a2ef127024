"""phase2_fall_ppm: how far phase 2 (the local search and the device
assist) lowered the cover, in parts per million of the configuration's
yardstick: the program's ``phase1["phase2_start_cost"]`` less the written
cover's cost (as the reference recomputes it), over the yardstick, of the
window's last solve, the one ``cost_excess_ppm`` reads.  Where phase 1
takes a fixed start most of the way to the yardstick, this is the part of
``cost_excess_ppm`` that phase 2 moves.  Nothing where the solve records
no start cost (a program without it)."""


def read(ctx):
    solves = ctx["counters"]["solves"]
    if not solves or solves[-1]["cost"] is None:
        return None
    s = solves[-1]
    start = (s["phase1"] or {}).get("phase2_start_cost")
    if start is None:
        return None
    return (start - s["cost"]) / s["yardstick"] * 1e6
