"""cost_excess_ppm: how far the written cover's cost (as the reference
recomputes it) lies above the configuration's yardstick, in parts per
million of the yardstick."""


def read(ctx):
    solves = ctx["counters"]["solves"]
    if not solves or solves[-1]["cost"] is None:
        return None
    y = solves[-1]["yardstick"]
    return (solves[-1]["cost"] - y) / y * 1e6
