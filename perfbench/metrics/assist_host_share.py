"""assist_host_share: the assist's host seconds (the program's
assist_stats t_host_s) over the phase-2 seconds, in percent."""


def read(ctx):
    solves = ctx["counters"]["solves"]
    if not solves or not solves[-1]["assist"]:
        return None
    s = solves[-1]
    phase2 = s["seconds"] - s["time_gnn"]
    return 100.0 * s["assist"]["t_host_s"] / phase2 if phase2 > 0 else None
