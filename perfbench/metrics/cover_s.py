"""cover_s: the window's seconds, less the check's snapshots taken inside
it (the benchmark's work, not the program's), over the whole solves it
completed (host clock, the caller's side)."""


def read(ctx):
    solves = ctx["counters"]["solves"]
    if not solves:
        return None
    check = sum(s.get("check_s", 0.0) for s in solves)
    return (ctx["window_s"] - check) / len(solves)
