"""unfold_s: the program's ``rewind`` span (the peel unfolded back to the
kernel) plus its ``finish`` span (the best cover back, every reduction
unfolded, the cover mapped to the input's ids), seconds, mean per solve."""


def _seconds(solve, name):
    return solve["phase1"]["spans"].get(name, {}).get("seconds", 0.0)


def read(ctx):
    solves = ctx["counters"]["solves"]
    if not solves or any("spans" not in s["phase1"] for s in solves):
        return None
    return sum(_seconds(s, "rewind") + _seconds(s, "finish")
               for s in solves) / len(solves)
