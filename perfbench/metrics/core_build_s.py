"""core_build_s: the program's ``core_build`` span (the graph's edge list and
``CoreSolver(...)``, the native core's construction), seconds, mean per
solve."""


def _seconds(solve, name):
    return solve["phase1"]["spans"].get(name, {}).get("seconds", 0.0)


def read(ctx):
    solves = ctx["counters"]["solves"]
    if not solves or any("spans" not in s["phase1"] for s in solves):
        return None
    return sum(_seconds(s, "core_build") for s in solves) / len(solves)
