"""relabel_s: the program's ``relabel`` span (the clustered relabel:
``cluster_order`` and the graph's reorder), seconds, mean per solve."""


def _seconds(solve, name):
    return solve["phase1"]["spans"].get(name, {}).get("seconds", 0.0)


def read(ctx):
    solves = ctx["counters"]["solves"]
    if not solves or any("spans" not in s["phase1"] for s in solves):
        return None
    return sum(_seconds(s, "relabel") for s in solves) / len(solves)
