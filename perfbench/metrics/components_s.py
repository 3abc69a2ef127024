"""components_s: the program's ``components`` span (every
``solve_small_components`` of phase 1: the exact solve of the small
components before each peel round), seconds, mean per solve."""


def _seconds(solve, name):
    return solve["phase1"]["spans"].get(name, {}).get("seconds", 0.0)


def read(ctx):
    solves = ctx["counters"]["solves"]
    if not solves or any("spans" not in s["phase1"] for s in solves):
        return None
    return sum(_seconds(s, "components") for s in solves) / len(solves)
