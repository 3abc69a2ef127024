"""handoff_s.budget: the program's ``handoff`` span (phase 2's set-up:
the kernel's snapshot and edge list, the start cover's per-vertex read,
``CoreLocalSearch(...)``, the assist's kernel forward and
``DeviceAssist(...)``), seconds, in the budget cells."""


def _seconds(solve, name):
    return solve["phase1"]["spans"].get(name, {}).get("seconds", 0.0)


def read(ctx):
    solves = ctx["counters"]["solves"]
    if not solves or any("spans" not in s["phase1"] for s in solves):
        return None
    return sum(_seconds(s, "handoff") for s in solves) / len(solves)
