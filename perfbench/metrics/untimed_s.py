"""untimed_s: the caller's seconds per solve less every top-level span of
the program's (those named without a dot): what no span of the solve
holds, mean per solve."""


def _untimed(solve):
    spans = solve["phase1"]["spans"]
    return solve["seconds"] - sum(v["seconds"] for k, v in spans.items()
                                  if "." not in k)


def read(ctx):
    solves = ctx["counters"]["solves"]
    if not solves or any("spans" not in s["phase1"] for s in solves):
        return None
    return sum(_untimed(s) for s in solves) / len(solves)
