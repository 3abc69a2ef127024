"""output_s: the command line's ``output`` span (the written cover's check,
its cost and ``write_solution``), seconds, mean per call; nothing where the
program records no ``cli_spans``."""


def read(ctx):
    solves = ctx["counters"]["solves"]
    if not solves or any(not s.get("cli_spans") for s in solves):
        return None
    return sum(s["cli_spans"].get("output", {}).get("seconds", 0.0)
               for s in solves) / len(solves)
