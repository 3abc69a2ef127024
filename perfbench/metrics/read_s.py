"""read_s: the command line's ``read`` span (``read_metis`` of the graph
file), seconds, mean per call; nothing where the program records no
``cli_spans``."""


def read(ctx):
    solves = ctx["counters"]["solves"]
    if not solves or any(not s.get("cli_spans") for s in solves):
        return None
    return sum(s["cli_spans"].get("read", {}).get("seconds", 0.0)
               for s in solves) / len(solves)
