"""reduce_rate: vertices decided by the initial reduction a second, (n -
the program's counter ``live_after_reduce0``) / its timer ``t_reduce0_s``,
mean per call; nothing where the program keeps no such counter."""


def read(ctx):
    solves = ctx["counters"]["solves"]
    rates = []
    for s in solves:
        p = s["phase1"]
        if "live_after_reduce0" not in p or "n" not in s:
            return None
        if p.get("t_reduce0_s", 0.0) <= 0:
            return None
        rates.append((s["n"] - p["live_after_reduce0"]) / p["t_reduce0_s"])
    return sum(rates) / len(rates) if rates else None
