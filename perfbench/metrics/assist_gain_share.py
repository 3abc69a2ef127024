"""assist_gain_share: the share of phase 2's fall that came at the device
assist's commits, in percent: the program's ``best_gain``
(``assist_stats``: the best cover's drop at each commit of patches, at most
the patches' own drop) over the fall from the cover phase 2 started from
(``phase1["phase2_start_cost"]``) to the written cover's cost (as the
reference recomputes it), mean per solve.  The rest of the fall came at the
search's chunk ends.  Credit is by where the best cover dropped: the search
moves that brought the live cover near the best before a commit count for
the assist, and the search's dips inside a chunk that it later lost count
for neither (they are not in the written cover).  Nothing where a solve
records no start cost or no ``best_gain`` (a program without them), ran no
assist, or gained nothing in phase 2."""


def read(ctx):
    shares = []
    for s in ctx["counters"]["solves"]:
        start = s["phase1"].get("phase2_start_cost")
        gain = (s["assist"] or {}).get("best_gain")
        if start is None or gain is None or s["cost"] is None:
            return None
        fall = start - s["cost"]
        if fall <= 0:
            return None
        shares.append(100.0 * gain / fall)
    return sum(shares) / len(shares) if shares else None
