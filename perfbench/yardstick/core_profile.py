"""Arithmetic of the readers of the native core's profile: the child spans
that the program records under its ``reduce``, ``peel`` and ``components``
spans from the core's own clock (``reduce.<rule>``, ``peel.<rule>``,
``reduce.critical``, ``peel.critical``, ``components.scan``; a rule's
calls are its evaluations) and the counts it keeps beside them in
``phase1["core_counts"]`` (``<span>.<rule>.fires``).  Each returns None
where a solve of the window lacks those counts, as a program without the
profile does."""

from __future__ import annotations

__all__ = ["RULES", "fire_share", "rule_seconds", "span_seconds"]

# the core's seven local rules, in its order: the program's
# ``core.PROFILE_RULES``, copied, since the readers also run on a program
# that lacks it
RULES = ("neighborhood", "twin", "domination", "isolated",
         "independent_fold", "neighbor_meta", "neighborhood_meta")
CASCADES = ("reduce", "peel")  # the spans in which the rules run


def _solves(ctx):
    solves = ctx["counters"]["solves"]
    if not solves or any("core_counts" not in s["phase1"]
                         or "spans" not in s["phase1"] for s in solves):
        return None
    return solves


def span_seconds(ctx, names):
    """The spans ``names`` summed, seconds per solve."""
    solves = _solves(ctx)
    if solves is None:
        return None
    return sum(s["phase1"]["spans"].get(n, {}).get("seconds", 0.0)
               for s in solves for n in names) / len(solves)


def rule_seconds(ctx, rule):
    """Seconds per solve on ``rule``'s worklist, in the reduce and the
    peel."""
    return span_seconds(ctx, [f"{c}.{rule}" for c in CASCADES])


def fire_share(ctx):
    """Fires as a share of evaluations (%), the seven rules in the reduce
    and the peel, summed over the window."""
    solves = _solves(ctx)
    if solves is None:
        return None
    names = [f"{c}.{r}" for c in CASCADES for r in RULES]
    evals = sum(s["phase1"]["spans"].get(n, {}).get("calls", 0)
                for s in solves for n in names)
    fires = sum(s["phase1"]["core_counts"].get(n + ".fires", 0)
                for s in solves for n in names)
    return 100.0 * fires / evals if evals else None
