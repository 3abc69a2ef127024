"""Observability: phase timers, structured per-round metrics, trace spans.

``SolveMetrics`` is what ``solve(..., metrics=)`` fills: one record per
peel round (nodes remaining, edges scored, decisions, labels, seconds of
scoring and peeling), the scorer's own stats, and named phase spans.
``trace_span`` names a region in a ``torch.profiler`` trace.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from typing import Optional

__all__ = ["PhaseTimer", "SolveMetrics", "trace_span"]


class PhaseTimer:
    """Named accumulating wall-clock spans."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def as_dict(self):
        return {k: {"seconds": round(v, 6), "calls": self.counts[k]}
                for k, v in self.totals.items()}


@contextlib.contextmanager
def trace_span(name: str, enabled: bool = True):
    """A ``torch.profiler.record_function`` range (no-op when disabled);
    it shows in a profiler trace and costs nothing measurable outside
    one."""
    if not enabled:
        yield
        return
    import torch

    with torch.profiler.record_function(name):
        yield


@dataclasses.dataclass
class RoundRecord:
    round: int
    nodes_remaining: int
    edges_scored: int
    decisions: int
    label_count: int
    seconds_score: float
    seconds_peel: float


class SolveMetrics:
    """Structured per-round solve metrics and a final summary (JSONL)."""

    def __init__(self, sink: Optional[str] = None):
        self.rounds: list[RoundRecord] = []
        self.timer = PhaseTimer()
        self.sink = sink
        self.scorer_stats = None

    def record_round(self, **kw):
        self.rounds.append(RoundRecord(round=len(self.rounds), **kw))

    def record_scorer(self, stats: dict):
        """Scorer-lifecycle stats (sticky rebuilds, uploads, seconds)."""
        self.scorer_stats = stats

    def summary(self, **final):
        out = {"rounds": [dataclasses.asdict(r) for r in self.rounds],
               "phases": self.timer.as_dict(), **final}
        if self.scorer_stats:
            out["scorer"] = self.scorer_stats
        if self.sink:
            with open(self.sink, "a") as f:
                f.write(json.dumps(out) + "\n")
        return out
