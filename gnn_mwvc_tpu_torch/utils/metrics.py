"""Observability: named spans of a solve and structured per-round metrics.

``span(name)`` times one piece of a solve with one ``perf_counter`` pair
(``with span("peel") as sp: ...``, then ``sp.seconds``).  ``solve()``
installs a ``SpanRecorder`` for its duration (``recording()``, through a
context variable), so every span opened inside it, in the scorer and the
assist too, adds its seconds and one call to that solve's totals, which
``solve()`` returns as ``SolveResult.phase1["spans"]``.  Outside a solve a
span records nothing.  ``record(name, seconds, calls)`` adds to a span
seconds that were measured elsewhere, such as the native core's per-rule
profile, with a count of its own.

While a profiler is on (``torch.autograd._profiler_enabled()``, which also
sees a profiler enabled through ``torch.autograd.profiler``'s low-level
calls), a span is also a ``torch.profiler.record_function`` range named
``mwvc.<name>``, on the profiler's clock beside the device's activity.  With
no profiler on, no range is opened: a span then costs its clock pair and
that one check.

A span whose block may launch device work (``launches=True``) opens no
range.  A profiler that records the device draws each such range a second
time, on the device's timeline, as an annotation from the first to the last
activity launched inside it, gaps included; a reader that sums the device's
activity counts that annotation as device work.  Around the scorer's
forward and the assist's batches such annotations came to 9-14 times the
device's real busy time (H100, solves of road200 and road300).

``SolveMetrics`` is what ``solve(..., metrics=)`` fills: one record per
peel round, the scorer's counts, and the solve's span totals.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import json
import time
from typing import Optional

import torch

__all__ = ["SolveMetrics", "SpanRecorder", "record", "recording", "span"]

SPAN_PREFIX = "mwvc."  # a span's range name in a profiler trace

_RECORDER: contextvars.ContextVar = contextvars.ContextVar(
    "mwvc_span_recorder", default=None)


class SpanRecorder:
    """Seconds and calls per span name."""

    def __init__(self):
        self.seconds: dict[str, float] = {}
        self.calls: dict[str, int] = {}

    def add(self, name: str, seconds: float, calls: int = 1):
        self.seconds[name] = self.seconds.get(name, 0.0) + seconds
        self.calls[name] = self.calls.get(name, 0) + calls

    def as_dict(self) -> dict:
        return {k: {"seconds": v, "calls": self.calls[k]}
                for k, v in self.seconds.items()}


@contextlib.contextmanager
def recording():
    """Record every span opened in the block (in this thread) into a new
    ``SpanRecorder``, which the block receives."""
    rec = SpanRecorder()
    token = _RECORDER.set(rec)
    try:
        yield rec
    finally:
        _RECORDER.reset(token)


def record(name: str, seconds: float, calls: int):
    """Add ``seconds`` measured elsewhere (by the native core's own clock)
    and a count of ``calls`` to the current solve's span ``name``; nothing
    outside a solve.  Such a span opens no profiler range."""
    rec = _RECORDER.get()
    if rec is not None:
        rec.add(name, seconds, calls)


class span:
    """``with span(name) as sp:`` times one piece of a solve;
    ``sp.seconds`` is set when the block exits.  ``launches``: the block
    may launch device work, so it opens no profiler range."""

    __slots__ = ("name", "launches", "seconds", "_t0", "_range")

    def __init__(self, name: str, launches: bool = False):
        self.name = name
        self.launches = launches
        self.seconds = 0.0

    def __enter__(self):
        self._range = None
        if not self.launches and torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(
                SPAN_PREFIX + self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        rec = _RECORDER.get()
        if rec is not None:
            rec.add(self.name, self.seconds)
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


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
        self.sink = sink
        self.scorer_stats = None
        self.spans: dict = {}

    def record_round(self, **kw):
        self.rounds.append(RoundRecord(round=len(self.rounds), **kw))

    def record_scorer(self, stats: dict):
        """The scorer's counts (rounds, per-snapshot rounds, rebuilds)."""
        self.scorer_stats = stats

    def record_spans(self, spans: dict):
        """The solve's span totals, ``{name: {"seconds", "calls"}}``."""
        self.spans = spans

    def summary(self, **final):
        out = {"rounds": [dataclasses.asdict(r) for r in self.rounds],
               "phases": self.spans, **final}
        if self.scorer_stats:
            out["scorer"] = self.scorer_stats
        if self.sink:
            with open(self.sink, "a") as f:
                f.write(json.dumps(out) + "\n")
        return out
