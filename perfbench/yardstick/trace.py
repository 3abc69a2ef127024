"""Trace the measured window and reduce the trace to what the per-layer
metrics read, in memory: the device's activity (kernels, copies, sets) and
the benchmark's own host spans, on one clock, in microseconds.

The benchmark marks its host spans with ``torch.profiler.record_function``
under the prefix ``perfbench.``; ``perfbench.window`` is the measured
window.  ``Tracer`` records those spans and the device's activity and
nothing of the host's operators: a profiler that records every operator
on the host slows a host-bound window (the training cell's calls ran at
about half their rate under it), and the host-clock metrics of a traced
run would read that slowdown.  Nothing of the trace is written to disk.
"""

from __future__ import annotations

import dataclasses

__all__ = ["SPAN_PREFIX", "WINDOW_SPAN", "TraceSummary", "Tracer",
           "from_events",
           "busy_seconds", "device_seconds", "device_count", "top_ops",
           "idle_gaps"]

SPAN_PREFIX = "perfbench."
WINDOW_SPAN = SPAN_PREFIX + "window"
NAME_CHARS = 160  # a device activity's name is cut to this many characters


@dataclasses.dataclass
class TraceSummary:
    """device: (name, start_us, end_us) of every device activity; spans:
    (name, start_us, end_us) of the benchmark's host spans; window: the
    measured window's (start_us, end_us)."""

    device: list
    spans: list
    window: tuple

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6


def _times_us(ev):
    if hasattr(ev, "start_ns"):
        start = ev.start_ns() / 1e3
        return start, start + ev.duration_ns() / 1e3
    start = ev.start_us()
    return start, start + ev.duration_us()


class Tracer:
    """``start()`` / ``stop()`` around the window; ``stop`` returns its
    ``TraceSummary``.  The profiler records the device's activity (CUDA)
    and, on the host, only user scopes (``record_function``), not the
    operators (``RecordScope.FUNCTION``) nor autograd's backward ones."""

    def __init__(self, cuda: bool):
        self.cuda = cuda

    def start(self):
        from torch._C._profiler import ProfilerActivity, RecordScope
        from torch.autograd import profiler as ap

        self.activities = {ProfilerActivity.CPU}
        if self.cuda:
            self.activities.add(ProfilerActivity.CUDA)
        prof = ap.profile(use_kineto=True)
        try:
            config = prof.config(create_trace_id=False)
        except TypeError:  # versions whose config() takes no argument
            config = prof.config()
        ap._prepare_profiler(config, self.activities)
        ap._enable_profiler(config, self.activities,
                            {RecordScope.USER_SCOPE})

    def stop(self) -> "TraceSummary":
        from torch.autograd import profiler as ap

        return from_events(ap._disable_profiler().events())


def from_events(events) -> TraceSummary:
    """The summary of a profiler's raw events (no event tree is built).
    Device events named like a benchmark span are the span's annotation on
    the device's timeline and are not device work."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device, spans = [], []
    for ev in events:
        name = ev.name()
        if ev.device_type() == cuda:
            if not name.startswith(SPAN_PREFIX):
                device.append((name[:NAME_CHARS], *_times_us(ev)))
        elif name.startswith(SPAN_PREFIX):
            spans.append((name, *_times_us(ev)))
    windows = [s for s in spans if s[0] == WINDOW_SPAN]
    if len(windows) != 1:
        raise RuntimeError(f"{len(windows)} {WINDOW_SPAN} spans in the trace")
    return TraceSummary(device, spans, windows[0][1:])


def _clipped(intervals, lo, hi):
    out = []
    for a, b in intervals:
        a, b = max(a, lo), min(b, hi)
        if b > a:
            out.append((a, b))
    out.sort()
    return out


def _union(intervals):
    merged = []
    for a, b in intervals:
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1][1] = b
        else:
            merged.append([a, b])
    return merged


def busy_seconds(s: TraceSummary) -> float:
    """Seconds of the window in which some operation ran on the device
    (the union of the device intervals, so overlapping streams count
    once)."""
    merged = _union(_clipped([(a, b) for _n, a, b in s.device], *s.window))
    return sum(b - a for a, b in merged) / 1e6


def device_seconds(s: TraceSummary, name: str) -> float:
    """Summed seconds of the device activities inside the window whose
    name contains ``name``."""
    return sum(b - a for n, a, b in s.device
               if name in n and a >= s.window[0] and b <= s.window[1]) / 1e6


def device_count(s: TraceSummary, name: str) -> int:
    return sum(1 for n, a, b in s.device
               if name in n and a >= s.window[0] and b <= s.window[1])


def top_ops(s: TraceSummary, k: int = 10) -> list:
    """[[name, seconds], ...]: the k device activities that took most time
    in the window, summed by name."""
    tot = {}
    for n, a, b in s.device:
        if a >= s.window[0] and b <= s.window[1]:
            tot[n] = tot.get(n, 0.0) + (b - a) / 1e6
    return [[n, t] for n, t in sorted(tot.items(), key=lambda kv: -kv[1])[:k]]


def idle_gaps(s: TraceSummary, k: int = 10) -> list:
    """[[label, seconds], ...]: the k longest stretches of the window with
    nothing on the device, each named by the innermost benchmark span the
    host was in at the stretch's middle."""
    lo, hi = s.window
    merged = _union(_clipped([(a, b) for _n, a, b in s.device], lo, hi))
    gaps, t = [], lo
    for a, b in merged:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for a, b in gaps[:k]:
        mid = (a + b) / 2
        inside = [sp for sp in s.spans if sp[1] <= mid <= sp[2]]
        label = (min(inside, key=lambda sp: sp[2] - sp[1])[0]
                 if inside else "outside any span")
        out.append([label, (b - a) / 1e6])
    return out
