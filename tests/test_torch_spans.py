"""The port's spans (``utils/metrics.py``): what a solve records in
``phase1["spans"]``, how the phase-1 timers and the assist's host seconds
read them, and the ``mwvc.*`` ranges a profiler sees beside its other
activity."""

import numpy as np
import pytest
import torch

from gnn_mwvc_tpu_torch.core import CoreLocalSearch
from gnn_mwvc_tpu_torch.graph import build_road_graph
from gnn_mwvc_tpu_torch.solver.device_assist import DeviceAssist
from gnn_mwvc_tpu_torch.solver.pipeline import solve
from gnn_mwvc_tpu_torch.utils import metrics as um
from tests.conftest import random_graph

PHASE1 = ("relabel", "core_build", "reduce", "components", "score", "order",
          "peel", "rewind", "handoff", "finish")
PHASE2 = ("search", "kick", "assist")
CHILDREN = {"score": {"score.snapshot", "score.upload", "score.refresh",
                      "score.forward"},
            "assist": {"assist.sample", "assist.extract", "assist.apply",
                       "assist.dispatch"}}


def top_level(spans):
    return {k: v for k, v in spans.items() if "." not in k}


def phase1_solve():
    return solve(build_road_graph(30), time_limit=0, reorder=True,
                 device="cpu")


def phase2_solve():
    """road30 with phase 2 on the CPU: the assist (K4's plain version,
    batches of 16), and a kick after every batch that finds nothing new
    (at the step-size floor from the start)."""
    return solve(build_road_graph(30), time_limit=1.5, reorder=True,
                 device="cpu", device_assist=True, assist_batch=16,
                 assist_rmax=14, ls_ils_stall=1, seed_step_size=1 << 10)


def test_solve_records_every_top_level_span_it_ran():
    res = phase1_solve()
    spans = res.phase1["spans"]
    assert res.kernel_size > 0  # so phase 2's set-up ran
    assert set(top_level(spans)) == set(PHASE1)
    rounds = res.phase1["rounds"]
    for name in ("score", "order", "peel"):
        assert spans[name]["calls"] == rounds
    for name in ("relabel", "core_build", "reduce", "rewind", "handoff",
                 "finish"):
        assert spans[name]["calls"] == 1
    assert spans["components"]["calls"] >= rounds
    # the scorer's children, on the CPU the per-snapshot rounds' (native
    # forward, no upload)
    assert {"score.snapshot", "score.forward"} <= set(spans)

    res = phase2_solve()
    spans = res.phase1["spans"]
    assert set(top_level(spans)) == set(PHASE1 + PHASE2)
    assert CHILDREN["assist"] <= set(spans)
    assert spans["assist"]["calls"] == spans["search"]["calls"]


def test_phase1_timers_and_assist_host_time_are_their_spans():
    for res in (phase1_solve(), phase2_solve()):
        p1, spans = res.phase1, res.phase1["spans"]
        assert p1["t_reduce0_s"] == spans["reduce"]["seconds"]
        assert p1["t_score_s"] == spans["score"]["seconds"]
        assert p1["t_peel_s"] == spans["peel"]["seconds"]
        assert spans["relabel"]["calls"] == 1
        assert spans["relabel"]["seconds"] > 0
    assert res.assist_stats["t_host_s"] == spans["assist"]["seconds"]


def test_spans_add_up_within_the_solve():
    for res in (phase1_solve(), phase2_solve()):
        spans = res.phase1["spans"]
        top = sum(v["seconds"] for v in top_level(spans).values())
        assert 0 < top <= res.time_total
        for parent, children in CHILDREN.items():
            inside = sum(spans[c]["seconds"] for c in children if c in spans)
            assert inside <= spans.get(parent, {"seconds": 0.0})["seconds"]


def _enable_user_scope_profiler():
    """The profiler as ``perfbench``'s ``Tracer`` turns it on: host user
    scopes only, through ``torch.autograd.profiler``'s low-level calls."""
    from torch._C._profiler import ProfilerActivity, RecordScope
    from torch.autograd import profiler as ap

    acts = {ProfilerActivity.CPU}
    prof = ap.profile(use_kineto=True)
    try:
        config = prof.config(create_trace_id=False)
    except TypeError:  # versions whose config() takes no argument
        config = prof.config()
    ap._prepare_profiler(config, acts)
    ap._enable_profiler(config, acts, {RecordScope.USER_SCOPE})


def _ranges(events):
    out = []
    for ev in events:
        name = ev.name()
        if name.startswith(um.SPAN_PREFIX):
            start = ev.start_ns()
            out.append((name[len(um.SPAN_PREFIX):], start,
                        start + ev.duration_ns()))
    return out


# spans whose blocks may launch device work, in a CPU solve with the assist
# on: they open no profiler range (the native C++ forward, a CPU
# ``score.forward``, launches nothing and opens one)
LAUNCHING = {"score", "score.upload", "score.refresh", "handoff", "assist",
             "assist.dispatch"}
# children of these spans come from the native core's own clock
# (``utils.metrics.record``): they open no range either
CORE_MEASURED = ("reduce", "peel", "components")


def measured_in_core(name):
    return "." in name and name.split(".")[0] in CORE_MEASURED


def test_spans_are_profiler_ranges_under_a_user_scope_profiler():
    from torch.autograd import profiler as ap

    _enable_user_scope_profiler()
    try:
        assert torch.autograd._profiler_enabled()
        res = phase2_solve()
    finally:
        events = ap._disable_profiler().events()
    ranges = _ranges(events)
    spans = res.phase1["spans"]
    calls = {}
    for name, _a, _b in ranges:
        calls[name] = calls.get(name, 0) + 1
    assert calls == {k: v["calls"] for k, v in spans.items()
                     if k not in LAUNCHING and not measured_in_core(k)}
    assert {"assist.sample", "assist.extract", "assist.apply", "search",
            "kick", "peel", "score.forward"} <= set(calls)
    tops = sorted((a, b) for n, a, b in ranges if "." not in n)
    for (_a0, b0), (a1, _b1) in zip(tops, tops[1:]):
        assert b0 <= a1  # the top-level spans do not overlap
    # a child lies inside its parent, which overlaps no other top-level span
    for name, a, b in ranges:
        if "." in name:
            assert name.split(".")[0] in CHILDREN
            assert not any(ta < b and a < tb for ta, tb in tops), name


def test_no_record_function_without_a_profiler(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *args, **kwargs):
        entered.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    assert not torch.autograd._profiler_enabled()
    phase2_solve()
    assert entered == []
    with torch.autograd.profiler.profile():
        with um.span("probe"):
            pass
        with um.span("launcher", launches=True):
            pass
    assert entered == ["mwvc.probe"]


def test_a_span_outside_a_solve_records_nothing():
    with um.recording() as rec:
        for _ in range(2):
            with um.span("a") as sp:
                pass
    with um.span("b"):
        pass
    assert set(rec.as_dict()) == {"a"} and rec.as_dict()["a"]["calls"] == 2
    assert rec.as_dict()["a"]["seconds"] >= sp.seconds >= 0


@pytest.mark.parametrize("rmax", [14, 20])
def test_assist_spans_add_up_within_its_host_time(rmax):
    g = random_graph(600, 6, seed=9, wmax=80)
    ls = CoreLocalSearch(g.weights, g.edge_array(), np.ones(g.n, np.uint8))
    assist = DeviceAssist(np.full(g.n, 0.5, np.float32), device="cpu",
                          batch=16, rmax=rmax)
    with um.recording() as rec:
        for _ in range(4):
            assist.tick(ls)
    assist.stop()
    spans = rec.as_dict()
    assert spans["assist"]["calls"] == 4
    assert spans["assist"]["seconds"] == assist.stats["t_host_s"]
    assert set(spans) == {"assist"} | CHILDREN["assist"]
    inside = sum(spans[c]["seconds"] for c in CHILDREN["assist"])
    assert 0 < inside <= assist.stats["t_host_s"]
    # on the CPU the region batch is solved inside the dispatch span
    assert 0 < assist.stats["t_device_s"] <= spans["assist.dispatch"][
        "seconds"]
    assert assist.stats["patches"] >= 1
