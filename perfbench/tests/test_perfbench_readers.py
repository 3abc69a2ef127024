"""Each metric reader on a recorded, synthetic trace and synthetic
counters: the trace reduction, the rooflines, the utilisations, and None
where a run gave a reader nothing to read."""

import json
import os

import pytest

from perfbench.run import ROOT, load_module
from perfbench.yardstick import counts
from perfbench.yardstick import trace as tr

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
ALL_METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


def summary():
    """A 10 ms window (1000-11000 us): K1 launches of 100 and 50 us, a
    copy overlapping the first, K4 launches of 10 us, one annotation of
    the benchmark's on the device's timeline (not device work)."""
    device = [("void csr_aggregate_kernel<4>(...)", 2000.0, 2100.0),
              ("Memcpy HtoD (Pinned -> Device)", 2050.0, 2150.0),
              ("void csr_aggregate_kernel<4>(...)", 5000.0, 5050.0),
              ("small_mwvc_mitm_kernel", 8000.0, 8010.0),
              ("small_mwvc_mitm_kernel", 9000.0, 9010.0),
              ("outside the window", 20000.0, 20100.0)]
    spans = [("perfbench.window", 1000.0, 11000.0),
             ("perfbench.solve", 1000.0, 10000.0),
             ("perfbench.score", 1500.0, 5100.0)]
    return tr.TraceSummary(device, spans, (1000.0, 11000.0))


def test_trace_reduction():
    s = summary()
    assert s.window_s == pytest.approx(0.01)
    # union: 2000-2150, 5000-5050, 8000-8010, 9000-9010
    assert tr.busy_seconds(s) == pytest.approx(220e-6)
    assert tr.device_seconds(s, "csr_aggregate") == pytest.approx(150e-6)
    assert tr.device_count(s, "small_mwvc_mitm") == 2
    top = tr.top_ops(s)
    assert top[0][0].startswith("void csr_aggregate")
    assert top[0][1] == pytest.approx(150e-6)
    gaps = tr.idle_gaps(s, k=3)
    # longest first: 5050-8000 (solve), 2150-5000 (score), 9010-11000
    # (only the window), by the innermost span at each gap's middle
    assert [g[0] for g in gaps] == ["perfbench.solve", "perfbench.score",
                                    "perfbench.window"]
    assert [g[1] for g in gaps] == pytest.approx([2950e-6, 2850e-6,
                                                  1990e-6])


def solve_ctx(trace=True):
    calls = [{"sticky": True, "n": 100, "nnz": 600, "seconds": 0.1,
              "k1": [(120, 120, 700, 16, 4)] * 2}]
    solves = [{"seconds": 30.0, "cost": 1_000_100, "yardstick": 1_000_000,
               "phase1": {"t_reduce0_s": 5.0, "t_score_s": 8.0,
                          "t_peel_s": 12.0},
               "time_gnn": 10.0, "ls_steps": 2_000_000,
               "assist": {"t_host_s": 14.0}, "calls": calls,
               "check_s": 0.5}]
    return {"setup_s": 12.5, "window_s": 60.0,
            "trace": summary() if trace else None,
            "counters": {"solves": solves},
            "traffic": {"solve": {"assist_batch": 1024, "assist_rmax": 20}}}


def train_ctx():
    per_pass = {"train_n": 300, "train_graphs": [(100, 600)] * 3,
                "eval_graphs": [(100, 600)] * 4}
    return {"setup_s": 3.0, "window_s": 2.0, "trace": summary(),
            "counters": {"calls": [{"seconds": 1.0, "passes": 3},
                                   {"seconds": 1.0, "passes": 3}],
                         "per_pass": per_pass}}


def read(name, ctx):
    return load_module("metrics", name).read(ctx)


def test_solve_readers():
    c = solve_ctx()
    assert read("setup_s", c) == 12.5
    # the check's 0.5 s of snapshots inside the scoring timer and the
    # window are the benchmark's work: out of cover_s, score_s, score_mfu
    assert read("cover_s", c) == 59.5
    assert read("cost_excess_ppm", c) == pytest.approx(100.0)
    assert read("reduce_s", c) == 5.0
    assert read("score_s", c) == 7.5
    assert read("peel_s", c) == 12.0
    assert read("phase1_other_s", c) == 5.0
    assert read("score_mfu", c) == pytest.approx(
        100 * (100 * 12000 + 600 * 32) / (7.5 * 67e12))
    k1 = 2 * counts.k1_bytes(120, 120, 700, 16, 4)
    assert read("k1_roofline.cover", c) == pytest.approx(
        100 * k1 / 3.35e12 / 150e-6)
    assert read("device_idle.cover", c) == pytest.approx(100 * (1 - 0.022))
    assert read("device_idle.budget", c) == read("device_idle.cover", c)
    assert read("ls_steps_per_s", c) == pytest.approx(2e6 / 20.0)
    assert read("assist_host_share", c) == pytest.approx(70.0)
    assert read("k4_roofline", c) == pytest.approx(
        100 * 2 * 172_032 / 3.35e12 / 20e-6)


def test_train_readers():
    c = train_ctx()
    assert read("train_vertices_per_s", c) == pytest.approx(6 * 300 / 2.0)
    flops = 3 * counts.train_pass_flops(100, 600) \
        + 4 * counts.forward_flops(100, 600)
    assert read("train_mfu", c) == pytest.approx(
        100 * 6 * flops / (2.0 * 67e12))
    per_pass = (3 * 2 + 4) * 2 * counts.k1_bytes(100, 100, 600, 16)
    # 6 passes; 3 train graphs x (2 forward + 2 backward) + 4 x 2 forward
    assert per_pass == (3 * 4 + 4 * 2) * counts.k1_bytes(100, 100, 600, 16)
    assert read("k1_roofline.train", c) == pytest.approx(
        100 * 6 * per_pass / 3.35e12 / 150e-6)
    assert read("device_idle.train", c) == pytest.approx(97.8)


def test_readers_return_nothing_without_a_reading():
    empty = {"setup_s": 1.0, "window_s": 1.0, "trace": None,
             "counters": {"solves": [], "calls": [],
                          "per_pass": {"train_n": 1, "train_graphs": [],
                                       "eval_graphs": []}},
             "traffic": {"solve": {}}}
    for name in ALL_METRICS:
        if name != "setup_s":
            assert read(name, empty) is None, name
    # a trace with no K4 launch gives no K4 roofline, never 0
    c = solve_ctx()
    c["trace"] = tr.TraceSummary([], c["trace"].spans, c["trace"].window)
    assert read("k4_roofline", c) is None
    assert read("k1_roofline.cover", c) is None
    c["counters"]["solves"][0]["assist"] = None
    assert read("assist_host_share", c) is None


def test_tracer_keeps_spans_and_leaves_out_host_operators(monkeypatch):
    """The traced window records the benchmark's spans and the device's
    activity, and not the host's operators, whose recording slows a
    host-bound window."""
    import torch

    seen = []
    real = tr.from_events

    def keep(events):
        events = list(events)
        seen.extend(ev.name() for ev in events)
        return real(events)

    monkeypatch.setattr(tr, "from_events", keep)
    tracer = tr.Tracer(cuda=False)
    tracer.start()
    with torch.profiler.record_function(tr.WINDOW_SPAN):
        with torch.profiler.record_function("perfbench.solve"):
            x = torch.ones(8, requires_grad=True)
            (x * 2 + 1).sum().backward()
    s = tracer.stop()
    assert sorted(sp[0] for sp in s.spans) == ["perfbench.solve",
                                               tr.WINDOW_SPAN]
    assert s.window[1] > s.window[0]
    assert not [n for n in seen if n.startswith("aten::")
                or "Backward" in n], seen


def test_every_metric_has_a_reader():
    for name in ALL_METRICS:
        assert callable(load_module("metrics", name).read), name
