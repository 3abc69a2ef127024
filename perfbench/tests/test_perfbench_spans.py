"""The readers of the program's spans (``phase1["spans"]`` of each solve)
on hand-made counters, and None where a solve has no spans, as a program
without them gives."""

import json
import os

import pytest

from perfbench.run import ROOT, load_module

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
SPAN_METRICS = [m for m in BENCH["per_layer"]
                if m["source"] == "program_span"
                and os.path.exists(os.path.join(ROOT, "perfbench", "metrics",
                                                m["name"] + ".py"))]
COVER = ["relabel_s", "core_build_s", "components_s", "order_s", "unfold_s",
         "handoff_s", "untimed_s"]
BUDGET = ["handoff_s.budget", "search_share", "assist_sample_share",
          "assist_extract_share", "assist_apply_share",
          "assist_dispatch_share"]


def read(name, ctx):
    return load_module("metrics", name).read(ctx)


def spans(**seconds):
    return {k.replace("__", "."): {"seconds": v, "calls": 1}
            for k, v in seconds.items()}


def cover_ctx(with_spans=True):
    """Two phase-1 solves of 30 s and 34 s; top-level spans 29.9 s and
    32.9 s."""
    p1 = [spans(relabel=0.4, core_build=1.0, reduce=9.0, components=4.0,
                score=3.0, score__forward=0.1, order=1.5, peel=10.0,
                rewind=0.5, handoff=0.25, finish=0.25),
          spans(relabel=0.6, core_build=1.2, reduce=9.0, components=4.4,
                score=3.0, score__refresh=0.5, order=1.5, peel=12.0,
                rewind=0.7, handoff=0.35, finish=0.15)]
    solves = []
    for secs, sp in zip((30.0, 34.0), p1):
        phase1 = {"t_reduce0_s": sp["reduce"]["seconds"],
                  "t_score_s": sp["score"]["seconds"],
                  "t_peel_s": sp["peel"]["seconds"]}
        if with_spans:
            phase1["spans"] = sp
        solves.append({"seconds": secs, "phase1": phase1, "time_gnn": secs,
                       "assist": None})
    return {"counters": {"solves": solves}}


def budget_ctx(with_spans=True, assist=True):
    """One 51 s solve whose phase 1 took 11 s: 40 s of phase 2."""
    sp = spans(reduce=3.0, handoff=0.8, search=12.0, kick=0.2,
               assist=27.6, assist__sample=2.0, assist__extract=5.0,
               assist__apply=18.0, assist__dispatch=2.4)
    if not assist:
        sp = {k: v for k, v in sp.items() if not k.startswith("assist")}
        sp["search"] = {"seconds": 39.0, "calls": 500}
    phase1 = {"t_reduce0_s": 3.0}
    if with_spans:
        phase1["spans"] = sp
    return {"counters": {"solves": [{
        "seconds": 51.0, "time_gnn": 11.0, "phase1": phase1,
        "assist": {"t_host_s": 27.6} if assist else None}]}}


def test_cover_readers():
    c = cover_ctx()
    assert read("relabel_s", c) == pytest.approx(0.5)
    assert read("core_build_s", c) == pytest.approx(1.1)
    assert read("components_s", c) == pytest.approx(4.2)
    assert read("order_s", c) == pytest.approx(1.5)
    assert read("unfold_s", c) == pytest.approx((0.75 + 0.85) / 2)
    assert read("handoff_s", c) == pytest.approx(0.3)
    # children, named with a dot, are inside their parents and not
    # counted again
    assert read("untimed_s", c) == pytest.approx(((30 - 29.9)
                                                  + (34 - 32.9)) / 2)


def test_untimed_is_the_remainder_the_other_readers_leave():
    c = cover_ctx()
    s = c["counters"]["solves"][0]
    s["seconds"] = 30.5  # 0.6 s outside every span
    c["counters"]["solves"] = [s]
    other = read("phase1_other_s", c)  # caller less reduce, score, peel
    named = sum(read(n, c) for n in ("relabel_s", "core_build_s",
                                     "components_s", "order_s", "unfold_s",
                                     "handoff_s"))
    assert other == pytest.approx(named + read("untimed_s", c))
    assert read("untimed_s", c) == pytest.approx(0.6)


def test_budget_readers():
    c = budget_ctx()
    assert read("handoff_s.budget", c) == pytest.approx(0.8)
    assert read("search_share", c) == pytest.approx(30.0)
    assert read("assist_sample_share", c) == pytest.approx(5.0)
    assert read("assist_extract_share", c) == pytest.approx(12.5)
    assert read("assist_apply_share", c) == pytest.approx(45.0)
    assert read("assist_dispatch_share", c) == pytest.approx(6.0)
    # the children inside the assist's span: 27.4 of its 27.6 s
    shares = sum(read(n, c) for n in BUDGET if n.startswith("assist_"))
    host = read("assist_host_share", c)
    assert shares == pytest.approx(68.5) and 0.97 * host <= shares <= host
    plain = budget_ctx(assist=False)
    assert read("search_share", plain) == pytest.approx(97.5)
    for n in BUDGET:
        if n.startswith("assist_"):
            assert read(n, plain) is None, n


@pytest.mark.parametrize("name", COVER + BUDGET)
def test_reader_gives_nothing_without_spans(name):
    for ctx in (cover_ctx(with_spans=False), budget_ctx(with_spans=False),
                {"counters": {"solves": []}}):
        assert read(name, ctx) is None


def test_a_mix_of_solves_with_and_without_spans_reads_nothing():
    c = cover_ctx()
    del c["counters"]["solves"][1]["phase1"]["spans"]
    for name in COVER:
        assert read(name, c) is None, name


def test_every_span_metric_is_in_the_benchmark_with_a_reader():
    named = {m["name"]: m for m in SPAN_METRICS}
    assert set(COVER + BUDGET) <= set(named)
    for name in COVER + BUDGET:
        m = named[name]
        assert callable(load_module("metrics", name).read)
        cells = ["road1200.cover"] if name in COVER else (
            ["road700.budget"] if name.startswith("assist_")
            else ["road700.budget", "road700.budget-plain"])
        assert m["workloads"] == cells, name
        assert m["moves"] == ("cover_s" if name in COVER
                              else "cost_excess_ppm")
