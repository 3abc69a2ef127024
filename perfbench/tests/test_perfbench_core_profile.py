"""The readers of the native core's profile on hand-made counters: the
rules' seconds in the reduce and the peel, the critical-weight flow's, the
component search's outside its exact solves and the worklists' fire share;
nothing where a solve lacks the profile, as on a program without it; and
each metric in ``BENCHMARK.json`` with a reader and the three cover cells."""

import json
import os

import pytest

from perfbench.run import ROOT, load_module
from perfbench.yardstick.core_profile import RULES

CELLS = ["road1200.cover", "road1200.cover-cli", "rgg19.cover-cli"]
SECONDS = [f"rule_s.{r}" for r in RULES] + ["critical_s", "components_scan_s"]
METRICS = SECONDS + ["rule_fire_share"]


def read(name, ctx):
    return load_module("metrics", name).read(ctx)


def span(seconds, calls):
    return {"seconds": seconds, "calls": calls}


def solve(k):
    """Solve ``k`` (1 or 2) of a window: the top-level spans, each rule's
    child span in the reduce (k s, 100 k evaluations) and in the peel (2 k
    s, 300 k evaluations) with k and 2 k fires, the flow in the peel
    alone, and the component search."""
    spans = {"reduce": span(10.0 * k, 1), "peel": span(20.0 * k, 40),
             "components": span(5.0 * k, 40),
             "peel.critical": span(0.5 * k, 17),
             "peel.select": span(0.25 * k, 9000),
             "components.scan": span(3.0 * k, 40),
             "components.exact": span(1.5 * k, 700)}
    counts = {"peel.critical.live": 4000 * k, "reduce.critical.live": 0}
    for r in RULES:
        spans[f"reduce.{r}"] = span(1.0 * k, 100 * k)
        spans[f"peel.{r}"] = span(2.0 * k, 300 * k)
        counts[f"reduce.{r}.fires"] = k
        counts[f"peel.{r}.fires"] = 2 * k
    return {"seconds": 40.0 * k, "phase1": {
        "t_reduce0_s": 10.0 * k, "spans": spans, "core_counts": counts}}


def ctx(*solves):
    return {"setup_s": 12.5, "window_s": 51.0, "trace": None,
            "counters": {"solves": list(solves)}}


def test_readers_on_hand_made_counters():
    c = ctx(solve(1), solve(2))
    for r in RULES:  # (1 + 2) s and (2 + 4) s over two solves
        assert read(f"rule_s.{r}", c) == pytest.approx(4.5)
    assert read("critical_s", c) == pytest.approx(0.75)
    assert read("components_scan_s", c) == pytest.approx(4.5)
    # per rule 3 + 6 fires in 300 + 900 evaluations
    assert read("rule_fire_share", c) == pytest.approx(100.0 * 9 / 1200)


def test_a_flow_in_the_reduce_counts_and_an_absent_child_reads_zero():
    s = solve(1)
    s["phase1"]["spans"]["reduce.critical"] = span(0.25, 1)
    del s["phase1"]["spans"]["reduce.twin"]
    c = ctx(s)
    assert read("critical_s", c) == pytest.approx(0.75)
    assert read("rule_s.twin", c) == pytest.approx(2.0)


@pytest.mark.parametrize("name", METRICS)
def test_reader_gives_nothing_without_the_profile(name):
    parent = solve(1)
    del parent["phase1"]["core_counts"]
    for key, _ in list(parent["phase1"]["spans"].items()):
        if "." in key:
            del parent["phase1"]["spans"][key]
    bare = {"seconds": 30.0, "phase1": {}}  # a command line's empty phase1
    for c in (ctx(parent), ctx(solve(1), parent), ctx(bare), ctx()):
        assert read(name, c) is None


def test_no_evaluations_give_no_share():
    s = solve(1)
    for key in list(s["phase1"]["spans"]):
        if key.split(".")[-1] in RULES:
            del s["phase1"]["spans"][key]
    assert read("rule_fire_share", ctx(s)) is None


def test_every_profile_metric_is_in_the_benchmark_with_a_reader():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    named = {m["name"]: m for m in bench["per_layer"]}
    for name in METRICS:
        m = named[name]
        assert callable(load_module("metrics", name).read)
        assert m["workloads"] == CELLS, name
        assert (m["layer"], m["moves"]) == ("core", "cover_s"), name
        assert (m["unit"], m["better"], m["source"]) == (
            ("s", "lower", "program_span") if name in SECONDS
            else ("%", "higher", "program_counter")), name
    assert [m["name"] for m in bench["per_layer"][-len(METRICS):]] == METRICS
