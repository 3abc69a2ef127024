"""The random geometric family (``graph.geometric_graph``, DIMACS10's
``rgg_n_2_X_s0`` rule), the command line's spans and counter, and the
benchmark's ``cover-cli`` cells that drive ``gnn-vc-torch`` on a METIS file:
their instance, their judge and the metric readers they report."""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from gnn_mwvc_tpu_torch.graph import geometric_graph
from gnn_mwvc_tpu_torch.graphio import (cover_cost, is_vertex_cover,
                                        read_metis, read_solution)
from perfbench.yardstick.geometric import rgg_csr, write_metis

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2**31 + 29
SMALL = {"road1200.cover-cli": {"side": 48}, "rgg19.cover-cli": {"log2_n": 12}}
NEW_CELLS = tuple(SMALL)


def all_pairs_edges(n, seed, radius_factor=0.55):
    """The rule itself, O(n^2): every pair closer than r, as (i, j), i < j."""
    pts = np.random.default_rng(seed).random((n, 2))
    r = radius_factor * np.sqrt(np.log(n) / n)
    dx = pts[:, 0][:, None] - pts[:, 0][None, :]
    dy = pts[:, 1][:, None] - pts[:, 1][None, :]
    i, j = np.nonzero(np.triu(dx * dx + dy * dy < r * r, 1))
    return set(zip(i.tolist(), j.tolist()))


# -- the generator --------------------------------------------------------------

@pytest.mark.parametrize("log2_n,seed", [(10, 1), (10, 8), (12, 3), (12, 42)])
def test_geometric_graph_is_the_all_pairs_rule(log2_n, seed):
    n = 1 << log2_n
    g = geometric_graph(n, seed)
    assert set(map(tuple, g.edge_array().tolist())) == all_pairs_edges(n, seed)
    # the canonical CSR: symmetric, rows and their columns ascending
    rows = g.row_ids()
    key = rows * n + g.indices
    assert (np.diff(key) > 0).all() and (rows != g.indices).all()
    assert g.m * 2 == len(g.indices)
    w = np.random.default_rng(seed)
    w.random((n, 2))
    np.testing.assert_array_equal(g.weights, w.integers(1, 201, size=n))


@pytest.mark.parametrize("log2_n,seed", [(11, 5), (13, 2**31 + 7)])
def test_yardstick_rgg_equals_the_program_and_its_metis_file_reads_back(
        log2_n, seed, tmp_path):
    w, indptr, indices = rgg_csr(log2_n, seed, 0.55, 1, 200)
    g = geometric_graph(1 << log2_n, seed)
    for mine, theirs in ((w, g.weights), (indptr, g.indptr),
                         (indices, g.indices)):
        np.testing.assert_array_equal(mine, theirs)
        assert mine.dtype == np.int64
    path = tmp_path / "g.metis"
    write_metis(str(path), w, indptr, indices)
    h = read_metis(str(path))
    assert (h.n, h.m) == (g.n, g.m)
    for field in ("weights", "indptr", "indices"):
        np.testing.assert_array_equal(getattr(h, field), getattr(g, field))


def test_edge_count_is_the_expected_number_of_close_pairs():
    """n(n-1)/2 times the chance that two uniform points of the unit square
    lie closer than r (r < 1): pi r^2 - 8 r^3 / 3 + r^4 / 2."""
    n = 1 << 16
    g = geometric_graph(n, 42)
    r = 0.55 * np.sqrt(np.log(n) / n)
    expected = n * (n - 1) / 2 * (np.pi * r * r - 8 * r**3 / 3 + r**4 / 2)
    assert abs(g.m / expected - 1) < 0.015
    assert g.weights.min() >= 1 and g.weights.max() <= 200


# -- the command line ------------------------------------------------------------

@pytest.fixture(scope="module")
def rgg12_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("rgg") / "rgg12.metis"
    write_metis(str(path), *rgg_csr(12, 7))
    return path


def _cli(*argv):
    from gnn_mwvc_tpu_torch.solver import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main([str(a) for a in argv])
    return rc, out.getvalue()


def test_cli_json_carries_its_spans_and_the_reduction_counter(rgg12_file,
                                                              tmp_path):
    sol = tmp_path / "rgg12.sol"
    rc, out = _cli(rgg12_file, sol, 0, -1, 0, "--json", "--device", "cpu")
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    g = read_metis(str(rgg12_file))
    cover = read_solution(str(sol))
    assert is_vertex_cover(g, cover) and cover_cost(g, cover) == line["cost"]
    spans = line["cli_spans"]
    assert set(spans) == {"read", "output"}
    for s in spans.values():
        assert s["calls"] == 1 and s["seconds"] > 0
    live = line["phase1"]["live_after_reduce0"]
    # the initial reduction decides part of the graph, the components and
    # the peel the rest
    assert 0 < live < g.n and line["kernel_size"] <= live
    assert "read" not in line["phase1"]["spans"]


def test_cli_stdout_without_json_is_the_reference_line(rgg12_file, tmp_path):
    rc, out = _cli(rgg12_file, tmp_path / "a.sol", 0, -1, 0, "--device",
                   "cpu")
    assert rc == 0
    g = read_metis(str(rgg12_file))
    _rc, js = _cli(rgg12_file, tmp_path / "b.sol", 0, -1, 0, "--json",
                   "--device", "cpu")
    ref = json.loads(js.strip().splitlines()[-1])
    # time 0: no local search, so the reduced-path line, and nothing else
    assert out.count("\n") == 1 and out.endswith("\n")
    f = out.strip().split(",")
    assert len(f) == 8
    assert f[:5] == ["rgg12", str(g.n), str(g.m), str(ref["kernel_size"]),
                     str(ref["cost"])]
    assert f[6] == str(ref["cost"])
    for t in (f[5], f[7]):
        assert float(t) >= 0 and f"{float(t):.6g}" == t


# -- the benchmark's cells, through the whole run --------------------------------

RUNS = """
import json, sys
sys.path.insert(0, {root!r})
import numpy as np
import gnn_mwvc_tpu_torch.graphio as gio
from perfbench.run import run_cell
from perfbench.yardstick.geometric import rgg_csr

SEED = {seed}
SMALL = {small!r}
w, indptr, indices = rgg_csr(12, SEED)
rows = np.repeat(np.arange(len(w)), np.diff(indptr))
real = gio.write_solution


def uncovered(path, s):
    s = np.asarray(s).copy()
    if "warmup" not in path:  # one edge of the instance left open
        k = np.nonzero((s[rows] == 1) & (s[indices] == 0))[0][0]
        s[rows[k]] = 0
    real(path, s)


def dearer(path, s):
    s = np.asarray(s).copy()
    if "warmup" not in path:  # a cover, but not the one whose cost is told
        s[np.nonzero(s == 0)[0][0]] = 1
    real(path, s)


def run(cell, plant=None, control=False):
    gio.write_solution = plant or real
    try:
        out = run_cell(cell, SEED, 0.4, False, device="cpu",
                       scale=SMALL[cell], control=control)
    finally:
        gio.write_solution = real
    return {{"correct": out["correct"], "attempted": out["attempted"],
             "failed": out["failed"], "metrics": out["metrics"],
             "checks": {{k: c["value"] for k, c in out["checks"].items()}},
             "control": {{k: c["correct"]
                          for k, c in out.get("control", {{}}).items()}}}}


from gnn_mwvc_tpu_torch.solver.pipeline import GnnScorer
before = GnnScorer.__call__
res = {{"road": run("road1200.cover-cli"),
        "rgg": run("rgg19.cover-cli", control=True),
        "uncovered": run("rgg19.cover-cli", uncovered),
        "dearer": run("rgg19.cover-cli", dearer),
        "restored": GnnScorer.__call__ is before}}
print(json.dumps(res))
"""


@pytest.fixture(scope="module")
def runs():
    """The cells' whole runs, in a process that loads no JAX (the runner
    refuses a run that did)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", RUNS.format(root=REPO, seed=SEED,
                                           small=SMALL)],
        capture_output=True, text=True, timeout=600, cwd=REPO, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("key", ["road", "rgg"])
def test_cover_cli_cells_are_correct(runs, key):
    r = runs[key]
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert r["checks"] == {"uncovered_edges": 0, "cost_gap": 0,
                           "score_gap": r["checks"]["score_gap"]}
    assert r["checks"]["score_gap"] <= 5e-5
    assert set(r["metrics"]) == {"cover_s", "setup_s"}
    assert runs["restored"]


def test_the_tf32_control_is_not_correct(runs):
    assert runs["rgg"]["control"] == {"tf32": False}


@pytest.mark.parametrize("plant,check", [("uncovered", "uncovered_edges"),
                                         ("dearer", "cost_gap")])
def test_a_planted_fault_is_not_correct(runs, plant, check):
    r = runs[plant]
    assert not r["correct"]
    assert r["checks"][check] > 0
    assert r["failed"] == r["attempted"] >= 1


# -- the readers, on the entry's own counters ------------------------------------

READERS = ("cover_s", "reduce_s", "peel_s", "score_s", "components_s",
           "k1_roofline.cover", "device_idle.cover", "read_s", "output_s",
           "reduce_rate", "meta_bound_share", "rule_s.neighborhood",
           "rule_s.twin", "rule_s.domination", "rule_s.isolated",
           "rule_s.independent_fold", "rule_s.neighbor_meta",
           "rule_s.neighborhood_meta", "critical_s", "components_scan_s",
           "rule_fire_share")


@pytest.fixture(scope="module")
def ctx():
    """The context the readers get after a short ``rgg19.cover-cli`` window
    on the CPU, with a made-up trace: K1 busy for 1 ms of a 2 s window."""
    import torch

    from perfbench.entries import cli as entry
    from perfbench.run import ROOT, Spans, load_json, resolve_cell
    from perfbench.yardstick.trace import WINDOW_SPAN, TraceSummary

    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    _cell, config, traffic = resolve_cell(bench, "rgg19.cover-cli")
    config = {**config, "log2_n": 11}
    state = entry.prepare(config, traffic, SEED, 0.3, torch.device("cpu"))
    entry.window(state, 0.3, Spans(False))
    entry.release(state)
    checks = entry.judge(state)
    assert all(c["value"] <= c["limit"] for c in checks.values())
    trace = TraceSummary(
        device=[("csr_aggregate_kernel", 10.0, 1010.0)],
        spans=[(WINDOW_SPAN, 0.0, 2e6)], window=(0.0, 2e6))
    return {"setup_s": 1.0, "window_s": 0.3, "trace": trace,
            "counters": entry.counters(state), "config": config,
            "traffic": traffic}


def _reader(name):
    from perfbench.run import load_module

    return load_module("metrics", name)


def test_every_reader_of_the_new_cells_is_listed_for_them():
    from perfbench.run import ROOT, load_json, metrics_of

    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    for cell in NEW_CELLS:
        names = {m["name"] for m in metrics_of(bench, cell, True)}
        names |= {m["name"] for m in metrics_of(bench, cell, False)}
        assert names == set(READERS) | {"setup_s"}, cell


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_the_cli_entry(ctx, name):
    value = _reader(name).read(ctx)
    assert isinstance(value, float) and np.isfinite(value), value
    assert value > 0 or name == "components_s" and value == 0
    if name == "device_idle.cover":
        assert value == pytest.approx(100.0 * (1 - 1e-3 / 2.0))
    if name == "reduce_rate":
        s = ctx["counters"]["solves"][0]
        assert s["n"] == 2048 and s["phase1"]["live_after_reduce0"] < 2048


def test_new_readers_are_silent_on_a_program_without_the_spans(ctx):
    """The parent's command line prints no ``cli_spans`` and keeps no
    ``live_after_reduce0``: the new readers give nothing and raise
    nothing, the others read as before."""
    solves = []
    for s in ctx["counters"]["solves"]:
        s = {**s, "cli_spans": None, "phase1": dict(s["phase1"])}
        del s["phase1"]["live_after_reduce0"]
        solves.append(s)
    old = {**ctx, "counters": {**ctx["counters"], "solves": solves}}
    for name in ("read_s", "output_s", "reduce_rate"):
        assert _reader(name).read(old) is None
    for name in ("cover_s", "reduce_s", "score_s"):
        assert _reader(name).read(old) == _reader(name).read(ctx)
