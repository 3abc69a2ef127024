"""The port's remaining single-device surfaces against the JAX package's:
``--quick``, the approximation solver, the ablation grid, checkpoints,
``mwvc-tools-torch``, ``mwvc-baseline-torch``, ``mwvc-batch-torch``,
``mwvc-bench-torch`` and the solve metrics.  Every
compared result is an integer or a boolean, so equality is exact."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench
from gnn_mwvc_tpu.solver.pipeline import solve as jax_solve
from gnn_mwvc_tpu_torch.graph import Graph, build_road_graph, random_graph
from gnn_mwvc_tpu_torch.graphio import (cover_cost, is_vertex_cover,
                                        read_solution, write_metis,
                                        write_solution)
from gnn_mwvc_tpu_torch.solver.pipeline import solve
from gnn_mwvc_tpu_torch.solver.quick import QuickScorer
from tests import conftest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port(gj):
    return Graph(gj.weights, gj.edge_array())


def _run_cli(module, *args, timeout=300):
    return subprocess.run([sys.executable, "-m", module, *map(str, args)],
                          capture_output=True, text=True, timeout=timeout,
                          cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO))


# -- generators ---------------------------------------------------------------

def test_random_graph_equals_the_test_helper():
    a = random_graph(700, 6, seed=4, wmax=90)
    b = conftest.random_graph(700, 6, seed=4, wmax=90)
    for field in ("weights", "indptr", "indices"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
        assert getattr(a, field).dtype == getattr(b, field).dtype


# -- quick --------------------------------------------------------------------

@pytest.mark.parametrize("name", ["er1500", "road60"])
def test_quick_phase1_cost_equals_jax(name):
    from gnn_mwvc_tpu.solver.quick import QuickScorer as JaxQuickScorer

    gj = {"er1500": lambda: conftest.random_graph(1500, 14, seed=5,
                                                  wmax=500),
          "road60": lambda: bench.build_road_graph(60)}[name]()
    ref = jax_solve(gj, time_limit=0, scorer=JaxQuickScorer(),
                    device_assist=False)
    g = _port(gj)
    res = solve(g, time_limit=0, scorer=QuickScorer(), device="cpu")
    assert is_vertex_cover(g, res.solution)
    assert (res.cost, res.kernel_size) == (ref.cost, ref.kernel_size)
    np.testing.assert_array_equal(res.counters, ref.counters)


def test_quick_scores_equal_jax():
    from gnn_mwvc_tpu.solver.quick import QuickScorer as JaxQuickScorer
    from gnn_mwvc_tpu_torch.core import CoreSolver

    gj = bench.build_road_graph(40)
    core = CoreSolver(gj.weights, gj.edge_array())
    core.reduce()
    snap = core.snapshot()
    np.testing.assert_array_equal(QuickScorer()(snap, 1000.0),
                                  JaxQuickScorer()(snap, 1000.0))


def test_cli_quick_contract_and_cost(tmp_path):
    from gnn_mwvc_tpu.solver.quick import QuickScorer as JaxQuickScorer

    gj = conftest.random_graph(600, 8, seed=17, wmax=300)
    g = _port(gj)
    gpath, spath = tmp_path / "q.metis", tmp_path / "q.sol"
    write_metis(str(gpath), g)
    out = _run_cli("gnn_mwvc_tpu_torch.solver.cli", gpath, spath, 0, -1, 0,
                   "--quick", "--device", "cpu")
    assert out.returncode == 0, out.stderr[-2000:]
    fields = [ln for ln in out.stdout.splitlines()
              if ln.startswith("q,")][-1].split(",")
    assert len(fields) == 8  # no local search ran: the reduced-path line
    sol = read_solution(spath)
    assert is_vertex_cover(g, sol) and cover_cost(g, sol) == int(fields[6])
    ref = jax_solve(gj, time_limit=0, scorer=JaxQuickScorer(),
                    device_assist=False)
    assert int(fields[6]) == ref.cost


def test_cli_refuses_shards(tmp_path, capsys):
    """--shards N on CUDA with fewer than N cards exits 2, naming both
    counts, before it reads the graph."""
    import torch

    from gnn_mwvc_tpu_torch.solver import cli

    n = torch.cuda.device_count() + 1
    with pytest.raises(SystemExit) as e:
        cli.main([str(tmp_path / "g.metis"), str(tmp_path / "g.sol"), "1",
                  "--shards", str(n)])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert f"{n} shards" in err and f"found {n - 1}" in err


# -- approximation and ablation ---------------------------------------------

@pytest.mark.parametrize("name", ["er2000", "road50"])
def test_approximate_solve_equals_jax(name):
    from gnn_mwvc_tpu.solver.approximation import (
        approximate_solve as jax_approx)
    from gnn_mwvc_tpu_torch.solver.approximation import approximate_solve

    gj = {"er2000": lambda: conftest.random_graph(2000, 10, seed=8),
          "road50": lambda: bench.build_road_graph(50)}[name]()
    vc, cost, _ = approximate_solve(_port(gj))
    vc0, cost0, _ = jax_approx(gj)
    assert cost == cost0
    np.testing.assert_array_equal(vc, vc0)


def test_ablation_equals_jax():
    from gnn_mwvc_tpu.solver.ablation import ablation_csv as jax_csv
    from gnn_mwvc_tpu.solver.ablation import run_ablation as jax_ablation
    from gnn_mwvc_tpu_torch.solver.ablation import ablation_csv, run_ablation

    gj = conftest.random_graph(700, 8, seed=23, wmax=200)
    g = _port(gj)
    ours = run_ablation(g, device="cpu")
    ref = jax_ablation(gj)
    assert [r.config for r in ours] == [r.config for r in ref] == [
        "GRS", "GR", "GS", "G", "QRS", "QR", "QS", "Q"]
    for a, b in zip(ours, ref):
        assert (a.cost, a.cost_before, a.small_solve_count,
                a.labels_from_model) == (b.cost, b.cost_before,
                                         b.small_solve_count,
                                         b.labels_from_model), a.config
        np.testing.assert_array_equal(a.counters, b.counters,
                                      err_msg=a.config)

    def strip_times(row):
        f = row.split(",")
        return [x for i, x in enumerate(f) if not (3 <= i < 35 and i % 2 == 0)]

    assert strip_times(ablation_csv("x", g, ours)) == strip_times(
        jax_csv("x", gj, ref))


# -- checkpoints --------------------------------------------------------------

def test_checkpoint_round_trip_and_rejections(tmp_path):
    from gnn_mwvc_tpu_torch.solver.checkpoint import (load_checkpoint,
                                                      save_checkpoint)

    g = random_graph(150, 6, seed=62)
    cover = np.ones(g.n, dtype=np.int8)
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, g, cover, int(g.weights.sum()), 1.5,
                    extra={"note": "test"})
    c2, meta = load_checkpoint(path, g)
    np.testing.assert_array_equal(c2, cover)
    assert meta["cost"] == int(g.weights.sum()) and meta["note"] == "test"
    with pytest.raises(ValueError, match="does not match"):
        load_checkpoint(path, random_graph(150, 6, seed=63))
    with pytest.raises(ValueError, match="invalid cover"):
        save_checkpoint(path, g, np.zeros(g.n, np.int8), 0, 0.0)
    with pytest.raises(ValueError, match="not the cover"):
        save_checkpoint(path, g, cover, 1, 0.0)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_loads_across_packages(tmp_path, writer):
    from gnn_mwvc_tpu.solver import checkpoint as jax_ck
    from gnn_mwvc_tpu_torch.solver import checkpoint as ck

    gj = conftest.random_graph(300, 6, seed=64, wmax=50)
    g = _port(gj)
    assert ck.graph_fingerprint(g) == jax_ck.graph_fingerprint(gj)
    cover = np.ones(g.n, dtype=np.int8)
    cover[0] = 0
    if not is_vertex_cover(g, cover):
        cover[0] = 1
    path = str(tmp_path / "ck.npz")
    save, load = ((jax_ck.save_checkpoint, ck.load_checkpoint)
                  if writer == "jax" else
                  (ck.save_checkpoint, jax_ck.load_checkpoint))
    save(path, gj if writer == "jax" else g, cover, cover_cost(g, cover),
         2.5, extra={"by": writer})
    c2, meta = load(path, g if writer == "jax" else gj)
    np.testing.assert_array_equal(c2, cover)
    assert (meta["cost"], meta["elapsed"], meta["by"]) == (
        cover_cost(g, cover), 2.5, writer)


def test_resume_solve_improves_and_rewrites(tmp_path):
    from gnn_mwvc_tpu_torch.solver.checkpoint import (load_checkpoint,
                                                      resume_solve,
                                                      save_checkpoint)

    g = random_graph(400, 8, seed=65, wmax=100)
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, g, np.ones(g.n, np.int8), int(g.weights.sum()), 0.0)
    best, cost, _seen = resume_solve(g, path, time_limit=1.0)
    assert is_vertex_cover(g, best) and cost == cover_cost(g, best)
    assert cost < g.weights.sum()
    assert load_checkpoint(path, g)[1]["cost"] == cost


@pytest.mark.parametrize("reorder", [False, True])
def test_solve_writes_checkpoints_then_resumes(tmp_path, reorder):
    from gnn_mwvc_tpu_torch.solver.checkpoint import (load_checkpoint,
                                                      resume_solve)

    # the quick peel leaves phase 2 most of the budget and a cover it
    # improves within a second, also on a loaded host
    g = build_road_graph(60)
    path = str(tmp_path / "run.npz")
    res = solve(g, time_limit=4.0, checkpoint_path=path,
                checkpoint_interval=0.0, device="cpu", reorder=reorder,
                scorer=QuickScorer())
    cover, meta = load_checkpoint(path, g)  # validates cover + fingerprint
    assert meta["cost"] == cover_cost(g, cover) >= res.cost
    _best, cost, _seen = resume_solve(g, path, time_limit=0.5)
    assert cost <= meta["cost"]


def test_solve_without_checkpoint_path_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    solve(random_graph(600, 8, seed=67), time_limit=0.5, device="cpu")
    assert os.listdir(tmp_path) == []


# -- metrics ------------------------------------------------------------------

def test_metrics_utils_and_solve_metrics(tmp_path):
    from gnn_mwvc_tpu_torch.utils import SolveMetrics, recording, span

    with recording() as rec:
        for _ in range(2):
            with span("a"):
                pass
    with span("x"):  # no recorder: a profiler annotation only
        pass
    assert rec.as_dict()["a"]["calls"] == 2 and "x" not in rec.as_dict()

    sink = str(tmp_path / "m.jsonl")
    m = SolveMetrics(sink=sink)
    res = solve(build_road_graph(30), time_limit=0, device="cpu", metrics=m)
    out = m.summary(cost=res.cost)
    assert len(out["rounds"]) == res.phase1["rounds"] >= 1
    # sticky rounds plus the rounds scored per snapshot (every round on
    # the CPU), as the JAX scorer counts them
    assert out["scorer"]["rounds"] + out["scorer"]["legacy_rounds"] == \
        res.phase1["rounds"]
    assert sum(r["decisions"] for r in out["rounds"]) > 0
    # the solve's spans, each round's score and peel among them
    assert out["phases"] and out["phases"] == res.phase1["spans"]
    assert out["phases"]["peel"]["calls"] == res.phase1["rounds"]
    assert sum(r["seconds_peel"] for r in out["rounds"]) == pytest.approx(
        out["phases"]["peel"]["seconds"])
    with open(sink) as f:
        line = json.loads(f.readline())
    assert line["cost"] == res.cost and line["phases"] == out["phases"]


# -- mwvc-tools ---------------------------------------------------------------

MTX = (b"%%MatrixMarket matrix coordinate pattern symmetric\n"
       b"% a comment\n12 12 19\n" + b"".join(
           b"%d %d\n" % (u, v) for u, v in
           [(2, 1), (3, 1), (4, 2), (5, 3), (6, 4), (6, 5), (7, 6), (8, 7),
            (9, 8), (10, 9), (11, 10), (12, 11), (12, 1), (5, 5), (7, 3),
            (9, 2), (10, 4), (11, 6), (12, 8)]))


def _tools_outputs(main, d, capsys):
    """Run the five subcommands in ``d``; returns the files and stdout."""
    mtx = os.path.join(d, "g.mtx")
    with open(mtx, "wb") as f:
        f.write(MTX)
    edge, red, metis = (os.path.join(d, x) for x in
                        ("g.graph", "g.red", "g.metis"))
    sol, is_sol, vc = (os.path.join(d, x) for x in
                       ("g.sol", "g.is", "g.vc"))
    rcs = [main(["gen-weights", mtx, edge, "1", "200", "-1"]),
           main(["gen-reduced", edge, red]),
           main(["mtx-to-graph", edge, metis])]
    write_solution(sol, np.ones(12, np.int8))
    rcs.append(main(["vc-validate", metis, sol]))
    write_solution(is_sol, np.eye(12, dtype=np.int8)[0])
    rcs.append(main(["is-to-vc", metis, is_sol, vc]))
    write_solution(sol, np.zeros(12, np.int8))
    rcs.append(main(["vc-validate", metis, sol]))   # not a cover: exit 1
    files = {}
    for p in (edge, red, metis, vc):
        with open(p, "rb") as f:
            files[os.path.basename(p)] = f.read()
    return rcs, files, capsys.readouterr().out.replace(d, "<dir>")


def test_tools_outputs_equal_jax(tmp_path, capsys):
    from gnn_mwvc_tpu.graphio.cli import main as jax_main
    from gnn_mwvc_tpu_torch.graphio.cli import main

    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got = _tools_outputs(main, str(tmp_path / "port"), capsys)
    want = _tools_outputs(jax_main, str(tmp_path / "jax"), capsys)
    assert got[0] == want[0] == [0, 0, 0, 0, 0, 1]
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert b"12 " in got[1]["g.metis"][:8]


def test_read_mtx_and_gen_weights_equal_jax():
    import io

    from gnn_mwvc_tpu.graphio import gen_weights as jax_gen
    from gnn_mwvc_tpu.graphio import read_mtx_edges as jax_read
    from gnn_mwvc_tpu_torch.graphio import gen_weights, read_mtx_edges

    dense = (b"%%MatrixMarket matrix array real symmetric\n3 3\n"
             b"0\n1.5\n0\n0\n2\n0\n")
    for data in (MTX, dense):
        n, e, v = read_mtx_edges(io.BytesIO(data), with_values=True)
        n0, e0, v0 = jax_read(io.BytesIO(data), with_values=True)
        assert n == n0
        np.testing.assert_array_equal(e, e0)
        np.testing.assert_array_equal(v, v0)
        for seed in (-1, 9):
            g, g0 = gen_weights(n, e, 1, 50, seed), jax_gen(n0, e0, 1, 50, seed)
            np.testing.assert_array_equal(g.weights, g0.weights)
            np.testing.assert_array_equal(g.indices, g0.indices)


# -- mwvc-baseline ------------------------------------------------------------

# The time-bounded baselines stop at a wall-clock cutoff, so how far a search
# gets depends on the host's load.  On 18 vertices every one reaches the
# optimum long before the cutoff; both packages are held to it.
SMALL = dict(n=18, deg=4, seed=31, wmax=40)


def _optimum(g):
    """Brute-force minimum cover weight over all 2^n vertex subsets."""
    s = np.arange(1 << g.n, dtype=np.int64)
    ok = np.ones(len(s), bool)
    for u, v in g.edge_array():
        ok &= ((s >> u) | (s >> v)) & 1 == 1
    cost = ((s[:, None] >> np.arange(g.n)) & 1) @ g.weights.astype(np.int64)
    return int(cost[ok].min())


@pytest.mark.parametrize("solver", ["fastwvc", "numwvc", "hils",
                                    "fastwvc-tuned"])
def test_baseline_cli_cost_equals_jax(tmp_path, capsys, solver):
    from gnn_mwvc_tpu.solver.baselines.cli import main as jax_main
    from gnn_mwvc_tpu_torch.solver.baselines.cli import main

    g = random_graph(SMALL["n"], SMALL["deg"], seed=SMALL["seed"],
                     wmax=SMALL["wmax"])
    path = str(tmp_path / "b.metis")
    write_metis(path, g)
    # hils stops at its iteration count, well inside its cutoff
    extra = ["-i", "20000"] if solver == "hils" else []
    cutoff = "30" if solver == "hils" else "0.3"
    out = []
    for fn in (main, jax_main):
        assert fn([solver, path, "3", cutoff, *extra,
                   "--out", str(tmp_path / "b.sol")]) == 0
        line = capsys.readouterr().out.strip().splitlines()[-1].split(",")
        sol = read_solution(str(tmp_path / "b.sol"))
        cost = int(line[2] if solver == "hils" else line[1])
        assert is_vertex_cover(g, sol) and cover_cost(g, sol) == cost
        out.append(cost)
    assert out[0] == out[1] == _optimum(g)


def test_baseline_solve_equals_jax_at_a_fixed_seed():
    from gnn_mwvc_tpu import core as jax_core
    from gnn_mwvc_tpu_torch import core

    g = random_graph(SMALL["n"], SMALL["deg"], seed=SMALL["seed"] + 1,
                     wmax=SMALL["wmax"])
    opt = _optimum(g)
    for which in ("fastwvc", "dynwvc2", "numwvc"):
        a = core.baseline_solve(which, g.weights, g.edge_array(), seed=5,
                                cutoff=0.3)
        b = jax_core.baseline_solve(which, g.weights, g.edge_array(), seed=5,
                                    cutoff=0.3)
        assert a[0] == b[0] == opt, which
    # hils is bounded by iterations: the same work, so the same cover
    g = random_graph(80, 5, seed=32, wmax=60)
    a = core.baseline_solve("hils", g.weights, g.edge_array(), seed=5,
                            cutoff=30.0, iterations=5000)
    b = jax_core.baseline_solve("hils", g.weights, g.edge_array(), seed=5,
                                cutoff=30.0, iterations=5000)
    assert a[0] == b[0]
    np.testing.assert_array_equal(a[1], b[1])


# -- mwvc-batch and mwvc-bench ----------------------------------------------

def test_batch_cli_solves_a_list(tmp_path, capsys):
    from gnn_mwvc_tpu_torch.solver.batch import main

    paths = []
    for name, g in (("ra", random_graph(300, 6, seed=41)),
                    ("rb", build_road_graph(20))):
        paths.append(str(tmp_path / f"{name}.metis"))
        write_metis(paths[-1], g)
    lst = tmp_path / "list.txt"
    lst.write_text(paths[1] + "\n")
    out_dir = tmp_path / "out"
    assert main([paths[0], "--list", str(lst), "--out", str(out_dir),
                 "--time", "0.5", "--device", "cpu", "--json"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    rows = [json.loads(ln) for ln in lines if ln.startswith("{")]
    assert [r["name"] for r in rows[:2]] == ["ra", "rb"]
    assert rows[2]["instances"] == 2
    assert rows[2]["total_cost"] == rows[0]["cost"] + rows[1]["cost"]
    for r, g in zip(rows[:2], (random_graph(300, 6, seed=41),
                               build_road_graph(20))):
        sol = read_solution(r["solution"])
        assert is_vertex_cover(g, sol) and cover_cost(g, sol) == r["cost"]
    assert any(ln.startswith("ra,") for ln in lines)


def test_batch_quick_no_reorder_equals_jax_phase1(tmp_path, capsys):
    from gnn_mwvc_tpu.solver.batch import main as jax_main
    from gnn_mwvc_tpu_torch.solver.batch import main

    path = str(tmp_path / "q.metis")
    write_metis(path, random_graph(500, 8, seed=42))
    costs = []
    for fn, extra in ((main, ["--device", "cpu"]), (jax_main, [])):
        assert fn([path, "--out", str(tmp_path / "o"), "--time", "0",
                   "--quick", "--no-reorder", *extra]) == 0
        costs.append(capsys.readouterr().out.strip().split(",")[1])
    assert costs[0] == costs[1]


def test_bench_cli_rows(tmp_path, capsys, monkeypatch):
    from gnn_mwvc_tpu_torch.solver import benchmark

    monkeypatch.setattr(benchmark, "REF_BIN", str(tmp_path / "no_refs"))
    path = benchmark.make_suite("quick", str(tmp_path))[1]  # road90
    assert os.path.basename(path) == "road90.metis"
    assert benchmark.main([path, "--time", "0.5", "--device", "cpu",
                           "--json", "--solvers",
                           "gnn,quick,approx,fastwvc,ref:GNN_VC"]) == 0
    (row,) = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["graph"] == "road90" and row["n"] == 8100
    assert row["ref:GNN_VC"] is None
    for s in ("gnn", "quick", "approx", "fastwvc"):
        assert row[s]["cost"] > 0, s
    assert row["gnn"]["cost"] <= row["approx"]["cost"] * 1.05


@pytest.mark.parametrize("surface", ["batch", "bench", "cli"])
def test_surfaces_default_to_cuda_and_refuse_without_it(tmp_path, surface,
                                                        monkeypatch):
    """No surface quietly runs on the CPU when CUDA is asked for (the
    default) and absent."""
    from gnn_mwvc_tpu_torch.solver import batch, benchmark, cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = str(tmp_path / "g.metis")
    write_metis(path, random_graph(50, 4, seed=1))
    argv = {"batch": [path, "--out", str(tmp_path)],
            "bench": [path, "--solvers", "gnn"],
            "cli": [path, str(tmp_path / "g.sol"), "1"]}[surface]
    main = {"batch": batch.main, "bench": benchmark.main,
            "cli": cli.main}[surface]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(argv)
