"""How the port's phase-1 scorers route rounds, against the JAX package's.

The JAX ``StickyGnnScorer`` scores a round per snapshot once the live kernel
holds fewer than ``tpu_min_edges`` directed edges, and on every round
without an accelerator; the JAX ``ShardedGnnScorer`` does so below
``min_nodes`` active nodes; ``gnn-vc`` scores every round per snapshot with
``GnnScorer``.  Each test drives both packages through the same peel (two
native cores, the JAX side's confidence order applied to both) and asserts
the same routing, round by round, and scores within 1e-5 (2e-5 on the mesh).

On the CPU the port's sticky scorer routes every round per snapshot, as the
JAX one does without an accelerator.  To reach the threshold itself the
threshold test marks both scorers as accelerated (the port's
``_accelerated``, the JAX ``_tpu_dev``), on the CPU.
"""

import json

import jax
import numpy as np
import pytest

import bench
from gnn_mwvc_tpu.core import CoreSolver as JaxCore
from gnn_mwvc_tpu.parallel import make_mesh as jax_make_mesh
from gnn_mwvc_tpu.solver.pipeline import confidence_order
from gnn_mwvc_tpu.solver.sharded_score import \
    ShardedGnnScorer as JaxShardedScorer
from gnn_mwvc_tpu.solver.static_score import StickyGnnScorer as JaxSticky
from gnn_mwvc_tpu_torch.core import CoreSolver
from gnn_mwvc_tpu_torch.graph import Graph
from gnn_mwvc_tpu_torch.graphio import read_solution, write_metis
from gnn_mwvc_tpu_torch.parallel import make_mesh
from gnn_mwvc_tpu_torch.solver import ShardedGnnScorer
from gnn_mwvc_tpu_torch.solver import pipeline
from gnn_mwvc_tpu_torch.solver.static_score import StickyGnnScorer
from tests.conftest import random_graph


def _peel_in_step(gj, js, ts, atol):
    """Peel two cores of ``gj`` in step, the JAX scorer's order for both;
    returns, per round, (JAX per snapshot, port per snapshot, live edges)."""
    ws = float(gj.weights.max())
    cj = JaxCore(gj.weights, gj.edge_array())
    ct = CoreSolver(gj.weights, gj.edge_array())
    cj.reduce()
    ct.reduce()
    routes = []
    while True:
        cj.solve_small_components(75)
        ct.solve_small_components(75)
        assert ct.active_count == cj.active_count
        if cj.active_count == 0:
            break
        live = ct.live_edges()
        assert live == cj.live_edges()
        lj, lt = js.stats["legacy_rounds"], ts.stats["legacy_rounds"]
        ids_j, p_j, w_j, d_j = js.score_core(cj, ws)
        ids_t, p_t, w_t, d_t = ts.score_core(ct, ws)
        routes.append((js.stats["legacy_rounds"] - lj,
                       ts.stats["legacy_rounds"] - lt, live))
        oj, ot = np.argsort(ids_j), np.argsort(ids_t)
        np.testing.assert_array_equal(ids_t[ot], ids_j[oj])
        np.testing.assert_array_equal(w_t[ot], w_j[oj])
        np.testing.assert_array_equal(d_t[ot], d_j[oj])
        np.testing.assert_allclose(p_t[ot], p_j[oj], atol=atol, rtol=0)
        order = confidence_order(p_j, w_j, d_j)
        for core in (cj, ct):
            core.reset_label_count()
            core.peel(ids_j[order], p_j[order].astype(np.float32), -1)
    assert ct.cost == cj.cost
    return routes


def test_sticky_routes_below_the_live_edge_threshold_as_jax(monkeypatch):
    """road100 peeled with a threshold its live edges cross mid-peel: the
    rounds above it sticky, the rounds below per snapshot, on both sides."""
    gj = bench.build_road_graph(100)
    threshold = 40_000
    js = JaxSticky(tpu_min_edges=threshold, warm_overlap=False)
    monkeypatch.setattr(js, "_tpu_dev", js._cpu_dev)
    monkeypatch.setattr(js, "_note_device_round", lambda *a: True)
    ts = StickyGnnScorer(device="cpu", min_live_edges=threshold)
    ts._accelerated = True
    routes = _peel_in_step(gj, js, ts, atol=1e-5)
    assert [r[0] for r in routes] == [r[1] for r in routes]
    assert [r[1] for r in routes] == [int(r[2] < threshold) for r in routes]
    assert 0 < ts.stats["legacy_rounds"] < len(routes)
    assert ts.stats["legacy_rounds"] == js.stats["legacy_rounds"]
    assert ts.stats["rounds"] == js.stats["rounds"] > 0


@pytest.mark.parametrize("name", ["road60", "er1500"])
def test_sticky_routes_every_round_on_the_cpu_as_jax(name):
    """Without an accelerator both sticky scorers score every round per
    snapshot, at any size; ``force_sticky`` keeps the port's sticky."""
    gj = (bench.build_road_graph(60) if name == "road60"
          else random_graph(1500, 14, seed=5, wmax=500))
    js = JaxSticky(warm_overlap=False)
    ts = StickyGnnScorer(device="cpu", min_live_edges=0)
    routes = _peel_in_step(gj, js, ts, atol=1e-5)
    assert all(r[:2] == (1, 1) for r in routes)
    assert ts.stats["rounds"] == js.stats["rounds"] == 0
    assert ts.stats["legacy_rounds"] == len(routes) >= 1

    forced = StickyGnnScorer(device="cpu", force_sticky=True)
    core = CoreSolver(gj.weights, gj.edge_array())
    core.reduce()
    forced.score_core(core, float(gj.weights.max()))
    assert forced.stats["rounds"] == 1 and forced.stats["legacy_rounds"] == 0


@pytest.fixture(scope="module")
def mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jax_make_mesh(8)


@pytest.mark.parametrize("min_nodes", ["auto", 1500])
def test_sharded_min_nodes_routes_as_jax(mesh8, min_nodes):
    """road60 on an 8-shard CPU mesh: "auto" is 0 on a CPU mesh (every
    round on the mesh, the sticky scorer's CPU routing does not apply);
    1500 sends the rounds under 1500 active nodes per snapshot on both
    sides."""
    gj = bench.build_road_graph(60)
    js = JaxShardedScorer(mesh=mesh8, min_nodes=min_nodes)
    ts = ShardedGnnScorer(mesh=make_mesh(8, devices=["cpu"] * 8),
                          min_nodes=min_nodes)
    assert ts.min_nodes == js.min_nodes == (0 if min_nodes == "auto"
                                            else 1500)
    routes = _peel_in_step(gj, js, ts, atol=2e-5)
    assert [r[0] for r in routes] == [r[1] for r in routes]
    assert ts.stats["legacy_rounds"] == js.stats["legacy_rounds"]
    if min_nodes == "auto":
        assert ts.stats["legacy_rounds"] == 0
    else:
        assert 0 < ts.stats["legacy_rounds"] < len(routes)


def test_cli_scores_with_gnn_scorer_as_gnn_vc(tmp_path, monkeypatch, capsys):
    """``gnn-vc-torch`` without --quick or --shards passes a ``GnnScorer``
    to ``solve()`` and writes the cover ``gnn-vc`` writes."""
    from gnn_mwvc_tpu.solver.cli import main as jax_main
    from gnn_mwvc_tpu_torch.solver.cli import main

    gj = bench.build_road_graph(60)
    g = Graph(gj.weights, gj.edge_array())
    path = str(tmp_path / "g.metis")
    write_metis(path, g)
    seen = []
    solve = pipeline.solve

    def spy(*args, **kw):
        seen.append(kw.get("scorer"))
        return solve(*args, **kw)

    monkeypatch.setattr(pipeline, "solve", spy)
    ours, ref = str(tmp_path / "port.sol"), str(tmp_path / "jax.sol")
    assert main([path, ours, "0", "-1", "0", "--device", "cpu",
                 "--json"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    (scorer,) = seen
    assert type(scorer) is pipeline.GnnScorer
    assert scorer.device.type == "cpu"
    # GnnScorer's own stats: every round scored per snapshot, no sticky ones
    sc = rec["phase1"]["scorer"]
    assert rec["phase1"]["rounds"] >= 2 and sc["rounds"] == \
        rec["phase1"]["rounds"] and "legacy_rounds" not in sc
    assert jax_main([path, ref, "0", "-1", "0"]) == 0
    np.testing.assert_array_equal(read_solution(ours), read_solution(ref))


def test_solve_covers_an_edge_the_peel_leaves_open():
    """road240 (seed 1), every round per snapshot: the JAX package's copy
    of the native core folds a dependent neighbourhood in the peel, leaves
    a kernel edge with both endpoints out, and its solve writes that
    invalid cover.  The port's copy refuses those folds and counts them:
    its solve writes a valid cover with no kernel edge left open, so
    ``cover_uncovered_edges`` adds nothing."""
    from gnn_mwvc_tpu.graphio import is_vertex_cover as jax_is_cover
    from gnn_mwvc_tpu.solver.pipeline import GnnScorer as JaxGnnScorer
    from gnn_mwvc_tpu.solver.pipeline import solve as jax_solve
    from gnn_mwvc_tpu_torch.graphio import cover_cost, is_vertex_cover

    gj = bench.build_road_graph(240, seed=1)
    g = Graph(gj.weights, gj.edge_array())
    ref = jax_solve(gj, time_limit=0, scorer=JaxGnnScorer(),
                    device_assist=False)
    res = pipeline.solve(g, time_limit=0, scorer=pipeline.GnnScorer(
        device="cpu"), device="cpu", device_assist=False)
    assert not jax_is_cover(gj, ref.solution)
    assert is_vertex_cover(g, res.solution)
    assert res.phase1["kernel_edges_uncovered"] == 0
    assert res.phase1["dependent_folds"] >= 1
    assert res.cost == cover_cost(g, res.solution)


def test_cover_uncovered_edges_adds_the_lighter_endpoint():
    edges = np.array([[0, 1], [1, 2], [2, 3], [3, 4]])
    cover = np.array([0, 0, 0, 1, 0], np.uint8)
    w = np.array([5, 3, 3, 1, 1], np.uint64)
    assert pipeline.cover_uncovered_edges(cover, edges, w) == 1
    np.testing.assert_array_equal(cover, [0, 1, 0, 1, 0])
    assert pipeline.cover_uncovered_edges(cover, edges, w) == 0
