"""The port's native relabel and CPU forward, against the JAX package's.

``Graph.reorder`` goes through the shared core's ``relabel_csr``; the
port's ``GnnScorer(native=True)`` and the sticky scorer's per-snapshot
rounds on the CPU go through its ``cpu_forward_native``, as the JAX
scorers' do.  So on the CPU the port's per-round scores are the JAX
package's bit for bit, and so are its phase-1 covers.
"""

import types

import numpy as np
import pytest
import torch

import bench
from gnn_mwvc_tpu.core import cpu_forward_native as jax_cpu_forward
from gnn_mwvc_tpu.graphio import is_vertex_cover as jax_is_cover
from gnn_mwvc_tpu.core.api import _pack_model as jax_pack_model
from gnn_mwvc_tpu.core import relabel_csr as jax_relabel_csr
from gnn_mwvc_tpu.core import cluster_order as jax_cluster_order
from gnn_mwvc_tpu.models import load_pretrained as jax_load_pretrained
from gnn_mwvc_tpu.models.gnn import Model as JaxModel
from gnn_mwvc_tpu.solver.pipeline import confidence_order
from gnn_mwvc_tpu.solver.pipeline import solve as jax_solve
from gnn_mwvc_tpu.solver.static_score import StickyGnnScorer as JaxSticky
from gnn_mwvc_tpu_torch.core import (CoreSolver, cluster_order,
                                     cpu_forward_native, relabel_csr)
from gnn_mwvc_tpu_torch.core.api import _pack_model
from gnn_mwvc_tpu_torch.graph import DeviceGraph, Graph, reorder_plain
from gnn_mwvc_tpu_torch.graphio import cover_cost, is_vertex_cover
from gnn_mwvc_tpu_torch.models import (MWVCModel, build_reference_arch,
                                       init_params, params_to_jax,
                                       pretrained_model)
from gnn_mwvc_tpu_torch.parallel import make_mesh
from gnn_mwvc_tpu_torch.solver.pipeline import GnnScorer, solve
from gnn_mwvc_tpu_torch.solver.sharded_score import ShardedGnnScorer
from gnn_mwvc_tpu_torch.solver.static_score import StickyGnnScorer
from tests.conftest import random_graph

GRAPHS = {
    "road60": lambda: bench.build_road_graph(60),
    "road80": lambda: bench.build_road_graph(80),
    "road150": lambda: bench.build_road_graph(150),
    "road240s1": lambda: bench.build_road_graph(240, seed=1),
    "er1500": lambda: random_graph(1500, 14, seed=5, wmax=500),
}


def _port(gj):
    return Graph(gj.weights, gj.edge_array())


def _pair(name):
    gj = GRAPHS[name]()
    return gj, _port(gj)


def _snapshots(g, count=3):
    """``count`` kernel snapshots of ``g``'s peel, one per round (the JAX
    native forward's scores drive the peel)."""
    model = jax_load_pretrained()
    ws = float(g.weights.max())
    core = CoreSolver(g.weights, g.edge_array())
    core.reduce()
    snaps = []
    while len(snaps) < count:
        core.solve_small_components(75)
        if core.active_count == 0:
            break
        snap = core.snapshot()
        snaps.append(snap)
        prob = jax_cpu_forward(snap, model, ws)
        order = confidence_order(prob, snap.weights, snap.deg)
        core.reset_label_count()
        core.peel(snap.ids[order], prob[order], -1)
    return snaps, ws


@pytest.mark.parametrize("name", ["road60", "er1500"])
def test_reorder_is_jax_reorder_and_the_numpy_relabel(name):
    gj, g = _pair(name)
    perm = cluster_order(g.indptr, g.indices)
    np.testing.assert_array_equal(perm, jax_cluster_order(gj.indptr,
                                                          gj.indices))
    ours, ref, plain = g.reorder(perm), gj.reorder(perm), reorder_plain(g, perm)
    for other in (ref, plain):
        assert (ours.n, ours.m) == (other.n, other.m)
        np.testing.assert_array_equal(ours.weights, other.weights)
        for a in ("indptr", "indices"):
            x, y = getattr(ours, a), getattr(other, a)
            assert x.dtype == y.dtype == np.int64
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(ours.edge_array(), ref.edge_array())
    out = relabel_csr(g.indptr, g.indices, perm)
    for x, y in zip(out, jax_relabel_csr(gj.indptr, gj.indices, perm)):
        np.testing.assert_array_equal(x, y)


def test_relabel_csr_refuses_a_non_permutation():
    g = Graph(np.ones(4, np.int64), np.array([[0, 1], [1, 2], [2, 3]]))
    for perm in ([0, 1, 1, 3], [0, 1, 2], [0, 1, 2, 4]):
        with pytest.raises(ValueError, match="permutation"):
            relabel_csr(g.indptr, g.indices, perm)


@pytest.mark.parametrize("name", ["road60", "er1500"])
def test_from_csr_and_neighborhood_weights_are_jax(name):
    gj, g = _pair(name)
    ours = Graph.from_csr(g.weights, g.indptr, g.indices)
    ref = type(gj).from_csr(gj.weights, gj.indptr, gj.indices)
    assert (ours.n, ours.m) == (ref.n, ref.m) == (g.n, g.m)
    for a in ("indptr", "indices", "weights"):
        np.testing.assert_array_equal(getattr(ours, a), getattr(ref, a))
    for x in (ours, g):
        nw = x.neighborhood_weights
        assert nw.dtype == np.int64 and x.neighborhood_weights is nw
        np.testing.assert_array_equal(nw, gj.neighborhood_weights)


def test_neighborhood_weights_sum_exactly_past_float32():
    w = np.array([2**31 - 1, 2**31 - 3, 2**30 + 1, 5], np.int64)
    g = Graph(w, np.array([[0, 1], [0, 2], [0, 3], [1, 2]]))
    assert g.neighborhood_weights[0] == int(w[1]) + int(w[2]) + int(w[3])
    assert g.neighborhood_weights[2] == int(w[0]) + int(w[1])


@pytest.mark.parametrize("name", ["road80", "road150"])
def test_cpu_forward_native_is_jax_bitwise(name):
    """Three kernel snapshots: bitwise the JAX native forward, within 2e-5
    of the port's torch forward."""
    gj, g = _pair(name)
    snaps, ws = _snapshots(g)
    assert len(snaps) == 3
    model, jmodel = pretrained_model(), jax_load_pretrained()
    for a, b in zip(_pack_model(model), jax_pack_model(jmodel)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    torch_scorer = GnnScorer(model, "cpu")
    for snap in snaps:
        ours = cpu_forward_native(snap, model, ws)
        assert ours.dtype == np.float32 and ours.shape == (snap.n,)
        np.testing.assert_array_equal(ours, jax_cpu_forward(snap, jmodel, ws))
        np.testing.assert_array_equal(
            ours, cpu_forward_native(snap, model, ws, n_threads=1))
        np.testing.assert_allclose(ours, torch_scorer(snap, ws), atol=2e-5,
                                   rtol=0)


def test_pack_model_follows_in_place_changes():
    """The packed blobs are kept on the model and packed again after an
    optimiser step, an in-place edit, ``load_state_dict`` and a replaced
    parameter; each time the native forward is the JAX one of the same
    parameters, and within 2e-5 of the torch forward."""
    (snap,), ws = _snapshots(_port(bench.build_road_graph(40)), 1)
    model = pretrained_model()
    keep = []  # the JAX cache keys by id(model): keep every JAX model alive

    def check():
        ours = cpu_forward_native(snap, model, ws)
        jm = JaxModel(kinds=model.kinds, params=params_to_jax(model))
        keep.append(jm)
        np.testing.assert_array_equal(ours, jax_cpu_forward(snap, jm, ws))
        np.testing.assert_allclose(ours, GnnScorer(model, "cpu")(snap, ws),
                                   atol=2e-5, rtol=0)
        return ours

    first = check()
    packed = _pack_model(model)
    assert _pack_model(model) is packed

    dg = DeviceGraph.build(snap.weights, snap.indptr, snap.indices, "cpu",
                           nw=snap.nw)
    opt = torch.optim.SGD(model.parameters(), lr=0.01)
    x = (dg.weights / ws).reshape(-1, 1)
    out = model(x, dg, ws, x_is_node_weights=True)[:, 0]
    (out - 0.5).square().mean().backward()
    opt.step()
    trained = check()
    assert _pack_model(model) is not packed
    assert np.abs(trained - first).max() > 1e-4

    with torch.no_grad():
        model.linears[-1].bias.add_(0.5)
    edited = check()
    assert (edited >= trained).all() and (edited > trained).any()

    model.load_state_dict(init_params(
        MWVCModel(*build_reference_arch()), seed=3).state_dict())
    check()
    model.linears[0].weight = torch.nn.Parameter(
        torch.zeros_like(model.linears[0].weight))
    check()


def test_pack_model_sees_a_parameter_replaced_twice():
    """The pack cache holds the parameters themselves: a parameter
    replaced twice between packs packs again, even when its second
    replacement has the version of the first parameter (0) and is made
    at the address that parameter would leave free."""
    model = pretrained_model()
    shape = model.linears[-1].bias.shape
    model.linears[-1].bias = torch.nn.Parameter(torch.full(shape, 1.0))
    first = id(model.linears[-1].bias)
    assert model.linears[-1].bias._version == 0
    assert _pack_model(model)[2][-1] == 1.0
    model.linears[-1].bias = torch.nn.Parameter(torch.full(shape, -1.0))
    for _ in range(1000):
        second = torch.nn.Parameter(torch.full(shape, 2.0))
        if id(second) == first:
            break
    model.linears[-1].bias = second
    assert second._version == 0
    assert _pack_model(model)[2][-1] == 2.0


def test_pack_model_refuses_layers_wider_than_the_native_rows():
    kinds = ("graph", "linear", "relu", "linear", "sigmoid")
    with pytest.raises(ValueError, match="36 columns"):
        _pack_model(MWVCModel(kinds, [(5, 40), (40, 1)]))
    with pytest.raises(ValueError, match="arrive"):
        _pack_model(MWVCModel(kinds, [(4, 8), (8, 1)]))


def test_gnn_scorer_routes_by_min_edges_and_native(monkeypatch):
    """``GnnScorer`` has no ``min_edges`` host route: it scores every
    snapshot on its device.  On a CPU device that is the C++ forward with
    ``native=True``, else the torch forward; on a card (a CUDA device
    object, the forward stubbed) ``native`` changes nothing."""
    (snap,), ws = _snapshots(_port(bench.build_road_graph(40)), 1)
    model = pretrained_model()
    native = cpu_forward_native(snap, model, ws)
    torch_cpu = GnnScorer(model, "cpu")(snap, ws)
    np.testing.assert_array_equal(
        GnnScorer(model, "cpu", native=True)(snap, ws), native)
    assert not np.array_equal(torch_cpu, native)
    np.testing.assert_allclose(torch_cpu, native, atol=2e-5, rtol=0)
    assert not GnnScorer(model, "cpu", native=True, compat=False).native
    with pytest.raises(TypeError):
        GnnScorer(model, "cpu", min_edges=1 << 40)

    import gnn_mwvc_tpu_torch.solver.static_score as static_score

    class CardGraph:
        @staticmethod
        def build(weights, indptr, indices, device):
            assert torch.device(device).type == "cuda"
            return types.SimpleNamespace(n=len(weights))

    monkeypatch.setattr(static_score, "DeviceGraph", CardGraph)
    monkeypatch.setattr(static_score, "score_graph",
                        lambda m, dg, w, compat: torch.full((dg.n,), -1.0))
    monkeypatch.setattr(static_score, "cpu_forward_native", None)
    for native_flag in (False, True):
        sc = GnnScorer(model, "cpu", native=native_flag)
        sc.device = torch.device("cuda")  # as on a card; nothing runs there
        assert (sc(snap, ws) == -1).all()


def test_scorers_pick_the_native_forward_as_jax():
    """The sticky scorer's per-snapshot rounds are native (JAX
    ``static_score.py:345-349``); the sharded scorer's on a CPU mesh are
    not (JAX ``sharded_score.py:290-296``)."""
    g = _port(bench.build_road_graph(30))
    ws = float(g.weights.max())
    for scorer, native in ((StickyGnnScorer(device="cpu"), True),
                           (ShardedGnnScorer(mesh=make_mesh(
                               2, devices=["cpu", "cpu"]), min_nodes=1 << 30),
                            False)):
        core = CoreSolver(g.weights, g.edge_array())
        core.reduce()
        scorer.score_core(core, ws)
        assert scorer.stats["legacy_rounds"] == 1
        assert scorer._snapshot_scorer.native is native


@pytest.mark.parametrize("name", ["road60", "road240s1", "er1500"])
def test_solve_on_the_cpu_is_jax_bitwise(name):
    """``solve(time_limit=0)`` on the CPU with the default sticky scorer:
    every round's scores bitwise the JAX package's, the same peel, and the
    same cover, up to the first fold the port's core refuses.  On road240
    (seed 1) the JAX package's core folds a dependent neighbourhood twice
    in the peel, after the kernel was taken, and its cover is invalid: the
    port's scores are the JAX ones up to the round whose peel meets the
    first such fold, its kernel is the same, and its cover is valid with no
    kernel edge left open.  On road60 and er1500 no fold is refused."""
    gj, g = _pair(name)
    rounds = {}

    def recording(scorer, tag):
        real = scorer.score_core

        def score_core(core, ws):
            out = real(core, ws)
            rounds.setdefault(tag, []).append(
                (np.array(out[0]), np.array(out[1]),
                 getattr(core, "dependent_folds", 0)))
            return out

        scorer.score_core = score_core
        return scorer

    ref = jax_solve(gj, time_limit=0, device_assist=False,
                    scorer=recording(JaxSticky(warm_overlap=False), "jax"))
    res = solve(g, time_limit=0, device="cpu", device_assist=False,
                scorer=recording(StickyGnnScorer(device="cpu"), "port"))
    refused = res.phase1["dependent_folds"]
    assert res.phase1["kernel_edges_uncovered"] == 0
    assert len(rounds["port"]) == res.phase1["rounds"]
    # rounds scored before any refused fold (the count only grows): the
    # JAX package's, bitwise
    same = [r for r in rounds["port"] if r[2] == 0]
    assert len(same) >= 1
    for (ids_t, p_t, _), (ids_j, p_j, _) in zip(same, rounds["jax"]):
        np.testing.assert_array_equal(ids_t, ids_j)
        np.testing.assert_array_equal(p_t, p_j)
    assert (res.kernel_size, res.initial_cost) == (ref.kernel_size,
                                                   ref.initial_cost)
    assert is_vertex_cover(g, res.solution)
    assert res.cost == cover_cost(g, res.solution)
    if name != "road240s1":
        assert refused == 0 and len(same) == len(rounds["jax"])
        np.testing.assert_array_equal(res.solution, ref.solution)
        assert res.cost == ref.cost
        return
    assert refused >= 1 and len(same) < len(rounds["port"])
    assert not jax_is_cover(gj, ref.solution)


def test_solve_reorder_records_the_cluster_time_as_jax():
    """``solve(reorder=True)``: the cover (mapped back to the input's ids)
    is the JAX one; the relabel's time is its span (the JAX scorer's
    ``t_cluster_s``), and the scorer's stats under ``phase1["scorer"]``
    hold counts only."""
    gj, g = _pair("road60")
    js = JaxSticky(warm_overlap=False)
    ref = jax_solve(gj, time_limit=0, device_assist=False, reorder=True,
                    scorer=js)
    ts = StickyGnnScorer(device="cpu")
    res = solve(g, time_limit=0, device="cpu", device_assist=False,
                reorder=True, scorer=ts)
    np.testing.assert_array_equal(res.solution, ref.solution)
    assert res.cost == ref.cost
    assert "t_cluster_s" in js.stats
    relabel = res.phase1["spans"]["relabel"]
    assert relabel["calls"] == 1 and relabel["seconds"] > 0
    assert res.phase1["scorer"] == ts.stats == {
        "rebuilds": 0, "rounds": 0, "legacy_rounds": res.phase1["rounds"]}
    plain = solve(g, time_limit=0, device="cpu", device_assist=False,
                  scorer=StickyGnnScorer(device="cpu"))
    assert "relabel" not in plain.phase1["spans"]
