"""The port's device reduction prepass against the JAX package's: the same
stats, the same reduced core, and exact covers after the host finishes."""

import numpy as np
import pytest
import torch

import bench
from gnn_mwvc_tpu import core as jax_core
from gnn_mwvc_tpu.graph import Graph as JaxGraph
from gnn_mwvc_tpu.solver.device_reduce import (
    device_reduce_prepass as jax_prepass)
from gnn_mwvc_tpu_torch.core import CoreSolver
from gnn_mwvc_tpu_torch.graphio import cover_cost, is_vertex_cover
from gnn_mwvc_tpu_torch.ops import rules
from gnn_mwvc_tpu_torch.solver.device_reduce import device_reduce_prepass
from tests.conftest import random_graph
from tests.test_core import brute_force_mwvc, small_random

SNAPSHOT_FIELDS = ("ids", "weights", "nw", "deg", "indptr", "indices")


def _stars(n=4000, seed=0):
    """Heavy centres with ~19 light leaves: r1 fires on the device."""
    rng = np.random.default_rng(seed)
    edges = [(c, leaf) for c in range(0, n, 20)
             for leaf in range(c + 1, min(c + 20, n))]
    w = rng.integers(1, 10, size=n)
    w[::20] = 1000
    return JaxGraph(w, np.array(edges))


def _twins():
    edges = []
    for i in range(0, 200, 2):
        a, b = 200 + (i % 100), 200 + ((i + 7) % 100)
        edges += [(i, a), (i, b), (i + 1, a), (i + 1, b)]
    return JaxGraph(np.full(300, 7), np.unique(np.array(edges), axis=0))


def _r5_heavy(seed=7):
    """Heavy vertices whose light neighbourhoods are nearly independent:
    r5 fires."""
    rng = np.random.default_rng(seed)
    edges, n = [], 600
    for c in range(0, n, 6):
        edges += [(c, leaf) for leaf in range(c + 1, min(c + 4, n))]
        if c + 4 < n:
            edges.append((c + 1, c + 4))
    w = rng.integers(1, 8, size=n)
    w[::6] = 40
    return JaxGraph(w, np.unique(np.array(edges), axis=0))


def _r5_units(units=200):
    """Vertex u (weight 15) joined to a triangle of weight-10 vertices:
    NW(u) = 30 > W(u), so r1 does not fire, but W(u) >= NW(u) - VC(N(u))
    = 30 - 20, so r5 does.  Consecutive triangles share an edge so the
    units form one component."""
    edges, w = [], []
    for k in range(units):
        u, a, b, c = 4 * k, 4 * k + 1, 4 * k + 2, 4 * k + 3
        edges += [(u, a), (u, b), (u, c), (a, b), (a, c), (b, c)]
        if k:
            edges.append((c - 4, a))
        w += [15, 10, 10, 10]
    return JaxGraph(np.array(w), np.unique(np.array(edges), axis=0))


GRAPHS = {
    "stars": _stars,
    "r5_units": _r5_units,
    "twins": _twins,
    "r5_heavy": _r5_heavy,
    "road60": lambda: bench.build_road_graph(60),
    "er1500": lambda: random_graph(1500, 6, seed=21, wmax=200),
}


def _assert_same_core(ours, ref):
    assert (ours.active_count, ours.cost, ours.n_nodes, ours.timestamp) == (
        ref.active_count, ref.cost, ref.n_nodes, ref.timestamp)
    np.testing.assert_array_equal(ours.counters, ref.counters)
    a, b = ours.snapshot(), ref.snapshot()
    for field in SNAPSHOT_FIELDS:
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field),
                                      err_msg=field)


@pytest.mark.parametrize("with_r5", [True, False])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_prepass_equals_jax(name, with_r5):
    g = GRAPHS[name]()
    ours = CoreSolver(g.weights, g.edge_array())
    ref = jax_core.CoreSolver(g.weights, g.edge_array())
    rules.calls.clear()
    got = device_reduce_prepass(ours, min_nodes=0, device="cpu",
                                with_r5=with_r5)
    want = jax_prepass(ref, min_nodes=0, with_r5=with_r5)
    assert got == want
    assert rules.calls["rule_masks/cpu"] == got["rounds"]
    assert rules.calls["r5_candidates/cpu"] == (got["rounds"] if with_r5
                                                else 0)
    _assert_same_core(ours, ref)
    ours.reduce()
    ref.reduce()
    _assert_same_core(ours, ref)


def test_prepass_fires_every_rule():
    fired = {name: device_reduce_prepass(
        CoreSolver(GRAPHS[name]().weights, GRAPHS[name]().edge_array()),
        min_nodes=0, device="cpu")
        for name in ("stars", "twins", "r5_units")}
    assert fired["stars"]["r1_applied"] > 100
    assert fired["twins"]["twins_applied"] > 10
    assert fired["r5_units"]["r5_applied"] > 100


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_prepass_preserves_exactness(seed):
    g = small_random(14, 0.3, seed)
    core = CoreSolver(g.weights, g.edge_array())
    device_reduce_prepass(core, min_nodes=0, device="cpu")
    core.reduce(critical=True)
    core.solve_small_components(75)
    assert core.active_count == 0
    core.unfold(0)
    sol = core.solution()
    assert is_vertex_cover(g, sol)
    assert cover_cost(g, sol) == core.cost == brute_force_mwvc(g)


@pytest.mark.parametrize("name", ["stars", "twins", "r5_heavy", "r5_units"])
def test_prepassed_core_unfolds_to_a_valid_cover(name):
    g = GRAPHS[name]()
    core = CoreSolver(g.weights, g.edge_array())
    device_reduce_prepass(core, min_nodes=0, max_rounds=2, device="cpu")
    core.reduce(critical=False)
    core.solve_small_components(400)
    core.unfold(0)
    sol = core.solution()
    assert is_vertex_cover(g, sol)
    assert cover_cost(g, sol) == core.cost


def test_prepass_stops_below_min_nodes():
    g = GRAPHS["stars"]()
    core = CoreSolver(g.weights, g.edge_array())
    stats = device_reduce_prepass(core, device="cpu")  # min_nodes 50,000
    assert stats == {"rounds": 0, "r1_applied": 0, "twins_applied": 0,
                     "r5_applied": 0}


def test_prepass_on_cuda_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = GRAPHS["twins"]()
    core = CoreSolver(g.weights, g.edge_array())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device_reduce_prepass(core, min_nodes=0)
    assert core.counters.sum() == 0  # nothing ran on the host instead
