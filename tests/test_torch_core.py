"""The port's own native-core bindings against the JAX package's.

Both bind the same C++ sources but for the port's two repairs; the port
compiles its copy into its own ``_build/`` directory.  Same inputs, same
calls: the arrays must be equal, except where the JAX copy folds a
dependent neighbourhood, which the port's copy refuses.
"""

import os

import numpy as np
import pytest
import torch

import bench
from gnn_mwvc_tpu import core as jax_core
from gnn_mwvc_tpu_torch import core
from gnn_mwvc_tpu_torch.core import api
from gnn_mwvc_tpu_torch.ops import rules
from tests.conftest import random_graph
from tests.test_torch_core_exact import (FAULT_SEEDS, branch_mwvc, covers,
                                         exact_solve, gadget_graph,
                                         random_peel)

GRAPHS = {"road60": lambda: bench.build_road_graph(60),
          "er800": lambda: random_graph(800, 6, seed=11, wmax=300)}
SNAPSHOT_FIELDS = ("ids", "weights", "nw", "deg", "indptr", "indices")


def test_library_is_built_into_the_port():
    core.CoreSolver(np.ones(2), np.array([[0, 1]]))
    build_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(core.__file__))), "_build")
    assert os.path.dirname(api.LIB_PATH) == build_dir
    assert os.path.exists(api.LIB_PATH)


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("num_rules", [3, 7])
def test_reduce_and_snapshot_equal_jax(name, num_rules):
    gj = GRAPHS[name]()
    ours = core.CoreSolver(gj.weights, gj.edge_array(), num_rules=num_rules)
    ref = jax_core.CoreSolver(gj.weights, gj.edge_array(), num_rules=num_rules)
    ours.reduce()
    ref.reduce()
    assert (ours.active_count, ours.cost, ours.n_nodes, ours.timestamp) == (
        ref.active_count, ref.cost, ref.n_nodes, ref.timestamp)
    np.testing.assert_array_equal(ours.counters, ref.counters)
    a, b = ours.snapshot(), ref.snapshot()
    for field in SNAPSHOT_FIELDS:
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field),
                                      err_msg=field)


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("rmax", [16, 20])
def test_extract_regions_equal_jax(name, rmax):
    gj = GRAPHS[name]()
    rng = np.random.default_rng(3)
    cover = np.ones(gj.n, np.uint8)
    cover[rng.random(gj.n) < 0.3] = 0
    u, v = gj.edge_array().T
    cover[u[(cover[u] == 0) & (cover[v] == 0)]] = 1   # repair to a cover
    ours = core.CoreLocalSearch(gj.weights, gj.edge_array(), cover)
    ref = jax_core.CoreLocalSearch(gj.weights, gj.edge_array(), cover)
    centers = rng.choice(np.nonzero(cover)[0], size=256).astype(np.uint32)
    got = ours.extract_regions(centers, rmax=rmax)
    want = ref.extract_regions(centers, rmax=rmax)
    assert int((got[3] > 0).sum()) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert ours.cost == ref.cost


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_orders_equal_jax(name):
    gj = GRAPHS[name]()
    rng = np.random.default_rng(4)
    prob = rng.random(gj.n).astype(np.float32)
    deg = np.diff(gj.indptr).astype(np.uint32)
    np.testing.assert_array_equal(
        core.confidence_order_native(prob, gj.weights, deg, 1e-4),
        jax_core.confidence_order_native(prob, gj.weights, deg, 1e-4))
    np.testing.assert_array_equal(
        core.cluster_order(gj.indptr, gj.indices),
        jax_core.cluster_order(gj.indptr, gj.indices))


def _pair(gj):
    return (core.CoreSolver(gj.weights, gj.edge_array()),
            jax_core.CoreSolver(gj.weights, gj.edge_array()))


def _same_state(ours, ref):
    assert (ours.active_count, ours.cost, ours.n_nodes, ours.timestamp) == (
        ref.active_count, ref.cost, ref.n_nodes, ref.timestamp)
    a, b = ours.snapshot(), ref.snapshot()
    for field in ("ids", "weights", "nw", "deg", "indptr", "indices"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    np.testing.assert_array_equal(ours.counters, ref.counters)
    np.testing.assert_array_equal(ours.preview_solution(),
                                  ref.preview_solution())
    ids = np.arange(ours.n_nodes, dtype=np.uint32)
    assert [ours.is_active(u) for u in ids] == [ref.is_active(u) for u in ids]


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_select_and_state_bindings_equal_jax(name):
    gj = GRAPHS[name]()
    ours, ref = _pair(gj)
    _same_state(ours, ref)
    rng = np.random.default_rng(5)
    live = [u for u in range(ours.n_nodes) if ours.is_active(u)]
    for u in rng.choice(live, size=6, replace=False):
        if not ours.is_active(int(u)):
            continue
        if u % 2:
            ours.select_node(int(u))
            ref.select_node(int(u))
        else:
            ours.select_neighborhood(int(u))
            ref.select_neighborhood(int(u))
        _same_state(ours, ref)
    ours.reduce()
    ref.reduce()
    _same_state(ours, ref)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_bulk_pass_bindings_equal_jax(name):
    gj = GRAPHS[name]()
    ours, ref = _pair(gj)
    snap = ours.snapshot()
    nw = snap.nw.astype(np.int64)
    ids = snap.ids
    r1 = ids[nw <= snap.weights]
    # r5 verdicts are applied unchecked, so they come from the r5 mask
    ell, ellv = rules.build_ell8(snap.indptr.astype(np.int64),
                                 snap.indices.astype(np.int64), snap.deg)
    r5 = ids[rules.r5_candidates(*[torch.from_numpy(a) for a in (
        ell, ellv, snap.weights.astype(np.int32), nw.astype(np.int32),
        snap.deg.astype(np.int32), np.ones(snap.n, bool))]).numpy()
        & (nw > snap.weights)]
    # candidate pairs of vertices with equal degree and NW (the core
    # re-checks twinness)
    key = snap.deg.astype(np.int64) << 40 | nw
    order = np.argsort(key, kind="stable")
    same = np.nonzero(key[order][1:] == key[order][:-1])[0]
    pairs = np.stack([ids[order][same], ids[order][same + 1]], 1)
    for c in (ours, ref):
        c.begin_bulk_pass()
    assert ours.bulk_r1(r1) == ref.bulk_r1(r1)
    assert ours.bulk_twins(pairs) == ref.bulk_twins(pairs)
    assert ours.bulk_r5(r5) == ref.bulk_r5(r5)
    _same_state(ours, ref)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_peel_model_counters_equal_jax(name):
    gj = GRAPHS[name]()
    ours, ref = _pair(gj)
    snap = ours.snapshot()
    prob = np.random.default_rng(6).random(snap.n).astype(np.float32)
    order = np.argsort(np.minimum(prob, 1 - prob), kind="stable")
    for c in (ours, ref):
        c.reset_label_count()
        c.peel(snap.ids[order], prob[order], -1)
    assert ours.labels_from_model == ref.labels_from_model > 0
    _same_state(ours, ref)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_mistakes_from_model_equal_jax(name):
    """A peel with random scores until the graph is empty: both bindings
    count the same skipped model labels."""
    gj = GRAPHS[name]()
    ours, ref = _pair(gj)
    rng = np.random.default_rng(8)
    while ours.active_count:
        snap = ours.snapshot()
        prob = rng.random(snap.n).astype(np.float32)
        order = np.argsort(np.minimum(prob, 1 - prob), kind="stable")
        for c in (ours, ref):
            c.peel(snap.ids[order], prob[order], -1)
        assert ours.mistakes_from_model == ref.mistakes_from_model
    assert ref.active_count == 0 and ours.labels_from_model > 0
    _same_state(ours, ref)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_bfs_order_equal_jax(name):
    gj = GRAPHS[name]()
    perm = core.bfs_order(gj.indptr, gj.indices)
    np.testing.assert_array_equal(perm, jax_core.bfs_order(gj.indptr,
                                                           gj.indices))
    assert perm.dtype == np.uint32
    np.testing.assert_array_equal(np.sort(perm), np.arange(gj.n))


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_constructions_and_dscores_equal_jax(name):
    gj = GRAPHS[name]()
    w, e = gj.weights, gj.edge_array()
    for fn in ("approx_cover", "greedy_cover"):
        (c0, v0), (c1, v1) = getattr(core, fn)(w, e), getattr(jax_core, fn)(w, e)
        assert c0 == c1, fn
        np.testing.assert_array_equal(v0, v1)
    start = np.ones(gj.n, np.uint8)
    c0, v0 = core.improve_cover(w, e, start)
    c1, v1 = jax_core.improve_cover(w, e, start.copy())
    assert c0 == c1 < int(w.sum())
    np.testing.assert_array_equal(v0, v1)
    assert start.all()  # the port leaves its input alone

    ours = core.CoreLocalSearch(w, e, start)
    ref = jax_core.CoreLocalSearch(w, e, start)
    ours.search(3000, 5.0)
    ref.search(3000, 5.0)
    np.testing.assert_array_equal(ours.dscores(), ref.dscores())
    inc = ours.dscores().copy()
    ours.rebuild_scores()
    np.testing.assert_array_equal(inc, ours.dscores())


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_node_arrays_and_live_edges_equal_jax(name):
    gj = GRAPHS[name]()
    ours, ref = _pair(gj)
    rng = np.random.default_rng(7)
    for stage in range(3):
        assert ours.live_edges() == ref.live_edges()
        for a, b in zip(ours.node_arrays(), ref.node_arrays()):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        if stage == 0:
            ours.reduce()
            ref.reduce()
        else:
            live = [u for u in range(ours.n_nodes) if ours.is_active(u)]
            for u in rng.choice(live, size=min(5, len(live)), replace=False):
                if ours.is_active(int(u)):
                    ours.select_node(int(u))
                    ref.select_node(int(u))
    act, _w, _nw, deg = ours.node_arrays()
    assert ours.live_edges() == int(deg[act.astype(bool)].sum())


@pytest.mark.parametrize("n,seed", FAULT_SEEDS)
def test_jax_core_faults_where_the_port_refuses_a_fold(n, seed):
    """The brute-force seeds: the JAX package's copy of the core folds a
    dependent neighbourhood and then leaves an edge open after the random
    peel, or writes an exact solve that is no cover (cheaper than the
    optimum).  The port's copy refuses that fold, and from the same calls
    gives a cover after the peel and the optimum after the exact solve."""
    g = gadget_graph(n, seed)
    opt = branch_mwvc(g)
    peeled = random_peel(jax_core.CoreSolver, g, seed).solution()
    exact = exact_solve(jax_core.CoreSolver, g)
    open_edge = not covers(g, peeled == 1)
    missed = not covers(g, exact.solution() == 1) or exact.cost != opt
    assert open_edge or missed
    ours = random_peel(core.CoreSolver, g, seed)
    assert covers(g, ours.solution() == 1) and ours.dependent_folds >= 1
    assert exact_solve(core.CoreSolver, g).cost == opt

