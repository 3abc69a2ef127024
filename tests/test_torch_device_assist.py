"""The port's phase-2 device assist on the CPU (K4's plain version): a
region batch round-trips, its exact solves patch improvements back, and
the cover stays valid."""

import numpy as np
import pytest
import torch

from gnn_mwvc_tpu_torch.core import CoreLocalSearch
from gnn_mwvc_tpu_torch.ops.smallsolve import batched_small_mwvc
from gnn_mwvc_tpu_torch.ops.smallsolve_mitm import small_mwvc_mitm
from gnn_mwvc_tpu_torch.solver.device_assist import DeviceAssist
from tests.conftest import random_graph


@pytest.mark.parametrize("rmax", [14, 20])
def test_assist_round_trip_patches_an_all_in_cover(rmax):
    g = random_graph(600, 6, seed=9, wmax=80)
    ls = CoreLocalSearch(g.weights, g.edge_array(), np.ones(g.n, np.uint8))
    cost0 = ls.cost
    assist = DeviceAssist(np.full(g.n, 0.5, np.float32), device="cpu",
                          batch=16, rmax=rmax)
    assert assist.tick(ls) == 0          # dispatch only
    applied = assist.tick(ls)            # collect (CPU: already solved)
    assist.stop()
    assert assist.stats["batches"] == 1
    assert applied == assist.stats["patches"] >= 1
    assert assist.stats["gain"] == cost0 - ls.cost > 0
    cur = ls.current().astype(bool)
    e = g.edge_array()
    assert (cur[e[:, 0]] | cur[e[:, 1]]).all()


def test_centre_pool_is_seeded_and_prefers_misfits():
    g = random_graph(500, 6, seed=3, wmax=50)
    prob = np.full(g.n, 0.99, np.float32)
    prob[:50] = 0.0                      # strong misfits while in the cover
    pools = []
    for _ in range(2):
        ls = CoreLocalSearch(g.weights, g.edge_array(),
                             np.ones(g.n, np.uint8))
        a = DeviceAssist(prob, device="cpu", batch=8, pool_mult=4, seed=5)
        a._refill_pool(ls)
        pools.append(a._pool.copy())
    np.testing.assert_array_equal(pools[0], pools[1])
    cover = ls.current().astype(bool)
    assert cover[pools[0]].all()         # centres are cover vertices
    share = cover[:50].sum() / cover.sum()  # the misfits' share of the cover
    assert (pools[0] < 50).mean() > 3 * share


# The JAX package's assist tests (tests/test_device_assist.py) that do not
# concern its relay worker, on the port's bindings and in-process assist.

def _path_ls():
    # path 0-1-2-3-4 with heavy endpoints in the cover; optimum is {1, 3}
    w = np.array([10, 1, 10, 1, 10], np.uint32)
    edges = np.array([[0, 1], [1, 2], [2, 3], [3, 4]], np.uint32)
    return CoreLocalSearch(w, edges, np.array([1, 0, 1, 0, 1], np.uint8))


def test_extract_region_boundary_forcing():
    """A region vertex with an outside non-cover neighbour carries a
    self-loop bit (forced into the cover), and the exact solve keeps it."""
    w = np.array([5, 1, 1, 1, 1], np.uint32)
    edges = np.array([[0, 1], [0, 2], [0, 3], [0, 4]], np.uint32)
    ls = CoreLocalSearch(w, edges, np.array([1, 0, 0, 0, 0], np.uint8))
    ids, adj, wts, k = ls.extract_regions(np.array([0], np.uint32), rmax=2)
    kk = int(k[0])
    assert kk == 2
    i0 = int(np.where(ids[0][:kk] == 0)[0][0])
    assert adj[0][i0] & (1 << i0)
    _bc, bs = batched_small_mwvc(torch.from_numpy(adj), torch.from_numpy(wts))
    assert int(bs[0]) & (1 << i0)


def test_extract_regions_disjoint_within_batch():
    g = random_graph(500, 8, seed=1, wmax=50)
    ls = CoreLocalSearch(g.weights, g.edge_array(), np.ones(g.n, np.uint8))
    centers = np.arange(0, 500, 7, dtype=np.uint32)
    ids, _adj, _wts, k = ls.extract_regions(centers, rmax=12)
    seen = set()
    for i in range(len(centers)):
        for v in ids[i][:int(k[i])]:
            assert int(v) not in seen
            seen.add(int(v))


def test_apply_region_rejects_uncovering_and_nonimproving():
    ls = _path_ls()
    ids, adj, wts, k = ls.extract_regions(np.array([0], np.uint32), rmax=16)
    kk = int(k[0])
    assert not ls.apply_region(kk, ids[0][:kk], 0)   # uncovers every edge
    cur_mask = sum(1 << i for i in range(kk) if ls.current()[ids[0][i]])
    assert not ls.apply_region(kk, ids[0][:kk], cur_mask)  # no gain
    bc, bs = batched_small_mwvc(torch.from_numpy(adj), torch.from_numpy(wts))
    assert ls.apply_region(kk, ids[0][:kk], int(bs[0]))
    assert ls.cost == int(bc[0]) == 2
    assert ls.commit_patches()
    assert ls.best_cost == 2


def test_apply_region_incremental_dscores_exact():
    """After a batch of patches the incrementally kept dscores equal a
    rebuild from scratch."""
    g = random_graph(600, 8, seed=9, wmax=50)
    ls = CoreLocalSearch(g.weights, g.edge_array(), np.ones(g.n, np.uint8))
    ls.search(20000, 5.0)
    centers = np.arange(0, g.n, 11, dtype=np.uint32)
    ids, adj, wts, ks = ls.extract_regions(centers, rmax=12)
    _bc, bs = batched_small_mwvc(torch.from_numpy(adj), torch.from_numpy(wts))
    applied = sum(bool(int(ks[i]) and ls.apply_region(
        int(ks[i]), ids[i, :int(ks[i])], int(bs[i])))
        for i in range(len(centers)))
    assert applied >= 1
    inc = ls.dscores().copy()
    ls.rebuild_scores()
    np.testing.assert_array_equal(inc, ls.dscores())


def test_perturb_guided_respects_bias_and_seed():
    g = random_graph(400, 6, seed=3, wmax=20)
    s0 = np.ones(g.n, np.uint8)
    bias = np.ones(g.n, np.float32)
    bias[:200] = 0.0    # a protected prefix: never removed
    runs = []
    for _ in range(2):
        ls = CoreLocalSearch(g.weights, g.edge_array(), s0)
        ls.search(2000, 5.0)
        cover = ls.current().copy()
        ls.perturb_guided(30, 42, bias)
        cur = ls.current()
        assert (cur[:200] >= cover[:200]).all()
        runs.append(cur)
    np.testing.assert_array_equal(runs[0], runs[1])


@pytest.mark.parametrize("rmax,batch", [(14, 32), (20, 16)])
def test_assist_round_trips_until_it_patches(rmax, batch):
    g = random_graph(800 if rmax == 14 else 400, 8 if rmax == 14 else 6,
                     seed=5 if rmax == 14 else 15, wmax=100)
    ls = CoreLocalSearch(g.weights, g.edge_array(), np.ones(g.n, np.uint8))
    assist = DeviceAssist(np.full(g.n, 0.5, np.float32), device="cpu",
                          batch=batch, rmax=rmax)
    try:
        for _ in range(4):
            assist.tick(ls)
        assert assist.stats["batches"] >= 1
        assert assist.stats["patches"] >= 1
        assert assist.stats["gain"] > 0
    finally:
        assist.stop()


def test_solve_device_assist_end_to_end():
    from gnn_mwvc_tpu_torch.graph import Graph
    from gnn_mwvc_tpu_torch.graphio import cover_cost, is_vertex_cover
    from gnn_mwvc_tpu_torch.solver.pipeline import solve

    gj = random_graph(3000, 12, seed=2, wmax=500)
    g = Graph(gj.weights, gj.edge_array())
    # phase 1 (model load included) leaves the assist phase 2 time, also
    # on a loaded host
    res = solve(g, time_limit=5.0, device="cpu", device_assist=True,
                assist_batch=32, assist_rmax=16)
    assert is_vertex_cover(g, res.solution)
    assert cover_cost(g, res.solution) == res.cost
    assert res.assist_stats is not None and res.assist_stats["batches"] >= 1
    res0 = solve(g, time_limit=5.0, device="cpu", device_assist=False)
    assert res.cost <= res0.cost * 1.01


def test_extract_regions_width20():
    """rmax > 16 extracts (B, 20) instances whose exact solves (K4's plain
    version) patch back, and the cover stays a cover."""
    g = random_graph(600, 6, seed=9, wmax=80)
    ls = CoreLocalSearch(g.weights, g.edge_array(), np.ones(g.n, np.uint8))
    centers = np.arange(0, 600, 31, dtype=np.uint32)
    ids, adj, wts, k = ls.extract_regions(centers, rmax=20)
    assert adj.shape[1] == 20 and wts.shape[1] == 20
    assert int(k.max()) > 16
    _bc, bs = small_mwvc_mitm(torch.from_numpy(adj), torch.from_numpy(wts))
    applied = sum(bool(int(k[i]) and ls.apply_region(
        int(k[i]), ids[i][:int(k[i])], int(bs[i])))
        for i in range(len(centers)))
    assert applied >= 1
    ls.commit_patches()
    cur = ls.current().astype(bool)
    e = g.edge_array()
    assert (cur[e[:, 0]] | cur[e[:, 1]]).all()
