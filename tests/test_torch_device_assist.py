"""The port's phase-2 device assist on the CPU (K4's plain version): a
region batch round-trips, its exact solves patch improvements back, and
the cover stays valid."""

import numpy as np
import pytest
import torch

from gnn_mwvc_tpu_torch.core import CoreLocalSearch
from gnn_mwvc_tpu_torch.ops.smallsolve import batched_small_mwvc
from gnn_mwvc_tpu_torch.ops.smallsolve_mitm import (small_mwvc_mitm,
                                                    small_mwvc_mitm_plain)
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


# ``apply_regions`` (one native call a batch) against the per-region loop
# of ``apply_region`` calls that the assist made before it.

def _loop_apply(ls, ids, ks, masks):
    """One ``apply_region`` call per non-empty row, in row order; a row
    counts as wide when its patch flips more than 16 vertices of the cover
    read before the loop.  Returns (applied rows, wide count)."""
    cur = ls.current()
    rows, wide = [], 0
    for i in np.nonzero(ks)[0]:
        k = int(ks[i])
        new = (int(masks[i]) >> np.arange(k)) & 1
        flips = int((cur[ids[i, :k]] != new).sum())
        if ls.apply_region(k, ids[i, :k], int(masks[i])):
            rows.append(int(i))
            wide += flips > 16
    return rows, wide


def _rows_taken(before, after, ids, ks, masks):
    """The non-empty rows whose mask the cover holds after and not before:
    the rows applied, since a row equal to the cover cannot improve it."""
    rows = []
    for i in np.nonzero(ks)[0]:
        k = int(ks[i])
        new = (int(masks[i]) >> np.arange(k)) & 1
        region = ids[i, :k]
        if (after[region] == new).all() and (before[region] != new).any():
            rows.append(int(i))
    return rows


def _assert_same_state(a, b):
    assert a.cost == b.cost and a.steps == b.steps
    np.testing.assert_array_equal(a.current(), b.current())
    np.testing.assert_array_equal(a.dscores(), b.dscores())
    assert a.best_cost == b.best_cost
    np.testing.assert_array_equal(a.best(), b.best())


@pytest.mark.parametrize("rmax", [14, 20])
def test_apply_regions_equals_the_apply_region_loop(rmax):
    """The same extracted batches (K4's plain version answering), applied
    through a loop of ``apply_region`` and through ``apply_regions``, take
    the same rows and leave the same cover, cost, dscores, best cover, and
    the same search after them."""
    g = random_graph(800, 6, seed=21, wmax=100)
    e = g.edge_array()
    a = CoreLocalSearch(g.weights, e, np.ones(g.n, np.uint8))   # the loop
    b = CoreLocalSearch(g.weights, e, np.ones(g.n, np.uint8))   # one call
    rng = np.random.default_rng(rmax)
    applied_in_all = 0
    for _ in range(6):
        # centres drawn with repeats and close together: later ones are
        # claimed by earlier regions, so the batch has empty rows
        centers = rng.integers(0, g.n, size=64).astype(np.uint32)
        ids, adj, w, ks = a.extract_regions(centers, rmax=rmax)
        for x, y in zip((ids, adj, w, ks), b.extract_regions(centers, rmax)):
            np.testing.assert_array_equal(x, y)
        assert (ks == 0).any() and (ks > 0).any()
        _bc, bs = small_mwvc_mitm_plain(torch.from_numpy(adj),
                                        torch.from_numpy(w))
        masks = bs.numpy()
        before = b.current()
        rows, wide = _loop_apply(a, ids, ks, masks)
        assert b.apply_regions(ids, ks, masks) == (len(rows), wide)
        assert _rows_taken(before, b.current(), ids, ks, masks) == rows
        if rows:
            assert a.commit_patches() == b.commit_patches()
        _assert_same_state(a, b)
        applied_in_all += len(rows)
        a.search(300, 60.0)
        b.search(300, 60.0)
        _assert_same_state(a, b)
    assert applied_in_all >= 1
    inc = b.dscores().copy()
    b.rebuild_scores()
    np.testing.assert_array_equal(inc, b.dscores())


def _three_stars():
    """Star A: centre 0 and 19 leaves, the leaves in the cover; stars B
    (centre 20) and C (centre 30): 9 leaves each, every vertex in the
    starting cover (the local search drops their centres, which cover no
    edge alone).  Centres weigh 1, leaves 100."""
    w = np.full(40, 100, np.uint32)
    w[[0, 20, 30]] = 1
    edges = np.array([[c, c + i] for c, k in ((0, 20), (20, 10), (30, 10))
                      for i in range(1, k)], np.uint32)
    s0 = np.ones(40, np.uint8)
    s0[0] = 0
    return w, edges, s0


def test_apply_regions_rejects_an_uncovering_row_and_counts_a_wide_one():
    """Row 0 (star A, its centre alone) flips all 20 vertices: applied and
    counted wide.  Row 1 is empty, with a mask that is never read.  Row 2
    (star B, nothing in the cover) would uncover its edges: rejected.  Row
    3 (star C, its centre alone) flips 10: applied, not wide."""
    w, edges, s0 = _three_stars()
    ids = np.zeros((4, 20), np.uint32)
    ids[0] = np.arange(20)
    ids[2, :10] = np.arange(20, 30)
    ids[3, :10] = np.arange(30, 40)
    ks = np.array([20, 0, 10, 10], np.uint8)
    masks = np.array([1, -1, 0, 1], np.int32)
    a = CoreLocalSearch(w, edges, s0)
    b = CoreLocalSearch(w, edges, s0)
    cost0 = b.cost
    assert _loop_apply(a, ids, ks, masks) == ([0, 3], 1)
    assert b.apply_regions(ids, ks, masks) == (2, 1)
    assert cost0 - b.cost == 19 * 100 - 1 + 9 * 100 - 1
    assert a.commit_patches() and b.commit_patches()
    _assert_same_state(a, b)
    cur = b.current().astype(bool)
    assert (cur[edges[:, 0]] | cur[edges[:, 1]]).all()
    assert cur[[0, 30]].all() and cur[21:30].all()
    assert not cur[1:21].any() and not cur[31:].any()
    inc = b.dscores().copy()
    b.rebuild_scores()
    np.testing.assert_array_equal(inc, b.dscores())


class _LoopApply:
    """A local search whose ``apply_regions`` is the reference loop."""

    def __init__(self, ls):
        self.ls = ls

    def __getattr__(self, name):
        return getattr(self.ls, name)

    def apply_regions(self, ids, ks, masks):
        rows, wide = _loop_apply(self.ls, ids, ks, masks)
        return len(rows), wide


def test_assist_stats_equal_the_reference_loop():
    """The assist at a fixed seed, then between search batches as in phase
    2, with ``apply_regions`` and with the reference loop: the same patches,
    gain, commits and wide patches, and the same search state.  The stars'
    vertices are the misfits, so the first batches take them in whole and
    patch star A wide."""
    g = random_graph(500, 6, seed=15, wmax=100)
    w3, e3, _s0 = _three_stars()
    w = np.concatenate([g.weights, w3]).astype(np.uint32)
    edges = np.concatenate([g.edge_array(), e3 + g.n]).astype(np.uint32)
    prob = np.full(len(w), 0.99, np.float32)
    prob[g.n:] = 0.0
    runs = []
    for wrap in (lambda ls: ls, _LoopApply):
        core = CoreLocalSearch(w, edges, np.ones(len(w), np.uint8))
        ls = wrap(core)
        assist = DeviceAssist(prob, device="cpu", batch=16, rmax=20, seed=3,
                              pool_mult=2)
        for i in range(10):
            assist.tick(ls)
            if i >= 2:
                ls.search(200, 60.0)
        assist.stop()
        runs.append((core, {k: v for k, v in assist.stats.items()
                            if not k.startswith("t_")}))
    (a, stats_a), (b, stats_b) = runs
    assert stats_a == stats_b
    assert stats_a["patches"] >= 1 and stats_a["wide_patches"] >= 1
    _assert_same_state(a, b)
