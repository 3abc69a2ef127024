"""The port's own copy of the native core, by brute force: reduction
exactness, undo round trips, local search, the incremental dscores that
patching keeps (the counterpart of ``tests/test_core.py``), and the
independent-neighbourhood fold that the copy refuses on a dependent
neighbourhood.

Only ``gnn_mwvc_tpu_torch.core`` and ``gnn_mwvc_tpu_torch.graph`` are used,
so ``gnn_mwvc_tpu_torch/core/sanitize.sh`` can run this file against a
sanitizer build of the port's sources (``--noconftest``: it loads neither
jax nor the JAX package).  The one exception, the meta rules' comparison
with the JAX package's core, imports that core inside the test and skips
where ``MWVC_CORE_LIB`` names a library, which both packages would load.
"""

import os

import numpy as np
import pytest

from gnn_mwvc_tpu_torch.core import (CoreLocalSearch, CoreSolver,
                                     confidence_order_native, greedy_cover)
from gnn_mwvc_tpu_torch.graph import (Graph, build_road_graph,
                                      geometric_graph, random_graph)


def covers(g: Graph, sel) -> bool:
    e = g.edge_array()
    sel = np.asarray(sel).astype(bool)
    return len(e) == 0 or bool(np.all(sel[e[:, 0]] | sel[e[:, 1]]))


def cost_of(g: Graph, sel) -> int:
    return int(g.weights[np.asarray(sel).astype(bool)].sum())


def brute_force_mwvc(g: Graph) -> int:
    best = None
    for s in range(1 << g.n):
        sel = (s >> np.arange(g.n)) & 1
        if covers(g, sel):
            c = cost_of(g, sel)
            if best is None or c < best:
                best = c
    return best


def small_random(n, p, seed, wmax=30):
    rng = np.random.default_rng(seed)
    edges = [(i, j) for i in range(n) for j in range(i + 1, n)
             if rng.random() < p]
    w = rng.integers(1, wmax, size=n)
    return Graph(w, np.array(edges if edges else np.zeros((0, 2), int)))


def full_exact_cost(g: Graph) -> int:
    """Reduce, solve the whole graph (< 75 nodes) exactly, unfold."""
    s = CoreSolver(g.weights, g.edge_array())
    s.reduce(critical=True)
    s.solve_small_components(75)
    assert s.active_count == 0
    s.unfold(0)
    sol = s.solution()
    assert (sol >= 0).all()
    assert covers(g, sol)
    assert cost_of(g, sol) == s.cost
    return s.cost


@pytest.mark.parametrize("seed", range(12))
def test_exactness_small(seed):
    g = small_random(min(6 + seed, 14), 0.3 + 0.04 * seed, seed)
    assert full_exact_cost(g) == brute_force_mwvc(g)


def test_exactness_ex3():
    """The reference README's 3-vertex example: vertex 3 alone, cost 20."""
    g = Graph(np.array([15, 15, 20]), np.array([(0, 2), (1, 2)]))
    assert full_exact_cost(g) == 20 == brute_force_mwvc(g)


def test_exactness_cliques_and_paths():
    # a clique of 5: the optimal cover is all but the heaviest vertex
    w = np.array([5, 9, 3, 7, 6])
    edges = [(i, j) for i in range(5) for j in range(i + 1, 5)]
    assert full_exact_cost(Graph(w, np.array(edges))) == int(w.sum() - w.max())
    path = Graph(np.array([4, 1, 5, 2, 6]),
                 np.array([(0, 1), (1, 2), (2, 3), (3, 4)]))
    assert full_exact_cost(path) == brute_force_mwvc(path)


@pytest.mark.parametrize("seed", range(6))
def test_undo_roundtrip(seed):
    g = small_random(20, 0.2, 100 + seed)
    s = CoreSolver(g.weights, g.edge_array())
    snap0 = s.snapshot()
    t0 = s.timestamp
    s.reduce(critical=True)
    s.unfold(t0)
    snap1 = s.snapshot()
    assert snap1.n == snap0.n
    for field in ("ids", "weights", "nw", "indptr", "indices"):
        np.testing.assert_array_equal(getattr(snap0, field),
                                      getattr(snap1, field), err_msg=field)


def test_counters_and_cost_track():
    g = small_random(30, 0.15, 7)
    s = CoreSolver(g.weights, g.edge_array())
    s.reduce(critical=True)
    assert s.counters.sum() > 0  # some rule fired on a random graph


def test_local_search_improves():
    g = small_random(60, 0.1, 42)
    ls = CoreLocalSearch(g.weights, g.edge_array(), np.ones(g.n, np.uint8))
    c0 = ls.best_cost  # after the redundancy drop
    assert c0 <= int(g.weights.sum())
    ls.search(200000, 5.0)
    best = ls.best()
    assert covers(g, best)
    assert cost_of(g, best) == ls.best_cost <= c0
    assert ls.best_seen <= ls.best_cost


def test_local_search_finds_optimum_small():
    # the best cover is snapshotted at the end of a batch: small batches
    for seed in (3, 5):
        g = small_random(12, 0.3, seed)
        opt = brute_force_mwvc(g)
        ls = CoreLocalSearch(g.weights, g.edge_array(),
                             np.ones(g.n, np.uint8))
        for _ in range(300):
            ls.search(1024, 1.0)
        assert ls.best_seen == ls.best_cost == opt
        assert covers(g, ls.best())


def test_peel_pipeline_smoke():
    """A score-free peel (heavier nodes out) yields a valid cover."""
    g = small_random(50, 0.15, 9)
    s = CoreSolver(g.weights, g.edge_array())
    s.reduce(critical=True)
    while s.active_count > 0:
        s.solve_small_components(75)
        if s.active_count == 0:
            break
        snap = s.snapshot()
        prob = (snap.weights < np.median(snap.weights)).astype(np.float32)
        order = np.argsort(prob)
        s.reset_label_count()
        s.peel(snap.ids[order], prob[order], relable_interval=-1)
    s.unfold(0)
    sol = s.solution()
    assert (sol >= 0).all()
    assert covers(g, sol)
    assert cost_of(g, sol) == s.cost


def test_local_search_forget_diversification():
    """Edge-weight forgetting keeps the cover valid and the best monotone."""
    g = random_graph(800, 8, seed=13, wmax=50)
    _cost, cover = greedy_cover(g.weights, g.edge_array())
    ls = CoreLocalSearch(g.weights, g.edge_array(), cover)
    ls.search(20000, 1.0)
    c1 = ls.best_cost
    ls.forget(0.3)
    ls.search(20000, 1.0)
    assert ls.best_cost <= c1
    assert covers(g, ls.best())


def best_assignments(adj, w, ks):
    """Each region's cheapest valid assignment, by enumerating every mask:
    a vertex left out needs all of its region neighbours in, and its
    self-loop bit (an outside neighbour not in the cover) forces it in."""
    best = np.zeros(len(ks), np.int64)
    for r, k in enumerate(ks):
        k = int(k)
        masks = np.arange(1 << k, dtype=np.int64)
        ok = np.ones(len(masks), bool)
        cost = np.zeros(len(masks), np.int64)
        for j in range(k):
            inside = (masks >> j) & 1 == 1
            ok &= inside | ((int(adj[r, j]) & ~masks) == 0)
            cost += np.where(inside, int(w[r, j]), 0)
        best[r] = masks[ok][np.argmin(cost[ok])] if k else 0
    return best


def test_incremental_dscores_match_rebuild():
    """Regions extracted from a searched cover and patched with their exact
    optima: after each batch the cover is valid at its stated cost, and
    the dscores kept incrementally equal a from-scratch rebuild."""
    g = random_graph(600, 6, seed=5, wmax=200)
    rng = np.random.default_rng(0)
    _cost, cover = greedy_cover(g.weights, g.edge_array())
    ls = CoreLocalSearch(g.weights, g.edge_array(), cover)
    ls.search(2000, 1.0)
    applied = 0
    for _ in range(4):
        centers = rng.choice(np.nonzero(ls.current())[0], 48, replace=False)
        ids, adj, w, ks = ls.extract_regions(centers, rmax=12)
        for i, mask in enumerate(best_assignments(adj, w, ks)):
            k = int(ks[i])
            applied += ls.apply_region(k, ids[i, :k], int(mask))
        ls.commit_patches()
        cur, ds, cost = ls.current(), ls.dscores(), ls.cost
        assert covers(g, cur) and cost_of(g, cur) == cost
        ls.rebuild_scores()
        np.testing.assert_array_equal(ls.dscores(), ds)
        assert ls.cost == cost
    assert applied > 0


def wide_star_patch():
    """A star of 20 vertices (centre 0 of weight 1, leaves of weight 100)
    with every leaf in the cover, patched to its centre alone: the patch
    flips all 20 vertices.  Returns the local search after the patch and
    whether it was applied."""
    k = 20
    w = np.array([1] + [100] * (k - 1), np.uint32)
    edges = np.array([[0, i] for i in range(1, k)], np.uint32)
    leaves = np.array([0] + [1] * (k - 1), np.uint8)
    ls = CoreLocalSearch(w, edges, leaves)
    assert ls.cost == 100 * (k - 1)
    return ls, ls.apply_region(k, np.arange(k, dtype=np.uint32), 1)


def test_patch_flipping_all_20_vertices_keeps_scores_exact():
    """A patch that flips more vertices than the JAX package's core can
    record (16) is applied in full, and what patching keeps incrementally
    equals a from-scratch rebuild."""
    ls, applied = wide_star_patch()
    assert applied
    ls.commit_patches()
    cur, ds, cost = ls.current(), ls.dscores(), ls.cost
    assert cost == ls.best_cost == 1
    np.testing.assert_array_equal(cur, [1] + [0] * 19)
    ls.rebuild_scores()
    np.testing.assert_array_equal(ls.current(), cur)
    np.testing.assert_array_equal(ls.dscores(), ds)
    assert ls.cost == cost


def gadget_graph(n, seed):
    """A small graph on which the core folds a fold gadget again.  Vertex 0
    has neighbours 1 and 2, with weights that fold it; 1 is adjacent to the
    largest id, 2 to the adjacent pair 5, 6; random sparse edges join
    3..n-1.  The fold of 0 gives a gadget whose list runs n - 1, 5, 6, ...:
    not sorted, so a sorted merge can miss the edge 5-6 inside it."""
    rng = np.random.default_rng(seed)
    p, q, big = 5, 6, n - 1
    edges = {(0, 1), (0, 2), (1, big), (2, p), (2, q), (p, q)}
    for _ in range(rng.integers(n // 2, 2 * n)):
        a, b = rng.integers(3, n, size=2)
        if a != b and {a, b} != {p, big} and {a, b} != {q, big}:
            edges.add((min(a, b), max(a, b)))
    w = rng.integers(1, rng.choice([10, 50, 200]), size=n)
    w[1] = rng.integers(100, 400)
    w[2] = rng.integers(100, 400)
    w[0] = rng.integers(max(w[1], w[2]), w[1] + w[2])
    return Graph(w, np.array(sorted(edges)))


def branch_mwvc(g: Graph) -> int:
    """Minimum cover weight by branching on a vertex of largest degree (it
    is in the cover, or all of its neighbours are), memoised on the set of
    vertices left: exact for the 40-vertex graphs here in well under 1 s."""
    adj = [0] * g.n
    for a, b in g.edge_array().tolist():
        adj[a] |= 1 << b
        adj[b] |= 1 << a
    w = [int(x) for x in g.weights]
    memo = {}

    def bits(mask):
        while mask:
            low = mask & -mask
            yield low.bit_length() - 1
            mask ^= low

    def best(alive):
        if alive in memo:
            return memo[alive]
        v = max(bits(alive), key=lambda x: (adj[x] & alive).bit_count(),
                default=0)
        nb = adj[v] & alive
        if not nb:
            return 0
        take_v = w[v] + best(alive & ~(1 << v))
        take_nb = sum(w[x] for x in bits(nb)) + best(alive & ~nb & ~(1 << v))
        memo[alive] = min(take_v, take_nb)
        return memo[alive]

    return best((1 << g.n) - 1)


def exact_solve(core_cls, g):
    """Reduce, solve every component exactly, unfold: the core."""
    s = core_cls(g.weights, g.edge_array())
    s.reduce(critical=True)
    s.solve_small_components(75)
    assert s.active_count == 0
    s.unfold(0)
    return s


def random_peel(core_cls, g, seed, components=False, after_reduce=None):
    """Reduce, then peel at seeded random scores in the pipeline's
    confidence order until nothing is left, and unfold: the core.  With
    ``components``, each round first solves the small components exactly,
    as the pipeline does.  ``after_reduce`` (a list) receives the live ids,
    cost and rule counters that the initial reduction leaves."""
    s = core_cls(g.weights, g.edge_array())
    s.reduce()
    if after_reduce is not None:
        after_reduce += [s.snapshot().ids, s.cost, s.counters]
    rng = np.random.default_rng(seed)
    while s.active_count > 0:
        if components:
            s.solve_small_components(75)
            if s.active_count == 0:
                break
        snap = s.snapshot()
        prob = rng.random(snap.n).astype(np.float32)
        order = confidence_order_native(prob, snap.weights, snap.deg, 1e-4)
        s.reset_label_count()
        s.peel(snap.ids[order], prob[order], -1)
    s.unfold(0)
    return s


# gadget_graph seeds (of 0-11,999 at n = 16, 24, 30, 36, 40) on which the
# JAX package's copy of the core folds a dependent neighbourhood and then
# leaves an edge open after random_peel or writes an invalid exact_solve
FAULT_SEEDS = [(16, 8366), (16, 9146), (24, 2523), (24, 2598), (30, 1076),
               (36, 252), (40, 245)]


@pytest.mark.parametrize("n,seed", FAULT_SEEDS)
def test_refused_fold_keeps_the_cover_valid_and_exact(n, seed):
    """Where the JAX copy folds a dependent neighbourhood, the port's
    refuses (and counts) the fold: its exact solve is the brute-force
    optimum and its peel's cover is valid."""
    g = gadget_graph(n, seed)
    exact = exact_solve(CoreSolver, g)
    sol = exact.solution()
    assert (sol >= 0).all() and covers(g, sol)
    assert cost_of(g, sol) == exact.cost == branch_mwvc(g)
    peeled = random_peel(CoreSolver, g, seed)
    sol = peeled.solution()
    assert (sol >= 0).all() and covers(g, sol)
    assert cost_of(g, sol) == peeled.cost
    assert exact.dependent_folds >= 1 and peeled.dependent_folds >= 1


@pytest.mark.parametrize("n", [12, 24, 32])
def test_gadget_graphs_solve_exactly(n):
    """The first 60 gadget_graph seeds at n vertices: exact solves equal to
    the brute-force optimum and peels that give covers (at 12 vertices the
    branching optimum is also held to the subset enumeration)."""
    for seed in range(60):
        if n == 12 and seed < 5:
            assert branch_mwvc(gadget_graph(n, seed)) == brute_force_mwvc(
                gadget_graph(n, seed))
        g = gadget_graph(n, seed)
        assert exact_solve(CoreSolver, g).cost == branch_mwvc(g), seed
        assert covers(g, random_peel(CoreSolver, g, seed).solution()), seed


def test_neighbors_independent_is_the_set_check_on_gadget_snapshots():
    """On three snapshots of a road60 (seed 1) peel, each holding fold
    gadgets: the order-free check is the set check for every live vertex.
    The sorted merge is never wrong when it answers dependent, but it
    passes some dependent neighbourhoods, each of a gadget or of a vertex
    with two gadget neighbours (a sorted list meets a sorted list)."""
    g = build_road_graph(60, seed=1)
    core = CoreSolver(g.weights, g.edge_array())
    core.reduce()
    rng = np.random.default_rng(0)
    passed = 0
    for _ in range(3):
        snap = core.snapshot()
        gadget = snap.ids >= g.n
        assert gadget.any()
        nbrs = [set(snap.indices[snap.indptr[i]:snap.indptr[i + 1]].tolist())
                for i in range(snap.n)]
        for i, u in enumerate(snap.ids.tolist()):
            independent = not any(nbrs[i] & nbrs[v] for v in nbrs[i])
            assert core.neighbors_independent(u) is independent
            merge = core.neighbors_independent(u, exact=False)
            assert merge or not independent
            if merge and not independent:
                assert gadget[i] or gadget[list(nbrs[i])].sum() >= 2
                passed += 1
        prob = rng.random(snap.n).astype(np.float32)
        core.reset_label_count()
        core.peel(snap.ids, prob, -1)
    assert passed >= 1


def unit_geometric():
    g = geometric_graph(1 << 12, seed=3)
    return Graph(np.ones(g.n, np.int64), g.edge_array())


# The meta rules decide from weight bounds where those settle the test, and
# solve the small instance only where they do not; the JAX package's core
# solves every one.  Graphs whose initial reduction and peel give the same
# live ids, cost and counters in both (the port refuses no fold on them);
# at unit weights no neighbour is heavier, so every bound ties.
META_JAX_GRAPHS = {
    "road40": lambda: build_road_graph(40),
    "road80": lambda: build_road_graph(80),
    "geometric4096": lambda: geometric_graph(1 << 12, seed=3),
    "random2000_w200": lambda: random_graph(2000, 14, seed=7, wmax=200),
    "unit_geometric4096": unit_geometric,
}
# Gadget graphs on which the port refuses a fold, so the JAX core differs:
# (live count, cost, counters) after the initial reduction and (cost,
# counters) after random_peel, as the core gave before the meta rules'
# bounds (seed 0 of random_peel's scores).
META_PINNED = {
    "gadget40_245": (gadget_graph(40, 245), (
        7, 806, [13, 0, 2, 2, 0, 12, 4, 0], 903, [15, 1, 2, 2, 0, 12, 4, 0])),
    "gadget24_2598": (gadget_graph(24, 2598), (
        8, 1071, [1, 0, 0, 0, 0, 8, 7, 0], 1595, [6, 0, 0, 0, 0, 8, 7, 0])),
}


@pytest.mark.parametrize("name", sorted(META_JAX_GRAPHS) + sorted(
    META_PINNED))
def test_meta_rule_bounds_keep_every_decision(name):
    """The initial reduction and a whole peel decide as the meta rules do
    without their weight bounds: against the JAX package's core where the
    port refuses no fold, else against the counts pinned before the
    bounds."""
    if name in META_PINNED:
        g, (live, cost, counters, peel_cost, peel_counters) = (
            META_PINNED[name])
        after = []
        s = random_peel(CoreSolver, g, 0, after_reduce=after)
        assert (len(after[0]), after[1]) == (live, cost)
        assert after[2].tolist() == counters
        assert (s.cost, s.counters.tolist()) == (peel_cost, peel_counters)
        assert s.dependent_folds >= 1
        return
    if os.environ.get("MWVC_CORE_LIB"):
        pytest.skip("MWVC_CORE_LIB: both packages would load that library")
    from gnn_mwvc_tpu import core as jax_core

    g = META_JAX_GRAPHS[name]()
    mine, theirs = [], []
    s = random_peel(CoreSolver, g, 0, components=True, after_reduce=mine)
    r = random_peel(jax_core.CoreSolver, g, 0, components=True,
                    after_reduce=theirs)
    assert s.dependent_folds == 0
    np.testing.assert_array_equal(mine[0], theirs[0])
    assert mine[1] == theirs[1]
    np.testing.assert_array_equal(mine[2], theirs[2])
    assert (s.cost, s.counters.tolist()) == (r.cost, r.counters.tolist())
    np.testing.assert_array_equal(s.solution(), r.solution())
    assert s.meta_counts["meta_evals"] > 0


def test_meta_counts_add_up_on_road80():
    """On road80 every small instance of the meta rules is either decided
    by a bound or solved, in the initial reduction and over a whole peel
    (the exact component solves' instances included), and the bounds
    decide most of them."""
    g = build_road_graph(80)
    s = CoreSolver(g.weights, g.edge_array())
    s.reduce()
    first = s.meta_counts
    peeled = random_peel(CoreSolver, g, 0, components=True).meta_counts
    for c in (first, peeled):
        assert c["meta_bound_decided"] + c["meta_solved"] == c["meta_evals"]
        assert c["meta_evals"] > 0
        assert c["meta_bound_decided"] > c["meta_evals"] / 2
    assert peeled["meta_evals"] > first["meta_evals"]
