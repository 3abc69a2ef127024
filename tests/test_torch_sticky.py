"""The port's sticky scorer against the JAX package's, round by round.

Two native cores are driven through the same peel: each round both scorers
score their own core, the JAX side's confidence order peels both, and the
scores must agree within 1e-5 on the same ids.  Against a fresh forward over
the compacted snapshot, which sums in another order, the bound is 2e-4.
"""

import numpy as np
import pytest

import bench
from gnn_mwvc_tpu.core import CoreSolver as JaxCore
from gnn_mwvc_tpu.solver.pipeline import confidence_order
from gnn_mwvc_tpu.solver.static_score import StickyGnnScorer as JaxSticky
from gnn_mwvc_tpu_torch.core import CoreSolver
from gnn_mwvc_tpu_torch.solver.pipeline import GnnScorer
from gnn_mwvc_tpu_torch.solver.static_score import StickyGnnScorer
from tests.conftest import random_graph


def _drive(gj, rebuild_gadget_frac):
    ws = float(gj.weights.max())
    cj = JaxCore(gj.weights, gj.edge_array())
    ct = CoreSolver(gj.weights, gj.edge_array())
    cj.reduce()
    ct.reduce()
    js = JaxSticky(force_sticky=True, warm_overlap=False,
                   rebuild_gadget_frac=rebuild_gadget_frac)
    ts = StickyGnnScorer(device="cpu", rebuild_gadget_frac=rebuild_gadget_frac,
                         force_sticky=True)
    rounds = neutral = 0
    while True:
        cj.solve_small_components(75)
        ct.solve_small_components(75)
        assert ct.active_count == cj.active_count
        if cj.active_count == 0:
            break
        ids_j, p_j, w_j, d_j = js.score_core(cj, ws)
        ids_t, p_t, w_t, d_t = ts.score_core(ct, ws)
        np.testing.assert_array_equal(ids_t, ids_j)
        np.testing.assert_array_equal(w_t, w_j)
        np.testing.assert_array_equal(d_t, d_j)
        np.testing.assert_allclose(p_t, p_j, atol=1e-5, rtol=0)
        neutral += int((ids_t >= ts._state[2]).sum())
        order = confidence_order(p_j, w_j, d_j)
        for core in (cj, ct):
            core.reset_label_count()
            core.peel(ids_j[order], p_j[order].astype(np.float32), -1)
        rounds += 1
    assert ct.cost == cj.cost
    return rounds, neutral, ts.stats


def test_sticky_matches_jax_with_gadget_nodes():
    """Folds create gadget nodes after the build; with the rebuild trigger
    out of reach they are scored neutral (0.5) on both sides, and later
    rounds go through the delta upload."""
    rounds, neutral, stats = _drive(bench.build_road_graph(40), 1.0)
    assert rounds >= 2
    assert neutral > 0
    assert stats["rebuilds"] == 1 and stats["deltas"] > 0


@pytest.mark.parametrize("name", ["road100", "er1500"])
def test_sticky_matches_jax_with_default_rebuilds(name):
    gj = (bench.build_road_graph(100) if name == "road100"
          else random_graph(1500, 14, seed=5, wmax=500))
    rounds, _neutral, stats = _drive(gj, 0.02)
    assert rounds >= 1 and stats["rounds"] == rounds


def test_sticky_matches_fresh_after_removals():
    """After plain removals through real decisions (no folds, so no
    rebuild) the masked re-score over the stale structure equals a fresh
    snapshot's score on every active node, and the JAX scorer's after the
    same removals."""
    gj = random_graph(800, 8, seed=3, wmax=100)
    ws = float(gj.weights.max())
    ct = CoreSolver(gj.weights, gj.edge_array(), num_rules=0)
    cj = JaxCore(gj.weights, gj.edge_array(), num_rules=0)
    ts = StickyGnnScorer(device="cpu", force_sticky=True)
    js = JaxSticky(force_sticky=True, warm_overlap=False)
    assert len(ts.score_core(ct, ws)[0]) == ct.active_count
    js.score_core(cj, ws)
    rng = np.random.default_rng(0)
    for u in rng.permutation(gj.n):
        if gj.n - ct.active_count > gj.n * 0.15:
            break
        if ct.is_active(u):
            assert cj.is_active(u)
            whole = rng.random() < 0.5
            for c in (ct, cj):
                (c.select_neighborhood if whole else c.select_node)(int(u))
    assert ct.active_count == cj.active_count < gj.n * 0.85

    ids_t, p_t, _w, _d = ts.score_core(ct, ws)
    ids_j, p_j, _w, _d = js.score_core(cj, ws)
    assert ts.stats["rebuilds"] == 1
    np.testing.assert_array_equal(ids_t, ids_j)
    np.testing.assert_allclose(p_t, p_j, atol=1e-5, rtol=0)
    snap = ct.snapshot()
    fresh = dict(zip(snap.ids.tolist(), GnnScorer(device="cpu")(snap, ws)))
    assert set(ids_t.tolist()) == set(fresh)
    np.testing.assert_allclose(p_t, [fresh[i] for i in ids_t.tolist()],
                               atol=2e-4, rtol=0)
