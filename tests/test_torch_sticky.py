"""The port's sticky scorer against the JAX package's, round by round.

Two native cores are driven through the same peel: each round both scorers
score their own core, the JAX side's confidence order peels both, and the
scores must agree within 1e-5 on the same ids.  Against a fresh forward over
the compacted snapshot, which sums in another order, the bound is 2e-4.
Each sticky round's device rows are the core's live rows.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench
from gnn_mwvc_tpu.core import CoreSolver as JaxCore
from gnn_mwvc_tpu.solver.pipeline import confidence_order
from gnn_mwvc_tpu.solver.static_score import StickyGnnScorer as JaxSticky
from gnn_mwvc_tpu_torch.core import CoreSolver
from gnn_mwvc_tpu_torch.parallel import make_mesh
from gnn_mwvc_tpu_torch.solver.pipeline import GnnScorer
from gnn_mwvc_tpu_torch.solver.sharded_score import ShardedGnnScorer
from gnn_mwvc_tpu_torch.solver.static_score import StickyGnnScorer
from tests.conftest import random_graph

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
    rounds re-score the first build's rows."""
    rounds, neutral, stats = _drive(bench.build_road_graph(40), 1.0)
    assert rounds >= 2
    assert neutral > 0
    assert stats["rebuilds"] == 1 and stats["rounds"] == rounds


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


@pytest.mark.parametrize("kind", ["sticky", "sharded"])
def test_each_sticky_round_uploads_the_live_rows(kind):
    """Every sticky round puts the built rows' live (W, NW, D, active) on
    the device in full: ``core.live_rows(ids)``, which equals the core's
    flat node arrays at those ids, and zeros in a shard's padding.  The
    fold gadgets past the build (road40, rebuild out of reach) come back
    with their live weight and degree and a neutral 0.5."""
    g = bench.build_road_graph(40)
    ws = float(g.weights.max())
    core = CoreSolver(g.weights, g.edge_array())
    core.reduce()
    scorer = (StickyGnnScorer(device="cpu", rebuild_gadget_frac=1.0,
                              force_sticky=True) if kind == "sticky"
              else ShardedGnnScorer(mesh=make_mesh(2, devices=["cpu"] * 2),
                                    rebuild_gadget_frac=1.0))
    uploads = []
    real = scorer._forward

    def forward(live, weight_scale):
        uploads.append(torch.cat(live, 1) if isinstance(live, list)
                       else live)
        return real(live, weight_scale)

    scorer._forward = forward
    gadgets = 0
    while True:
        core.solve_small_components(75)
        if core.active_count == 0:
            break
        ids, prob, w, deg = scorer.score_core(core, ws)
        built_ids, built_size = scorer._state[1], scorer._state[2]
        rows = core.live_rows(built_ids)
        flat = core.node_arrays()   # (active, w, nw, deg) by node id
        for a, b in zip(rows, flat):
            np.testing.assert_array_equal(a, b[built_ids])
        act, w_b, nw_b, deg_b = rows
        got = uploads[-1].numpy()
        np.testing.assert_array_equal(
            got[:, :len(built_ids)],
            np.stack([w_b, nw_b, deg_b, act]).astype(np.float32))
        assert not got[:, len(built_ids):].any()
        tail = ids >= built_size
        live_g = built_size + np.nonzero(flat[0][built_size:])[0]
        np.testing.assert_array_equal(ids[tail], live_g)
        np.testing.assert_array_equal(w[tail], flat[1][live_g])
        np.testing.assert_array_equal(deg[tail], flat[3][live_g])
        assert (prob[tail] == 0.5).all()
        gadgets += int(tail.sum())
        order = confidence_order(prob, w, deg)
        core.reset_label_count()
        core.peel(ids[order], prob[order].astype(np.float32), -1)
    assert len(uploads) == scorer.stats["rounds"] >= 2
    assert scorer.stats["rebuilds"] == 1 and gadgets > 0


@pytest.mark.parametrize("module", ["gnn_mwvc_tpu_torch.solver.static_score",
                                    "gnn_mwvc_tpu_torch.train"])
def test_scorers_and_training_load_without_the_pipeline(module):
    """The scorers sit under the pipeline and training beside it: importing
    either loads no other module of ``solver/``."""
    code = (f"import json, sys, {module}\n"
            "print(json.dumps(sorted(m for m in sys.modules\n"
            "    if m.startswith('gnn_mwvc_tpu_torch.solver.'))))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert loaded == [m for m in [module] if ".solver." in m]
