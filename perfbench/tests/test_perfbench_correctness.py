"""The comparison that decides ``correct``, shown to fail: the control (the
reference with TF32 products in the program's place) and each fault a cell
can have, planted in the program underneath a whole run.  The runs skip
the look for a card and run on the CPU at small sizes; everything else is
the run a benchmark cell makes."""

import numpy as np
import pytest
import torch

from perfbench.run import run_cell

SMALL = {
    "road1200.cover": ({"side": 60}, {}, 0.5),
    "road700.budget": ({"side": 60}, {
        "solve": {"reorder": True, "device_assist": True,
                  "assist_batch": 64, "assist_rmax": 12},
        "warmup": {"side": 24, "time_limit": 0.3, "scorer_args": {}},
        "check": {"rounds": 2, "round_range": 8, "batches": 3,
                  "batch_range": 6, "regions_per_batch": 32}}, 2.5),
    "road700.budget-plain": ({"side": 60}, {
        "warmup": {"side": 24, "time_limit": 0.3, "scorer_args": {}}}, 1.5),
    "road700.train": ({"side": 40}, {}, 0.5),
}


def run(cell, seed=2**31 + 11, control=False):
    scale, over, secs = SMALL[cell]
    return run_cell(cell, seed, secs, False, device="cpu", scale=scale,
                    traffic_over=over, control=control)


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_sound_run_is_correct_and_the_control_is_not(cell):
    out = run(cell, control=True)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert not out["control"]["tf32"]["correct"], out["control"]
    for name, ctl in out["control"].items():
        assert not ctl["correct"], (name, ctl)


def test_an_altered_cover_is_caught(monkeypatch):
    """An answer altered where it is produced: the unfolded solution drops
    one vertex of the cover."""
    from gnn_mwvc_tpu_torch.core import api

    real = api.CoreSolver.solution

    def dropped(self):
        sol = real(self).copy()
        sol[np.nonzero(sol == 1)[0][0]] = 0
        return sol

    monkeypatch.setattr(api.CoreSolver, "solution", dropped)
    out = run("road1200.cover")
    assert not out["correct"]
    assert out["checks"]["uncovered_edges"]["value"] > 0
    assert out["failed"] == out["attempted"]


def test_altered_scores_are_caught(monkeypatch):
    """An answer altered where it is produced: the scorer's scores move by
    1e-3."""
    from gnn_mwvc_tpu_torch.solver import static_score

    real = static_score.StickyGnnScorer.score_core

    def shifted(self, core, weight_scale):
        ids, prob, w, deg = real(self, core, weight_scale)
        return ids, np.clip(prob + 1e-3, 0, 1).astype(np.float32), w, deg

    monkeypatch.setattr(static_score.StickyGnnScorer, "score_core", shifted)
    out = run("road1200.cover")
    assert not out["correct"]
    assert out["checks"]["score_gap"]["value"] > 5e-4


def test_a_worse_region_answer_is_caught(monkeypatch):
    """An answer altered where it is produced: the region solver answers
    every region with all its vertices (a cover, but not the least)."""
    from gnn_mwvc_tpu_torch.solver import device_assist

    real = device_assist.small_mwvc_mitm

    def all_in(adj, w):
        cost, _best = real(adj, w)
        used = (w != 0) | (adj != 0)
        bits = (used.to(torch.int32)
                << torch.arange(adj.shape[1], dtype=torch.int32)).sum(
                    1, dtype=torch.int32)
        return w.sum(1, dtype=torch.int32), bits

    monkeypatch.setattr(device_assist, "small_mwvc_mitm", all_in)
    out = run("road700.budget")
    assert not out["correct"]
    assert out["checks"]["k4_wrong"]["value"] > 0


def test_a_step_that_leaves_the_state_unchanged_is_caught(monkeypatch):
    from gnn_mwvc_tpu_torch.train import trainer

    def no_step(opt, t):
        opt.zero_grad()

    monkeypatch.setattr(trainer, "_sgd_step", no_step)
    out = run("road700.train")
    assert not out["correct"]
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_the_batch_left_out_is_caught(monkeypatch):
    """Each graph's loss over its first half of vertices only, doubled:
    the mean taken over the rest."""
    from gnn_mwvc_tpu_torch.train import trainer

    real = trainer.loss_and_metrics

    def half(model, s, weight_scale, compat=True):
        mask = s.mask.clone()
        mask[s.n // 2:] = False
        sse, m = real(model, type(s)(s.dg, s.y, mask, s.n, s.name),
                      weight_scale, compat)
        return 2 * sse, m

    monkeypatch.setattr(trainer, "loss_and_metrics", half)
    out = run("road700.train")
    assert not out["correct"]
