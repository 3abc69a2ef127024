"""GNN-free scoring: pure weight/degree priority (the reference's QUICK_VC
variant, reference: old_files/src/apps/QUICK_VC.cpp:110-160).

QUICK_VC orders vertices by weight descending then degree ascending and
excludes greedily (every vertex scored as an exclusion candidate); the peel
treats a score < 0.5 as "exclude the vertex, take its neighbourhood".  To
reproduce that order through the confidence comparator the scores lie in
(0, 0.5), and their confidence margin encodes the priority.  A phase-1
scorer of ``gnn_peel`` (``score_core``) over each round's snapshot, on the
host; no model and no device are involved.
"""

from __future__ import annotations

import numpy as np

__all__ = ["QuickScorer"]


class QuickScorer:
    model = None

    def __init__(self):
        self.stats = {"rounds": 0}

    def score_core(self, core, weight_scale: float):
        snap = core.snapshot()
        self.stats["rounds"] += 1
        return snap.ids, self(snap, weight_scale), snap.weights, snap.deg

    def __call__(self, snap, weight_scale: float) -> np.ndarray:
        w = snap.weights.astype(np.float64)
        d = np.maximum(snap.deg.astype(np.float64), 1.0)
        # heavy, low-degree vertices are the best exclusions: higher
        # priority maps closer to 0 (more confident), so they peel first
        prio = (w / weight_scale) / d
        prio = prio / max(prio.max(), 1e-9)
        return (0.5 - 0.4999 * prio).astype(np.float32)
