"""Device-guided bulk reduction prepass (opt-in; not on ``solve()``'s path).

Each round computes whole-graph rule candidate masks of the core's snapshot
on the device (``ops/rules.py``) and bulk-applies them through the host
core.  Soundness differs per rule:

* r1 / twins: the core re-checks each candidate against the live state
  (NW <= W, exact twinness) before committing, so stale masks are harmless.
* r5 (``bulk_r5``): the device's 2^8-subset proof is exact for the
  snapshot's instance and is applied without a host re-solve.  It carries
  over to the live state only because the core tracks instance drift during
  the pass (``begin_bulk_pass``) and skips any candidate whose 1-hop
  instance may have changed.

This front-loads the O(E) share of the reduction work (rule-1 removals and
twin folds) before the fine-grained worklist engine runs.  On road-like
graphs the host engine alone is faster at every scale measured; PERF.md
gives the port's numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from gnn_mwvc_tpu_torch.core import CoreSolver
from gnn_mwvc_tpu_torch.graph import resolve_device
from gnn_mwvc_tpu_torch.ops.rules import (build_ell8, mask_inputs,
                                          r5_candidates, rule_masks,
                                          twin_groups)

__all__ = ["device_reduce_prepass"]


def device_reduce_prepass(core: CoreSolver, max_rounds: int = 4,
                          min_nodes: int = 50_000, device="cuda",
                          with_r5: bool = True) -> dict:
    """Mask -> bulk-apply rounds until the yield drops; returns the counts
    applied.  ``device="cuda"`` without CUDA raises."""
    device = resolve_device(device)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    stats = {"rounds": 0, "r1_applied": 0, "twins_applied": 0,
             "r5_applied": 0}
    for _ in range(max_rounds):
        if core.active_count < min_nodes:
            break
        snap = core.snapshot()
        row, col, w, d, nw = mask_inputs(snap.weights, snap.indptr,
                                         snap.indices)
        everyone = torch.ones(snap.n, dtype=torch.bool, device=device)
        masks = rule_masks(put(row), put(col), put(w), put(d), put(nw),
                           everyone)
        r1 = masks["r1"].cpu().numpy()
        keys = masks["twin_key"].cpu().numpy()
        r5 = None
        # int32 arithmetic: sound only while every instance cost (bounded
        # by NW) fits
        if with_r5 and (snap.n == 0 or int(snap.nw.max()) < 2**31):
            ell, ellv = build_ell8(snap.indptr.astype(np.int64),
                                   snap.indices.astype(np.int64), snap.deg)
            r5 = r5_candidates(
                put(ell), put(ellv), put(snap.weights.astype(np.int32)),
                put(snap.nw.astype(np.int32)), put(snap.deg.astype(np.int32)),
                everyone).cpu().numpy()

        # the masks describe this snapshot; from here on the core tracks
        # instance drift, so r5 verdicts apply only where the proof holds
        core.begin_bulk_pass()
        applied = core.bulk_r1(snap.ids[np.nonzero(r1)[0]])
        stats["r1_applied"] += applied

        pairs = [(snap.ids[grp[0]], snap.ids[other])
                 for grp in twin_groups(keys, np.ones(snap.n, bool))
                 for other in grp[1:]]
        if pairs:
            t = core.bulk_twins(np.asarray(pairs, dtype=np.uint32))
            stats["twins_applied"] += t
            applied += t
        if r5 is not None:
            # r1 already covers nw <= w (every degree-0 node included); the
            # strictly-meta verdicts keep the counters honest
            r5_ids = snap.ids[np.nonzero(r5 & ~r1)[0]]
            if len(r5_ids):
                a5 = core.bulk_r5(r5_ids)
                stats["r5_applied"] += a5
                applied += a5
        stats["rounds"] += 1
        if applied < max(100, core.active_count // 1000):
            break
    return stats
