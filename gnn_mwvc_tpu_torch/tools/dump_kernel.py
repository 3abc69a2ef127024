"""Dump a road instance's phase-1 kernel and its model scores for phase-2
A/B runs (``tools/assist_ab.py``).

Runs the production phase 1 (``gnn_peel`` with the sticky scorer, K1 on the
device) on ``roadNNN`` relabelled by ``cluster_order``, unfolds to the
kernel and saves an npz with the JAX package's keys, so a file from either
package loads in either A/B tool: ``weights``, ``edges`` (uint32, u < v),
``s0`` (the initial cover), ``prob`` (the model's scores of the kernel's
vertices), ``initial_cost`` (the reductions' cost) and ``t_phase1``.

``prob`` comes from one forward over the kernel snapshot, as ``solve()``
scores the kernel for its phase-2 assist.  The JAX tool instead asks its
sticky scorer again after the unfold.  Below 4,000,000 live edges that
scorer routes to the per-snapshot forward, which gives the same scores;
above, it answers from its last build's CSR, where kernel vertices outside
that build keep 0.5.  Both packages' sticky scorers route alike (below
4,000,000 live edges, and on every round on the CPU), so the two tools peel
to the same kernel.

Usage:
    python -m gnn_mwvc_tpu_torch.tools.dump_kernel road900 [--out PATH]
        [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from gnn_mwvc_tpu_torch.core import CoreSolver, cluster_order
from gnn_mwvc_tpu_torch.solver.pipeline import (GnnScorer, gnn_peel,
                                                resolve_device)
from gnn_mwvc_tpu_torch.solver.static_score import StickyGnnScorer
from gnn_mwvc_tpu_torch.tools._common import default_out, road_instance


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("instance", help="roadNNN")
    ap.add_argument("--out", default=None,
                    help="npz path (default: kernel_<instance>.npz in the "
                         "temporary directory)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    g = road_instance(args.instance)
    g = g.reorder(cluster_order(g.indptr, g.indices))
    ws = float(g.weights.max())
    scorer = StickyGnnScorer(device=device)
    core = CoreSolver(g.weights, g.edge_array())
    t0 = time.perf_counter()
    t_kernel, kernel_size, initial_cost, split = gnn_peel(core, scorer, ws)
    t_peel = time.perf_counter() - t0
    print(f"phase1 {t_peel:.1f}s kernel={kernel_size} "
          f"init_cost={initial_cost}", flush=True)
    core.unfold(t_kernel)

    snap = core.snapshot()
    rows = np.repeat(np.arange(snap.n, dtype=np.int64),
                     np.diff(snap.indptr.astype(np.int64)))
    keep = rows < snap.indices
    kedges = np.stack([rows[keep], snap.indices[keep]], axis=1)
    s0 = np.array([core.decided(u) == 1 for u in snap.ids], dtype=np.uint8)

    prob = GnnScorer(scorer.model, device=device)(snap, ws)

    out = args.out or default_out(f"kernel_{args.instance}.npz")
    t_phase1 = time.perf_counter() - t0
    np.savez(
        out, weights=snap.weights, edges=kedges.astype(np.uint32), s0=s0,
        prob=prob, initial_cost=np.int64(initial_cost),
        t_phase1=np.float64(t_phase1))
    print("saved", out, f"n={snap.n} m={len(kedges)}", flush=True)
    print(json.dumps({
        "instance": args.instance, "out": out, "n": int(snap.n),
        "m": int(len(kedges)), "initial_cost": int(initial_cost),
        "cover_cost": int(initial_cost + snap.weights[s0 == 1].sum()),
        "t_phase1": t_phase1, "t_gnn_peel": t_peel,
        "phase1": {k: v for k, v in split.items() if k != "scorer"},
        "device": str(device)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
