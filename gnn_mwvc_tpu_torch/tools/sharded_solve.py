"""Sharded-scorer solve parity: the same cover through P shards as through
one device.

Runs ``solve(time_limit=0, reorder=True, device_assist=False)`` on
``roadNNN`` twice: phase-1 scoring through ``ShardedGnnScorer`` over a mesh
of P shards (``place_mesh``: ``--device cuda`` one per card, cuda:0 ..
cuda:P-1, as the JAX tool's mesh takes every device, and more shards than
cards raises; ``cuda:K`` or ``cpu`` all P on that device; exact mode,
``rebuild_gadget_frac=0``, so no round scores fold gadgets with the neutral
0.5 that the per-snapshot scorer does not use), and through the
per-snapshot ``GnnScorer``.  Phase 1 is deterministic and phase 2 does not
run, so the covers must be identical;
exits 1 if they are not or their costs differ.  Records both phase-1
times, ``h_max`` and the halo bytes per shard per layer.

Usage:
    python -m gnn_mwvc_tpu_torch.tools.sharded_solve road300 [--parts 4]
        [--out PATH] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from gnn_mwvc_tpu_torch.graph import resolve_device
from gnn_mwvc_tpu_torch.graphio import cover_cost, is_vertex_cover
from gnn_mwvc_tpu_torch.parallel import place_mesh
from gnn_mwvc_tpu_torch.solver.pipeline import GnnScorer, solve
from gnn_mwvc_tpu_torch.solver.sharded_score import ShardedGnnScorer
from gnn_mwvc_tpu_torch.tools._common import default_out, road_instance


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("instance", help="roadNNN")
    ap.add_argument("--parts", type=int, default=4, help="shards")
    ap.add_argument("--out", default=None,
                    help="JSON path (default: sharded_solve_<instance>_p<P>"
                         ".json in the temporary directory)")
    ap.add_argument("--device", default="cuda",
                    help="cuda: one shard per card; cpu, cuda:K: all P there")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    mesh = place_mesh(args.parts, args.device)

    g = road_instance(args.instance)
    print(f"{args.instance}: n={g.n} m={g.m}", flush=True)
    # min_nodes=0: every round on the mesh, at any size, as the JAX tool's
    # CPU mesh runs it
    sh = ShardedGnnScorer(mesh=mesh, rebuild_gadget_frac=0.0, min_nodes=0)
    t0 = time.perf_counter()
    res_s = solve(g, time_limit=0.0, reorder=True, scorer=sh,
                  device_assist=False, device=device)
    t_mesh = time.perf_counter() - t0

    t0 = time.perf_counter()
    res_1 = solve(g, time_limit=0.0, reorder=True,
                  scorer=GnnScorer(device=device), device_assist=False,
                  device=device)
    t_single = time.perf_counter() - t0

    if not is_vertex_cover(g, res_s.solution):
        raise RuntimeError("the sharded solve's cover is not a vertex cover")
    if cover_cost(g, res_s.solution) != res_s.cost:
        raise RuntimeError("the sharded solve's cover costs another amount")
    identical = bool(np.array_equal(res_s.solution, res_1.solution))
    rec = {
        "instance": args.instance, "parts": args.parts,
        "cost_mesh": int(res_s.cost), "cost_single": int(res_1.cost),
        "identical_covers": identical,
        "t_phase1_mesh_s": round(t_mesh, 3),
        "t_phase1_single_s": round(t_single, 3),
        "h_max": sh.stats.get("h_max"),
        "halo_bytes_per_shard_per_layer": sh.stats.get("halo_bytes"),
        "device": str(device), "devices": [str(d) for d in mesh.devices],
        "mesh_scorer": dict(sh.stats),
    }
    print(json.dumps(rec), flush=True)
    out = args.out or default_out(
        f"sharded_solve_{args.instance}_p{args.parts}.json")
    with open(out, "w") as f:
        json.dump(rec, f, indent=1)
    return 0 if identical and res_s.cost == res_1.cost else 1


if __name__ == "__main__":
    sys.exit(main())
