"""Sharded-forward scaling on a road-like and a locality-free instance.

Shards ``build_road_graph(side)`` (relabelled by ``cluster_order``) and
``random_graph(er_n, 16, seed=42)`` over P shards and records per P the
forward's time and edges/s, the halo bytes each shard sends per layer,
``h_max``, the partition's seconds and the largest difference from the
single-device scores (``max_err_vs_single``).  ``--device cuda`` gives
every shard a card of its own (cuda:0 .. cuda:P-1, as the JAX tool takes
one device per shard) and skips a P above the card count with one line on
stderr; ``cuda:K`` or ``cpu`` puts all P on that device, which measures the
partition and the exchange's overhead, not a speed-up.  Times, the
single-device forward's too, are the host clock around a synchronise of
every card of the mesh (``mesh_seconds_per_call``).

Usage:
    python -m gnn_mwvc_tpu_torch.tools.scaling_weak [--side 700]
        [--er-n 200000] [--parts 1,2,4,8] [--out PATH] [--device cuda]
"""

from __future__ import annotations

import argparse
import json

from gnn_mwvc_tpu_torch.core import cluster_order
from gnn_mwvc_tpu_torch.graph import (DeviceGraph, build_road_graph,
                                      random_graph, resolve_device)
from gnn_mwvc_tpu_torch.models import pretrained_model, score_graph
from gnn_mwvc_tpu_torch.parallel import mesh_seconds_per_call, place_mesh
from gnn_mwvc_tpu_torch.tools._common import default_out
from gnn_mwvc_tpu_torch.tools.scale_bench import sharded_row

REPS = 3


def run_instance(name, g, meshes, results, device):
    model = pretrained_model(device)
    ws = float(g.weights.max())
    dg = DeviceGraph.from_graph(g, device)
    e = int(dg.indices.numel())
    ref = score_graph(model, dg, ws).cpu().numpy()
    t_single = mesh_seconds_per_call(lambda: score_graph(model, dg, ws),
                                     [device], REPS)
    rows = []
    for mesh in meshes:
        r = sharded_row(model, dg, ws, ref, mesh, REPS)
        row = {"parts": r["parts"], "devices": r["devices"],
               "t_forward_s": r["seconds"],
               "edges_per_s": r["edges_per_s"],
               "halo_bytes_per_chip": r["halo_bytes_per_shard"],
               "h_max": r["h_max"], "t_partition_build_s": r["t_partition_s"],
               "max_err_vs_single": r["max_abs_err_vs_single"]}
        rows.append(row)
        print(name, json.dumps(row), flush=True)
    results[name] = {"n": int(g.n), "e_directed": e,
                     "t_single_forward_s": t_single,
                     "single_edges_per_s": round(e / t_single),
                     "configs": rows}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--side", type=int, default=700)
    ap.add_argument("--er-n", type=int, default=200_000)
    ap.add_argument("--parts", default="1,2,4,8")
    ap.add_argument("--out", default=None,
                    help="JSON path (default: scaling_weak.json in the "
                         "temporary directory)")
    ap.add_argument("--device", default="cuda",
                    help="cuda: one shard per card; cpu, cuda:K: all P there")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    meshes = [m for m in (place_mesh(int(p), args.device, skip=True)
                          for p in args.parts.split(",")) if m is not None]

    results = {}
    g = build_road_graph(args.side)
    g = g.reorder(cluster_order(g.indptr, g.indices))
    run_instance(f"road{args.side}", g, meshes, results, device)
    g = random_graph(args.er_n, 16, seed=42, wmax=1000)
    run_instance(f"er{args.er_n // 1000}k", g, meshes, results, device)

    with open(args.out or default_out("scaling_weak.json"), "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
