"""Strong scaling of the edge-partitioned sharded forward over P shards.

With ``--device cuda`` every shard has a card of its own (cuda:0 ..
cuda:P-1), as the JAX tool takes one device per shard, and a P above the
card count is skipped with one line on stderr.  ``--device cuda:K`` or
``cpu`` puts all P shards on that device: that measures the partition and
the exchange's overhead, not a speed-up.  The graph is
``random_graph(n, deg, seed=3)``; every row's scores are held against the
single-device ``score_graph`` (``max_abs_err_vs_single``).  Times are the
host clock around a synchronise of every card of the mesh
(``mesh_seconds_per_call``).

Usage:
    python -m gnn_mwvc_tpu_torch.tools.scale_bench [--n 200000] [--deg 12]
        [--parts 1,2,4,8] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from gnn_mwvc_tpu_torch.graph import DeviceGraph, random_graph, resolve_device
from gnn_mwvc_tpu_torch.models import pretrained_model, score_graph
from gnn_mwvc_tpu_torch.parallel import (Mesh, gather_scores,
                                         make_sharded_forward,
                                         mesh_seconds_per_call,
                                         partition_device_graph, place_mesh,
                                         synchronize)


def sharded_row(model, dg: DeviceGraph, ws: float, ref: np.ndarray,
                mesh: Mesh, iters: int) -> dict:
    """Partition ``dg`` over ``mesh``, run the sharded forward
    (x_is_node_weights, as ``score_graph``) and time it."""
    parts = mesh.parts
    synchronize(mesh.devices)
    t0 = time.perf_counter()
    sg = partition_device_graph(dg, parts, devices=mesh)
    synchronize(mesh.devices)
    t_part = time.perf_counter() - t0
    fwd = make_sharded_forward(model, mesh, x_is_node_weights=True)
    scores = gather_scores(sg, fwd(sg, ws))
    err = float(np.max(np.abs(scores - ref))) if len(ref) else 0.0
    dt = mesh_seconds_per_call(lambda: fwd(sg, ws), mesh.devices, iters)
    e = int(dg.indices.numel())
    return {"parts": parts, "devices": [str(d) for d in mesh.devices],
            "seconds": dt, "ms": dt * 1e3,
            "edges_per_s": round(e / dt), "max_abs_err_vs_single": err,
            "h_max": int(sg.h_max),
            "halo_bytes_per_shard": int(sg.halo_bytes_per_chip())
            if parts > 1 else 0, "t_partition_s": t_part}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--deg", type=int, default=12)
    ap.add_argument("--parts", default="1,2,4,8")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="cuda: one shard per card; cpu, cuda:K: all P there")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    g = random_graph(args.n, args.deg, seed=3)
    dg = DeviceGraph.from_graph(g, device)
    model = pretrained_model(device)
    ws = float(g.weights.max())
    ref = score_graph(model, dg, ws).cpu().numpy()

    rows = []
    for p in map(int, args.parts.split(",")):
        mesh = place_mesh(p, args.device, skip=True)
        if mesh is None:
            continue
        rows.append(sharded_row(model, dg, ws, ref, mesh, args.iters))
        print(rows[-1], file=sys.stderr)
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
