"""Strong scaling of the edge-partitioned sharded forward over P shards.

On one device the P shards share it (``make_mesh(P, devices=[device] *
P)``): this measures the partition and the exchange's overhead, not a
speed-up, which needs P cards.  The graph is ``random_graph(n, deg,
seed=3)``; every row's scores are held against the single-device
``score_graph`` (``max_abs_err_vs_single``).  Times are CUDA events on a
card, the host clock on the CPU.

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

from gnn_mwvc_tpu_torch.graph import DeviceGraph, random_graph
from gnn_mwvc_tpu_torch.models import pretrained_model, score_graph
from gnn_mwvc_tpu_torch.parallel import (gather_scores, make_mesh,
                                         make_sharded_forward,
                                         partition_device_graph)
from gnn_mwvc_tpu_torch.solver.pipeline import resolve_device
from gnn_mwvc_tpu_torch.tools._common import seconds_per_call, sync


def sharded_row(model, dg: DeviceGraph, ws: float, ref: np.ndarray, parts: int,
                device, iters: int) -> dict:
    """Partition ``dg`` into ``parts`` shards of ``device``, run the
    sharded forward (x_is_node_weights, as ``score_graph``) and time it."""
    mesh = make_mesh(parts, devices=[device] * parts)
    sync(device)
    t0 = time.perf_counter()
    sg = partition_device_graph(dg, parts, devices=mesh)
    sync(device)
    t_part = time.perf_counter() - t0
    fwd = make_sharded_forward(model, mesh, x_is_node_weights=True)
    scores = gather_scores(sg, fwd(sg, ws))
    err = float(np.max(np.abs(scores - ref))) if len(ref) else 0.0
    dt = seconds_per_call(lambda: fwd(sg, ws), device, iters)
    e = int(dg.indices.numel())
    return {"parts": parts, "seconds": dt, "ms": dt * 1e3,
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
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    g = random_graph(args.n, args.deg, seed=3)
    dg = DeviceGraph.from_graph(g, device)
    model = pretrained_model(device)
    ws = float(g.weights.max())
    ref = score_graph(model, dg, ws).cpu().numpy()

    rows = []
    for p in map(int, args.parts.split(",")):
        rows.append(sharded_row(model, dg, ws, ref, p, device, args.iters))
        print(rows[-1], file=sys.stderr)
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
