"""Error and time of the forward's precision settings on the bench graph.

``build_road_graph(side)`` (default 1200, or ``BENCH_SIDE``) relabelled by
``cluster_order``, as the JAX bench scores it, through the unmasked forward
with ``x_is_node_weights`` (``score_graph``'s input).  Ground truth is the
CPU fp32 forward.  Per setting: ms per forward (CUDA events on a card, the
host clock on the CPU; best of ``--batches`` means of ``--iters`` calls),
edges/s, and the max and mean absolute error and the share of rows over
2e-5 against the ground truth.

The settings are the JAX tool's three:

  * ``highest``: fp32 products (``MWVCModel.forward(precision="highest")``);
  * ``mixed``: in JAX the products at highest and the aggregation at the
    backend's default.  K1 sums in fp32 under either setting, so this is
    ``highest`` here; the row is run and says so;
  * ``default``: TF32 products on a card (``precision="default"``).

Usage:
    python -m gnn_mwvc_tpu_torch.tools.precision_study [--side 1200]
        [--iters 5] [--batches 4] [--out PATH] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from gnn_mwvc_tpu_torch.core import cluster_order
from gnn_mwvc_tpu_torch.graph import (DeviceGraph, build_road_graph,
                                      resolve_device)
from gnn_mwvc_tpu_torch.models import pretrained_model
from gnn_mwvc_tpu_torch.parallel import synchronize
from gnn_mwvc_tpu_torch.tools._common import default_out, seconds_per_call

# (setting, MWVCModel.forward's precision, what the row computes)
SETTINGS = (
    ("highest", "highest", "fp32 products, fp32 K1 sums"),
    ("mixed", "highest", "JAX: products highest, aggregation default; K1 "
                         "sums in fp32 under either, so = highest"),
    ("default", "default", "TF32 products, fp32 K1 sums"),
)


def forward_fn(model, dg: DeviceGraph, ws: float, precision: str):
    """The unmasked scoring forward: (n,) scores."""
    x = (dg.weights / ws).reshape(-1, 1)
    return lambda: model(x, dg, ws, x_is_node_weights=True,
                         precision=precision)[:, 0]


@torch.no_grad()
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--side", type=int,
                    default=int(os.environ.get("BENCH_SIDE", 1200)))
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--out", default=None,
                    help="JSON path (default: precision_study.json in the "
                         "temporary directory)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    g = build_road_graph(args.side)
    g = g.reorder(cluster_order(g.indptr, g.indices))
    ws = float(g.weights.max())
    print("CPU fp32 ground truth...", flush=True)
    ref = forward_fn(pretrained_model("cpu"), DeviceGraph.from_graph(g, "cpu"),
                     ws, "highest")().numpy()

    dg = DeviceGraph.from_graph(g, device)
    model = pretrained_model(device)
    e = int(dg.indices.numel())
    results = {"side": args.side, "n": int(g.n), "e_directed": e,
               "device": (torch.cuda.get_device_name(device)
                          if device.type == "cuda" else "cpu")}
    for tag, precision, what in SETTINGS:
        fn = forward_fn(model, dg, ws, precision)
        t0 = time.perf_counter()
        scores = fn().cpu().numpy()
        synchronize(device)
        first = time.perf_counter() - t0
        err = np.abs(scores - ref)
        dt = min(seconds_per_call(fn, device, args.iters)
                 for _ in range(args.batches))
        results[tag] = {
            "precision": precision, "what": what,
            "edges_per_s": round(e / dt), "ms_per_forward": dt * 1e3,
            "first_call_s": first, "max_abs_err": float(err.max()),
            "mean_abs_err": float(err.mean()),
            "frac_gt_2e-5": float((err > 2e-5).mean()),
        }
        print(tag, json.dumps(results[tag]), flush=True)
    with open(args.out or default_out("precision_study.json"), "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
