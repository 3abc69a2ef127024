"""One shard's slice of an edge-partitioned ER graph, on one device.

For each P, the workload one of P shards holds when a locality-free (ER)
graph of n nodes is split by destination rows: n/P rows at full degree
``deg``, sources spread at random.  The published model's unmasked forward
(x = W/ws, the first graph layer reading NW/ws) runs on it, each output
chained into the next input; the best of the batches is kept.  Times are
CUDA events on a card, the host clock on the CPU.

On a card each row also holds kernel K1 alone on that slice (width 16, a
70%-live float32 source mask, as ``chip_smoke.py`` phase 4 times it on
road1200): device ms from a CUDA graph of 20 launches beside its HBM bound,
the unmasked K1 beside ``torch.sparse.mm`` on the same CSR, and K1's
largest difference from its plain version.  At P = 1 this is K1 on a graph
without locality.

Usage:
    python -m gnn_mwvc_tpu_torch.tools.er_slice_bench [--n 200000]
        [--deg 16] [--parts 1,4,8,16] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from gnn_mwvc_tpu_torch.graph import DeviceGraph, Graph, resolve_device
from gnn_mwvc_tpu_torch.models import pretrained_model
from gnn_mwvc_tpu_torch.ops.aggregate import csr_aggregate, csr_aggregate_plain
from gnn_mwvc_tpu_torch.parallel import synchronize
from gnn_mwvc_tpu_torch.tools._common import (default_out, graph_ms,
                                              hbm_bound_ms, seconds_per_call)


def build_er(n, deg, seed=3) -> Graph:
    """The JAX tool's ER generator: n * deg / 2 unique random edges."""
    rng = np.random.default_rng(seed)
    m = n * deg // 2
    u = rng.integers(0, n, size=int(m * 1.25))
    v = rng.integers(0, n, size=int(m * 1.25))
    lo, hi = np.minimum(u, v), np.maximum(u, v)
    keep = lo != hi
    edges = np.unique(np.stack([lo[keep], hi[keep]], axis=1), axis=0)[:m]
    w = rng.integers(1, 1001, size=n)
    return Graph(w, edges)


def forward_scores(model, dg: DeviceGraph, ws: float,
                   xcol: torch.Tensor) -> torch.Tensor:
    """One unmasked forward with ``x_is_node_weights`` semantics; ``xcol``
    (n, 1) is added at 1e-12 so each call depends on the one before."""
    with torch.no_grad():
        x = (dg.weights / ws).reshape(-1, 1) + xcol * 1e-12
        return model(x, dg, ws, x_is_node_weights=True)[:, :1]


def k1_on_slice(dg: DeviceGraph, seed: int) -> dict:
    """K1 alone on the slice's CSR, on the card."""
    rng = np.random.default_rng(seed)
    dev = dg.indptr.device
    x = torch.from_numpy(rng.standard_normal((dg.n, 16)).astype(
        np.float32)).to(dev)
    mask = torch.from_numpy((rng.random(dg.n) < 0.7).astype(np.float32)).to(dev)
    out = csr_aggregate(x, dg.indptr, dg.indices, mask)
    out_u = csr_aggregate(x, dg.indptr, dg.indices)
    err = max(float((out - csr_aggregate_plain(x, dg.indptr, dg.indices,
                                               mask)).abs().max()),
              float((out_u - csr_aggregate_plain(x, dg.indptr, dg.indices))
                    .abs().max()))
    a_csr = torch.sparse_csr_tensor(
        dg.indptr, dg.indices, torch.ones(dg.indices.numel(), device=dev),
        size=(dg.n, dg.n), check_invariants=False)
    lib_err = float((torch.sparse.mm(a_csr, x) - out_u).abs().max())
    masked_ms = graph_ms(lambda: csr_aggregate(x, dg.indptr, dg.indices, mask))
    unmasked_ms = graph_ms(lambda: csr_aggregate(x, dg.indptr, dg.indices))
    library_ms = graph_ms(lambda: torch.sparse.mm(a_csr, x))
    bound = hbm_bound_ms(dg.indptr, dg.indices, x, mask, out)
    bound_u = hbm_bound_ms(dg.indptr, dg.indices, x, out_u)
    return {"k1_device_ms": masked_ms, "k1_bound_ms": bound,
            "k1_bound_frac": bound / masked_ms,
            "k1_unmasked_device_ms": unmasked_ms,
            "k1_unmasked_bound_ms": bound_u,
            "sparse_mm_device_ms": library_ms,
            "k1_max_abs_err": err, "sparse_mm_max_abs_err": lib_err}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--deg", type=int, default=16)
    ap.add_argument("--parts", default="1,4,8,16")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--out", default=None,
                    help="JSON path (default: er_slice_bench.json in the "
                         "temporary directory)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    model = pretrained_model(device)
    rows = []
    for p in map(int, args.parts.split(",")):
        n_slice = args.n // p
        g = build_er(n_slice, args.deg, seed=3 + p)
        t0 = time.perf_counter()
        dg = DeviceGraph.from_graph(g, device)
        ws = float(g.weights.max())
        state = {"x": torch.zeros(dg.n, 1, device=device)}
        state["x"] = forward_scores(model, dg, ws, state["x"])
        synchronize(device)
        t_load = time.perf_counter() - t0

        def step():
            state["x"] = forward_scores(model, dg, ws, state["x"])

        dt = min(seconds_per_call(step, device, args.iters)
                 for _ in range(args.batches))
        e = int(dg.indices.numel())
        row = {"parts": p, "n_slice": n_slice, "e_slice": e,
               "per_slice_edges_per_s": round(e / dt),
               "projected_pod_edges_per_s": round(e * p / dt),
               "t_load_s": round(t_load, 3), "t_iter_ms": dt * 1e3}
        if device.type == "cuda":
            row.update(k1_on_slice(dg, seed=p))
        rows.append(row)
        print(json.dumps(row), flush=True)
        del dg, state
    out = {"n": args.n, "deg": args.deg, "device": str(device),
           "device_name": (torch.cuda.get_device_name(device)
                           if device.type == "cuda" else "cpu"),
           "rows": rows}
    with open(args.out or default_out("er_slice_bench.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
