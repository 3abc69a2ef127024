"""Scoring throughput of the GNN forward, directed edges per second.

    python -m gnn_mwvc_tpu_torch.bench [--device cuda]

Prints ONE JSON line, with the keys of the JAX package's ``bench.py``:

    {"metric": "gnn_score_edges_per_s", "value": N, "unit": "edges/s",
     "vs_baseline": R}

Workload, as ``bench.py``'s: ``build_road_graph(BENCH_SIDE)`` (default
1200: 1,440,000 nodes, 11,649,500 directed edges) relabelled by
``cluster_order``, scored by the published 21-layer model with the solver's
forward (``x_is_node_weights=True``: the first graph layer reads NW, the
other two aggregate through K1) at ``precision="highest"``, unmasked.

Each call's input is chained on the previous call's output, the best of
``BENCH_BATCHES`` (default 4) batches of ``BENCH_ITERS`` (default 5) calls
is kept, and each batch is timed between two ``torch.cuda.synchronize``.

vs_baseline: the reference's C++ forward on the same graph, measured by
its ``bench_predict`` binary in ``gnn_mwvc_oracle/`` of the temporary
directory when it exists; else ``REFERENCE_EDGES_PER_S``.  Build it there
with ``OUT=${TMPDIR:-/tmp}/gnn_mwvc_oracle bash
tests/oracle/build_oracle.sh`` (the script's own default is
``/tmp/gnn_mwvc_oracle``).  Standard error says which baseline was used.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

from gnn_mwvc_tpu_torch.core import cluster_order
from gnn_mwvc_tpu_torch.graph import (DeviceGraph, build_road_graph,
                                      resolve_device)
from gnn_mwvc_tpu_torch.graphio import write_metis
from gnn_mwvc_tpu_torch.models import pretrained_model

__all__ = ["REFERENCE_EDGES_PER_S", "measure_reference", "main"]

# The reference C++ forward (single-threaded, OpenBLAS sgemm) on a host
# CPU, road workload, as the JAX package's bench.py records it: a CPU
# number, the yardstick of the ratio, not a measurement of any card.
REFERENCE_EDGES_PER_S = 4.78e6
ORACLE_DIR = os.path.join(tempfile.gettempdir(), "gnn_mwvc_oracle")


def measure_reference(g) -> float:
    """The reference forward's edges/s on ``g`` (the oracle binary, 3
    rounds), or ``REFERENCE_EDGES_PER_S`` when the binary is absent or
    fails."""
    oracle = os.path.join(ORACLE_DIR, "bench_predict")
    if not os.path.exists(oracle):
        return REFERENCE_EDGES_PER_S
    path = os.path.join(ORACLE_DIR, f"bench_road_{g.n}.metis")
    try:
        if not os.path.exists(path):
            write_metis(path, g)
        out = subprocess.run([oracle, path, "3"], capture_output=True,
                             text=True, timeout=600, check=True)
        sec, edges = out.stdout.split()
        return float(edges) / float(sec)
    except (OSError, ValueError, subprocess.SubprocessError):
        return REFERENCE_EDGES_PER_S


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    side = int(os.environ.get("BENCH_SIDE", 1200))
    iters = int(os.environ.get("BENCH_ITERS", 5))
    batches = int(os.environ.get("BENCH_BATCHES", 4))

    g = build_road_graph(side)
    ref = measure_reference(g)  # on the graph before the relabel (same E)
    g = g.reorder(cluster_order(g.indptr, g.indices))
    dg = DeviceGraph.from_graph(g, device)
    model = pretrained_model(device)
    ws = float(g.weights.max())
    x0 = (dg.weights / ws).reshape(-1, 1)

    def step(xcol):
        out = model(x0 + xcol * 1e-12, dg, ws, x_is_node_weights=True,
                    precision="highest")
        return out[:, :1]

    xcol = step(torch.zeros_like(x0))  # warm-up
    _sync(device)
    dt = float("inf")
    for _ in range(batches):
        t0 = time.perf_counter()
        for _ in range(iters):
            xcol = step(xcol)
        _sync(device)
        dt = min(dt, (time.perf_counter() - t0) / iters)
    edges_per_s = len(g.indices) / dt
    print("vs_baseline: " + ("the recorded reference rate"
                             if ref == REFERENCE_EDGES_PER_S else
                             f"{ORACLE_DIR}/bench_predict on this graph"),
          file=sys.stderr)
    print(json.dumps({"metric": "gnn_score_edges_per_s",
                      "value": round(edges_per_s), "unit": "edges/s",
                      "vs_baseline": round(edges_per_s / ref, 3)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
