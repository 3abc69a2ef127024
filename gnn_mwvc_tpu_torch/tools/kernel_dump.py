"""Dump the phase-1 kernel (residual graph and initial cover) of an instance
for local-search experiments (``tools/ls_run.py``).

Runs phase 1 once (``gnn_peel`` with the sticky scorer on ``--device``,
after a ``cluster_order`` relabel), unfolds to the kernel and writes the
local search's input, in the JAX package's ``tools/kernel_dump.py``
formats, so a file from either package loads in the other:

  * ``STEM.kern``, little-endian: 8s magic ``b"MWVCKRN1"``, u32 n, u32 m,
    u64 initial_cost, then n x u32 weights, m x u32 eu, m x u32 ev,
    n x u8 s0;
  * ``STEM.npz``: ``weights``, ``eu``, ``ev``, ``s0``, ``initial_cost``,
    ``cost_gnn`` (the cost after the peel), ``t_phase1``.

Instances: ``roadNNN`` (``build_road_graph(NNN)``) and ``erN_dD``
(``random_graph(N, D, seed=7)``).

Usage:
    python -m gnn_mwvc_tpu_torch.tools.kernel_dump --instance road900 \\
        --out k_road900 [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import struct
import sys
import time

import numpy as np

from gnn_mwvc_tpu_torch.core import CoreSolver, cluster_order
from gnn_mwvc_tpu_torch.graph import Graph, build_road_graph, random_graph
from gnn_mwvc_tpu_torch.solver.pipeline import gnn_peel, resolve_device
from gnn_mwvc_tpu_torch.solver.static_score import StickyGnnScorer

__all__ = ["MAGIC", "build_instance", "main", "read_kernel", "write_kernel"]

MAGIC = b"MWVCKRN1"


def build_instance(name: str) -> Graph:
    if name.startswith("road") and name[4:].isdigit():
        return build_road_graph(int(name[4:]))
    if name.startswith("er") and "_d" in name:
        n, d = name[2:].split("_d")
        return random_graph(int(float(n)), int(d), seed=7)
    raise SystemExit(f"unknown instance {name}")


def write_kernel(path, weights, eu, ev, s0, initial_cost):
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<IIQ", len(weights), len(eu), initial_cost))
        for a, dtype in ((weights, np.uint32), (eu, np.uint32),
                         (ev, np.uint32), (s0, np.uint8)):
            f.write(np.ascontiguousarray(a, dtype).tobytes())


def read_kernel(path):
    """(weights, eu, ev, s0, initial_cost) of a ``.kern`` file."""
    with open(path, "rb") as f:
        if f.read(8) != MAGIC:
            raise ValueError(f"{path}: not an {MAGIC.decode()} file")
        n, m, c0 = struct.unpack("<IIQ", f.read(16))
        w = np.frombuffer(f.read(4 * n), np.uint32)
        eu = np.frombuffer(f.read(4 * m), np.uint32)
        ev = np.frombuffer(f.read(4 * m), np.uint32)
        s0 = np.frombuffer(f.read(n), np.uint8)
    if len(s0) != n:
        raise ValueError(f"{path}: truncated")
    return w, eu, ev, s0, c0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--instance", default="road900")
    ap.add_argument("--out", required=True, help="output path stem")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    g = build_instance(args.instance)
    g = g.reorder(cluster_order(g.indptr, g.indices))

    t0 = time.perf_counter()
    weight_scale = float(g.weights.max())
    core = CoreSolver(g.weights, g.edge_array())
    t_kernel, _size, initial_cost, split = gnn_peel(
        core, StickyGnnScorer(device=device), weight_scale)
    core.unfold(t_kernel)
    t_phase1 = time.perf_counter() - t0

    snap = core.snapshot()
    rows = np.repeat(np.arange(snap.n, dtype=np.int64),
                     np.diff(snap.indptr.astype(np.int64)))
    keep = rows < snap.indices
    eu = rows[keep].astype(np.uint32)
    ev = snap.indices[keep].astype(np.uint32)
    s0 = np.array([core.decided(u) == 1 for u in snap.ids], dtype=np.uint8)

    write_kernel(args.out + ".kern", snap.weights, eu, ev, s0, initial_cost)
    np.savez_compressed(args.out + ".npz", weights=snap.weights, eu=eu, ev=ev,
                        s0=s0, initial_cost=initial_cost,
                        cost_gnn=core.cost, t_phase1=t_phase1)
    print(f"instance={args.instance} kernel n={snap.n} m={len(eu)} "
          f"initial_cost={initial_cost} cost_after_peel={core.cost} "
          f"t_phase1={t_phase1:.1f}s -> {args.out}.kern")
    print(json.dumps({"instance": args.instance, "kern": args.out + ".kern",
                      "n": int(snap.n), "m": int(len(eu)),
                      "initial_cost": int(initial_cost),
                      "cost_after_peel": int(core.cost),
                      "t_phase1": t_phase1, "rounds": split["rounds"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
