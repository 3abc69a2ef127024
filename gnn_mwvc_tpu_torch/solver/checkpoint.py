"""Solve-state checkpoint and resume.

The reference writes its result once at the end and cannot resume
(reference: src/GNN_VC.cpp:385-388).  Here every checkpoint is a valid full
cover of the original graph plus metadata, written atomically, so a killed
run leaves its best cover so far on disk, and ``resume_solve`` warm-starts
the anytime local search from it.

The file format is the JAX package's: an ``.npz`` with ``cover`` (int8) and
``meta`` (JSON), and a fingerprint over the raw bytes of the graph's
``weights``/``indptr``/``indices``.  Both packages' ``Graph`` hold the same
int64 arrays for the same input, so a checkpoint written by one loads in the
other.
"""

from __future__ import annotations

import hashlib
import json
import os
import time

import numpy as np

from gnn_mwvc_tpu_torch.core import CoreLocalSearch
from gnn_mwvc_tpu_torch.graph import Graph
from gnn_mwvc_tpu_torch.graphio import cover_cost, is_vertex_cover

__all__ = ["graph_fingerprint", "save_checkpoint", "load_checkpoint",
           "resume_solve"]


def graph_fingerprint(g: Graph) -> str:
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(g.weights).tobytes())
    h.update(np.ascontiguousarray(g.indptr).tobytes())
    h.update(np.ascontiguousarray(g.indices).tobytes())
    return h.hexdigest()[:16]


def save_checkpoint(path: str, g: Graph, cover: np.ndarray, cost: int,
                    elapsed: float, extra: dict | None = None) -> None:
    """Write ``cover`` of ``g`` atomically; refuses an invalid cover or a
    cost that is not the cover's."""
    if not is_vertex_cover(g, cover):
        raise ValueError("refusing to checkpoint an invalid cover")
    if cover_cost(g, cover) != cost:
        raise ValueError(f"cost {cost} is not the cover's "
                         f"{cover_cost(g, cover)}")
    tmp = path + ".tmp"
    meta = {"fingerprint": graph_fingerprint(g), "cost": int(cost),
            "elapsed": float(elapsed), "n": int(g.n), **(extra or {})}
    np.savez_compressed(tmp + ".npz", cover=np.asarray(cover, dtype=np.int8),
                        meta=json.dumps(meta))
    os.replace(tmp + ".npz", path)


def load_checkpoint(path: str, g: Graph | None = None):
    """Returns (cover, meta); validates against ``g`` when given."""
    with np.load(path, allow_pickle=False) as z:
        cover = z["cover"]
        meta = json.loads(str(z["meta"]))
    if g is not None:
        if meta["fingerprint"] != graph_fingerprint(g):
            raise ValueError("checkpoint does not match this graph")
        if not is_vertex_cover(g, cover):
            raise ValueError("checkpoint cover is invalid")
    return cover, meta


def resume_solve(g: Graph, checkpoint_path: str, time_limit: float,
                 checkpoint_interval: float = 60.0):
    """Continue the anytime local search from a checkpointed cover, over
    the full original graph (no re-kernelisation is needed for
    correctness), re-checkpointing improvements.  Returns (best cover,
    best cost, best seen)."""
    cover, meta = load_checkpoint(checkpoint_path, g)
    t0 = time.perf_counter()
    base_elapsed = meta.get("elapsed", 0.0)
    ls = CoreLocalSearch(g.weights, g.edge_array(),
                         np.asarray(cover, dtype=np.uint8))
    step_size = 1 << 16
    last_ckpt = t0
    while time.perf_counter() - t0 < time_limit:
        remaining = time_limit - (time.perf_counter() - t0)
        improved = ls.search(step_size, remaining)
        step_size = (min(step_size * 2, 1 << 16) if improved
                     else max(step_size // 2, 1 << 10))
        now = time.perf_counter()
        if improved and now - last_ckpt >= checkpoint_interval:
            save_checkpoint(checkpoint_path, g, ls.best(), ls.best_cost,
                            base_elapsed + (now - t0))
            last_ckpt = now
    best = ls.best()
    if ls.best_cost <= meta["cost"]:
        save_checkpoint(checkpoint_path, g, best, ls.best_cost,
                        base_elapsed + (time.perf_counter() - t0))
    return best, ls.best_cost, ls.best_seen
