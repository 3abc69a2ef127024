"""Standalone 2-phase approximation solver (reference:
old_files/src/apps/approximation_solver.cpp): primal-dual edge-pricing
construction, then the neighbourhood-improvement pass, both in the native
core.  No time budget and no device: one deterministic pass, useful as a
warm start or a fast baseline."""

from __future__ import annotations

import time

from gnn_mwvc_tpu_torch.core import approx_cover, improve_cover
from gnn_mwvc_tpu_torch.graph import Graph
from gnn_mwvc_tpu_torch.graphio import is_vertex_cover

__all__ = ["approximate_solve"]


def approximate_solve(g: Graph):
    """Returns (cover ndarray, cost, seconds)."""
    t0 = time.perf_counter()
    edges = g.edge_array()
    _, vc = approx_cover(g.weights, edges)
    cost, vc = improve_cover(g.weights, edges, vc)
    dt = time.perf_counter() - t0
    if not is_vertex_cover(g, vc):
        raise RuntimeError("approximation produced an invalid cover")
    return vc, cost, dt
