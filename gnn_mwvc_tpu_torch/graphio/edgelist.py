"""The training-data edge-list format: ``E N``, then the N vertex weights,
then E edges with 1-indexed endpoints (the reference's ``gnn_train``
input).  Reversed pairs, duplicates and self-loops are canonicalised away,
as in the JAX package's ``read_edge_graph``.
"""

from __future__ import annotations

import numpy as np

from gnn_mwvc_tpu_torch.graph import Graph
from gnn_mwvc_tpu_torch.graphio.metis import _read_bytes

__all__ = ["read_edge_graph", "write_edge_graph"]


def read_edge_graph(path_or_buf) -> Graph:
    tokens = np.array(_read_bytes(path_or_buf).split(), dtype=np.int64)
    e, n = int(tokens[0]), int(tokens[1])
    weights = tokens[2:2 + n]
    uv = tokens[2 + n:2 + n + 2 * e].reshape(e, 2) - 1
    u = np.minimum(uv[:, 0], uv[:, 1])
    v = np.maximum(uv[:, 0], uv[:, 1])
    keep = u != v
    edges = np.stack([u[keep], v[keep]], axis=1)
    if len(edges):
        edges = np.unique(edges, axis=0)
    return Graph(weights, edges)


def write_edge_graph(path_or_buf, g: Graph) -> None:
    own = not hasattr(path_or_buf, "write")
    f = open(path_or_buf, "w") if own else path_or_buf
    try:
        f.write(f"{g.m} {g.n}\n")
        f.write(" ".join(map(str, g.weights.tolist())) + " \n")
        for u, v in g.edge_array() + 1:
            f.write(f"{u} {v}\n")
    finally:
        if own:
            f.close()
