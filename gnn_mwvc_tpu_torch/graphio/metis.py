"""METIS vertex-weighted graph format (the reference's dialect).

First line ``N E 10`` (10 = vertex weights), then one line per vertex: its
weight followed by its 1-indexed neighbours.  As in the JAX package, only
neighbours v > u are kept, then sorted and deduplicated, so self-loops and
one-sided entries drop out the same way.  The vertex lines are read in one
native pass of the port's core (``core/src/metisio.hpp``), which builds the
canonical symmetric CSR directly.
"""

from __future__ import annotations

import io

import numpy as np

from gnn_mwvc_tpu_torch.core import read_metis_csr
from gnn_mwvc_tpu_torch.graph import Graph

__all__ = ["read_metis", "write_metis"]


def _read_bytes(path_or_buf) -> bytes:
    """The whole content of a path or of an open (text or binary) file."""
    if hasattr(path_or_buf, "read"):
        data = path_or_buf.read()
        return data.encode() if isinstance(data, str) else data
    with open(path_or_buf, "rb") as f:
        return f.read()


def read_metis(path_or_buf, stats=None) -> Graph:
    """The graph of a METIS file (a path or an open file).  ``stats``, a
    dict, receives ``rows_sorted``: the vertex lines whose kept neighbours
    were not already strictly ascending and had to be sorted or
    deduplicated (0 for a file written from a sorted CSR)."""
    data = _read_bytes(path_or_buf)
    header_end = data.find(b"\n")
    n = int(data[:header_end].split()[0])
    rows_sorted = 0
    if n == 0:
        g = Graph(np.zeros(0, dtype=np.int64), None)
    else:
        weights, indptr, indices, rows_sorted = read_metis_csr(
            data, header_end + 1, n)
        g = Graph.from_csr(weights, indptr, indices)
    if stats is not None:
        stats["rows_sorted"] = rows_sorted
    return g


def write_metis(path_or_buf, g: Graph) -> None:
    out = io.StringIO()
    out.write(f"{g.n} {g.m} 10\n")
    for u in range(g.n):
        nbrs = g.neighbors(u) + 1
        out.write(" ".join([str(int(g.weights[u]))] + list(map(str, nbrs.tolist())))
                  + "\n")
    if hasattr(path_or_buf, "write"):
        path_or_buf.write(out.getvalue())
    else:
        with open(path_or_buf, "w") as f:
            f.write(out.getvalue())
