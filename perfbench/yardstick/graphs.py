"""The benchmark's instances, made here so that no change to the program can
change them.

``road_csr`` is a frozen copy of the road-network-like generator of the
JAX package's ``bench.py`` (and of ``gnn_mwvc_tpu_torch.graph.
build_road_graph``): a side x side grid with 8-neighbourhoods, 5% random
local shortcuts and weights uniform in 1..1000.  It draws the same numbers
in the same order, so a seed gives the same graph, but it builds the
symmetric CSR with one-dimensional sorts of int64 keys, which is several
times faster than the row-wise ``np.unique`` and ``np.lexsort`` there.
"""

from __future__ import annotations

import numpy as np

__all__ = ["road_csr", "rule_labels"]


def road_csr(side: int, seed: int = 42, extra: float = 0.05):
    """(weights (n,) int64, indptr (n+1,) int64, indices (2m,) int64): the
    symmetric CSR, rows and each row's columns ascending, no self-loops and
    no duplicate edges."""
    rng = np.random.default_rng(seed)
    n = side * side
    ii, jj = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    u = (ii * side + jj).ravel()
    keys = []
    right = u[(jj < side - 1).ravel()]
    keys.append(right * n + right + 1)
    down = u[(ii < side - 1).ravel()]
    keys.append(down * n + down + side)
    diag = u[((ii < side - 1) & (jj < side - 1)).ravel()]
    keys.append(diag * n + diag + side + 1)
    anti = u[((ii < side - 1) & (jj > 0)).ravel()]
    keys.append(anti * n + anti + side - 1)
    ns = int(n * extra)
    a = rng.integers(0, n - 1, size=ns)
    b = np.clip(a + rng.integers(1, 5 * side, size=ns), 0, n - 1)
    keep = a != b
    keys.append(np.minimum(a, b)[keep] * n + np.maximum(a, b)[keep])
    key = np.unique(np.concatenate(keys).astype(np.int64))
    w = rng.integers(1, 1001, size=n).astype(np.int64)
    lo, hi = key // n, key % n
    both = np.sort(np.concatenate([key, hi * n + lo]))
    rows, cols = both // n, both % n
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
    return w, indptr, cols


def rule_labels(weights, indptr, indices) -> np.ndarray:
    """0/1 per vertex, float32: 1 where the vertex weighs less than the
    mean of its neighbours' weights (a vertex with no neighbour gets 0).
    The training cell's labels: cheap, set by the instance alone, and
    roughly balanced on the road family."""
    deg = np.diff(indptr)
    rows = np.repeat(np.arange(len(weights)), deg)
    nw = np.bincount(rows, weights=np.asarray(weights, np.float64)[indices],
                     minlength=len(weights))
    return ((np.asarray(weights, np.float64) * deg < nw)
            & (deg > 0)).astype(np.float32)
