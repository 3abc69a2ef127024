"""Graph containers: a numpy CSR on the host, tensors on one device.

``Graph`` keeps the JAX package's canonical form (unique undirected edges,
u < v, sorted; both directions in the CSR, rows sorted), so both packages see
the same vertex and edge order for the same input.

``DeviceGraph`` is the CSR the GNN forward reads on a torch device.  It is
not padded to shape buckets: PyTorch runs eagerly and compiles nothing per
shape, so every array has exactly the graph's size.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gnn_mwvc_tpu_torch.core import relabel_csr

__all__ = ["Graph", "DeviceGraph", "build_road_graph", "geometric_graph",
           "neighbour_weight_sum", "powerlaw_graph", "random_graph",
           "reorder_plain"]


def neighbour_weight_sum(weights_f32: np.ndarray, rows: np.ndarray,
                         indices: np.ndarray) -> np.ndarray:
    """NW(u), the float32 sum of u's neighbours' weights, added in CSR order
    with a rounding at every add, as the JAX package's ``DeviceGraph.build``
    adds it (``np.add.at``).  The order matters once NW passes 2^24, where
    float32 no longer holds every integer.  rows: the row of each CSR entry
    (sorted); the result has ``len(weights_f32)`` entries."""
    nw = np.zeros(len(weights_f32), dtype=np.float32)
    if len(indices):
        np.add.at(nw, rows, np.asarray(weights_f32, np.float32)[indices])
    return nw


class Graph:
    """Undirected vertex-weighted graph in CSR form (host side, numpy).

    weights: (N,) integer vertex weights.  edges: (M, 2) undirected edges;
    duplicates, reversed pairs and self-loops are canonicalised away.
    """

    __slots__ = ("n", "m", "weights", "indptr", "indices", "_nw")

    def __init__(self, weights: np.ndarray, edges: np.ndarray | None):
        weights = np.asarray(weights)
        self.n = int(weights.shape[0])
        self.weights = weights
        if edges is None or len(edges) == 0:
            edges = np.zeros((0, 2), dtype=np.int64)
        edges = np.asarray(edges)
        if len(edges):
            key = edges[:, 0].astype(np.int64) * self.n + edges[:, 1]
            canonical = bool((edges[:, 0] < edges[:, 1]).all()
                             and (key[1:] > key[:-1]).all())
            if not canonical:
                e = np.sort(edges.astype(np.int64), axis=1)
                edges = np.unique(e[e[:, 0] != e[:, 1]], axis=0)
        self.m = int(edges.shape[0])
        row = np.concatenate([edges[:, 0], edges[:, 1]])
        col = np.concatenate([edges[:, 1], edges[:, 0]])
        order = np.lexsort((col, row))
        row, col = row[order], col[order]
        self.indptr = np.zeros(self.n + 1, dtype=np.int64)
        np.cumsum(np.bincount(row, minlength=self.n), out=self.indptr[1:])
        self.indices = col.astype(np.int64)
        self._nw = None

    @classmethod
    def from_csr(cls, weights, indptr, indices) -> "Graph":
        """Wrap a symmetric CSR with sorted rows as it is (not checked)."""
        g = cls.__new__(cls)
        g.weights = np.asarray(weights)
        g.n = int(len(g.weights))
        g.indptr = np.asarray(indptr, dtype=np.int64)
        g.indices = np.asarray(indices, dtype=np.int64)
        g.m = int(len(g.indices) // 2)
        g._nw = None
        return g

    @property
    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    @property
    def neighborhood_weights(self) -> np.ndarray:
        """NW(u), the exact int64 sum of u's neighbours' weights (cached)."""
        if self._nw is None:
            nw = np.zeros(self.n, dtype=np.int64)
            np.add.at(nw, self.row_ids(), self.weights[self.indices])
            self._nw = nw
        return self._nw

    def row_ids(self) -> np.ndarray:
        """Expanded row index per CSR entry."""
        return np.repeat(np.arange(self.n, dtype=np.int64), self.degrees)

    def neighbors(self, u: int) -> np.ndarray:
        return self.indices[self.indptr[u]:self.indptr[u + 1]]

    def edge_array(self) -> np.ndarray:
        """(M, 2) array of unique edges with u < v."""
        rows = self.row_ids()
        keep = rows < self.indices
        return np.stack([rows[keep], self.indices[keep]], axis=1)

    def reorder(self, perm: np.ndarray) -> "Graph":
        """Relabel vertices: perm[i] = old id placed at new position i.
        The native core relabels the CSR row by row (``relabel_csr``)."""
        perm = np.asarray(perm, dtype=np.int64)
        indptr, indices = relabel_csr(self.indptr, self.indices, perm)
        return Graph.from_csr(self.weights[perm], indptr, indices)

    def __repr__(self) -> str:
        return f"Graph(n={self.n}, m={self.m})"


def reorder_plain(g: Graph, perm: np.ndarray) -> Graph:
    """``g.reorder(perm)`` in numpy: the edges relabelled and
    re-canonicalised through ``Graph``: the same CSR as ``reorder``, found
    another way, which the tests hold the native relabel against."""
    perm = np.asarray(perm, dtype=np.int64)
    inv = np.empty(g.n, dtype=np.int64)
    inv[perm] = np.arange(g.n)
    return Graph(g.weights[perm], np.sort(inv[g.edge_array()], axis=1))


@dataclasses.dataclass(frozen=True)
class DeviceGraph:
    """Symmetric CSR plus per-node features, all on one torch device.

    indptr (n+1,) / indices (nnz,) int32; weights, degrees, nw (n,) float32
    (raw vertex weight, degree, neighbourhood weight sum).
    """

    n: int
    indptr: torch.Tensor
    indices: torch.Tensor
    weights: torch.Tensor
    degrees: torch.Tensor
    nw: torch.Tensor

    @staticmethod
    def build(weights, indptr, indices, device, nw=None) -> "DeviceGraph":
        """nw: the neighbourhood weight sums where the caller has them (a
        core snapshot's, which the sticky scorers replace with the live
        ones anyway); else summed here in the JAX package's order."""
        weights = np.asarray(weights)
        indptr = np.asarray(indptr, dtype=np.int64)
        indices = np.asarray(indices, dtype=np.int64)
        n = len(weights)
        # the kernels index x by these without bounds checks
        if indptr.shape != (n + 1,) or indptr[-1] != len(indices):
            raise ValueError("indptr does not describe a CSR over the nodes")
        if len(indices) and (indices.min() < 0 or indices.max() >= n):
            raise ValueError("CSR column index out of range")
        if len(indices) >= 2**31:
            raise ValueError(f"{len(indices)} directed edges overflow int32")
        deg = np.diff(indptr)
        w32 = weights.astype(np.float32)
        if nw is None:
            rows = np.repeat(np.arange(n, dtype=np.int64), deg)
            nw = neighbour_weight_sum(w32, rows, indices)
        elif np.shape(nw) != (n,):
            raise ValueError(f"nw has shape {np.shape(nw)}, not ({n},)")

        def put(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

        return DeviceGraph(
            n=n, indptr=put(indptr, np.int32), indices=put(indices, np.int32),
            weights=put(w32, np.float32), degrees=put(deg, np.float32),
            nw=put(nw, np.float32))

    @staticmethod
    def from_graph(g: Graph, device) -> "DeviceGraph":
        return DeviceGraph.build(g.weights, g.indptr, g.indices, device)


def build_road_graph(side: int, seed: int = 42, extra: float = 0.05) -> Graph:
    """Road-network-like workload: a side x side grid with 8-neighbourhoods
    plus 5% random local shortcuts and weights in [1, 1000].  The same
    generator (and, for a given seed, the same graph) as the JAX package's
    ``bench.py``; side 1200 gives 1,440,000 nodes."""
    rng = np.random.default_rng(seed)
    n = side * side
    ii, jj = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    u = (ii * side + jj).ravel()
    edges = []
    right = u[(jj < side - 1).ravel()]
    edges.append(np.stack([right, right + 1], 1))
    down = u[(ii < side - 1).ravel()]
    edges.append(np.stack([down, down + side], 1))
    diag = u[((ii < side - 1) & (jj < side - 1)).ravel()]
    edges.append(np.stack([diag, diag + side + 1], 1))
    anti = u[((ii < side - 1) & (jj > 0)).ravel()]
    edges.append(np.stack([anti, anti + side - 1], 1))
    ns = int(n * extra)
    a = rng.integers(0, n - 1, size=ns)
    b = np.clip(a + rng.integers(1, 5 * side, size=ns), 0, n - 1)
    keep = a != b
    edges.append(np.stack([np.minimum(a, b)[keep], np.maximum(a, b)[keep]], 1))
    e = np.unique(np.concatenate(edges, 0), axis=0)
    w = rng.integers(1, 1001, size=n)
    return Graph(w, e)


def random_graph(n: int, avg_deg: int, seed: int = 0,
                 wmax: int = 1000) -> Graph:
    """Random weighted graph from random vertex pairs, weights in [1, wmax]:
    the same generator (and, for a given seed, the same graph) as the
    repository's test helper ``tests/conftest.py::random_graph``."""
    rng = np.random.default_rng(seed)
    m = n * avg_deg // 2
    u = rng.integers(0, n, size=m * 2)
    v = rng.integers(0, n, size=m * 2)
    lo, hi = np.minimum(u, v), np.maximum(u, v)
    keep = lo != hi
    edges = np.unique(np.stack([lo[keep], hi[keep]], axis=1), axis=0)[:m]
    return Graph(rng.integers(1, wmax + 1, size=n), edges)


def powerlaw_graph(n: int, m_attach: int, seed: int,
                   wmax: int = 1000) -> Graph:
    """Preferential-attachment graph, weights in [1, wmax]: the same
    generator (and, for a given seed, the same graph) as the repository's
    ``tools/soak.py::powerlaw_graph``."""
    rng = np.random.default_rng(seed)
    targets = list(range(m_attach))
    repeated = []
    edges = []
    for v in range(m_attach, n):
        for t in targets[:m_attach]:
            edges.append((t, v))
        repeated.extend(targets[:m_attach])
        repeated.extend([v] * m_attach)
        idx = rng.integers(0, len(repeated), size=m_attach)
        targets = [repeated[i] for i in idx]
    e = np.unique(np.sort(np.array(edges), axis=1), axis=0)
    e = e[e[:, 0] != e[:, 1]]
    return Graph(rng.integers(1, wmax + 1, size=n), e)


def geometric_graph(n: int, seed: int = 42, radius_factor: float = 0.55,
                    wmin: int = 1, wmax: int = 200) -> Graph:
    """Random geometric graph of the 10th DIMACS Implementation Challenge
    (``rgg_n_2_X_s0``, generator by Holtgrewe, Sanders and Schulz): n points
    uniform in the unit square, an edge between two points closer than
    ``radius_factor * sqrt(ln n / n)``.  Weights uniform integers in
    [wmin, wmax], the convention of the MWIS/MWVC literature for unweighted
    benchmark graphs (Lamm et al., ALENEX 2019).

    The points come first from ``np.random.default_rng(seed)``, then the
    weights.  Vertex ids stay in the order the points were drawn: no
    spatial sort, so a vertex's neighbours lie anywhere in the id range.
    The close pairs are found by bucketing the points into square cells of
    side at least r and comparing each cell with its neighbouring cells."""
    rng = np.random.default_rng(seed)
    pts = rng.random((n, 2))
    w = rng.integers(wmin, wmax + 1, size=n)
    r = radius_factor * np.sqrt(np.log(n) / n) if n > 1 else 0.0
    lo, hi = _close_pairs(pts, r)
    key = np.sort(np.concatenate([lo * n + hi, hi * n + lo]))
    rows, cols = key // n, key % n
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
    return Graph.from_csr(w, indptr, cols)


def _close_pairs(pts: np.ndarray, r: float):
    """(lo, hi) int64: every pair i < j of points with squared distance
    under r^2, each once."""
    n = len(pts)
    if n < 2 or r <= 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    side = max(1, int(1.0 / r))  # cells per side: a cell's side is >= r
    cx = np.minimum((pts[:, 0] * side).astype(np.int64), side - 1)
    cy = np.minimum((pts[:, 1] * side).astype(np.int64), side - 1)
    order = np.argsort(cx * side + cy, kind="stable")
    cx, cy = cx[order], cy[order]
    start = np.zeros(side * side + 1, dtype=np.int64)
    np.cumsum(np.bincount(cx * side + cy, minlength=side * side),
              out=start[1:])
    pos = np.arange(n, dtype=np.int64)
    los, his = [], []
    # a cell with itself (later points only) and with four of its eight
    # neighbours: every neighbouring pair of cells comes once
    for dx, dy in ((0, 0), (1, -1), (1, 0), (1, 1), (0, 1)):
        nx, ny = cx + dx, cy + dy
        ok = (nx >= 0) & (nx < side) & (ny >= 0) & (ny < side)
        cell = nx[ok] * side + ny[ok]
        first = pos[ok] + 1 if (dx, dy) == (0, 0) else start[cell]
        count = start[cell + 1] - first
        src = np.repeat(pos[ok], count)
        within = np.arange(len(src)) - np.repeat(np.cumsum(count) - count,
                                                 count)
        dst = np.repeat(first, count) + within
        a, b = order[src], order[dst]
        d = pts[a] - pts[b]
        close = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] < r * r
        a, b = a[close], b[close]
        los.append(np.minimum(a, b))
        his.append(np.maximum(a, b))
    return np.concatenate(los), np.concatenate(his)
