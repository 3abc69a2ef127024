"""The benchmark's random geometric instances and the METIS files its
command-line cells read, made here so that no change to the program can
change them.

``rgg_csr`` is a frozen copy of ``gnn_mwvc_tpu_torch.graph.
geometric_graph``: the 10th DIMACS Implementation Challenge's random
geometric graphs (``rgg_n_2_X_s0``): 2^X points uniform in the unit square,
an edge between two points closer than ``radius_factor * sqrt(ln n / n)``,
weights uniform integers in [wmin, wmax].  It draws the same numbers in the
same order, so a seed gives the same graph; vertex ids stay in the order
the points were drawn.

``write_metis`` writes the METIS vertex-weighted format (``N E 10``, then
per vertex its weight and its 1-indexed neighbours), each digit placed by
array arithmetic rather than one string per number.
"""

from __future__ import annotations

import numpy as np

__all__ = ["rgg_csr", "write_metis"]

_OFFSETS = ((0, 0), (1, -1), (1, 0), (1, 1), (0, 1))


def rgg_csr(log2_n: int, seed: int = 42, radius_factor: float = 0.55,
            wmin: int = 1, wmax: int = 200):
    """(weights (n,) int64, indptr (n+1,) int64, indices (2m,) int64): the
    symmetric CSR of the 2^log2_n-point instance, rows and each row's
    columns ascending, no self-loops and no duplicate edges."""
    n = 1 << int(log2_n)
    rng = np.random.default_rng(seed)
    pts = rng.random((n, 2))
    w = rng.integers(wmin, wmax + 1, size=n).astype(np.int64)
    r = radius_factor * np.sqrt(np.log(n) / n) if n > 1 else 0.0
    lo, hi = _pairs(pts, r)
    key = np.sort(np.concatenate([lo * n + hi, hi * n + lo]))
    rows, cols = key // n, key % n
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
    return w, indptr, cols


def _pairs(pts, r):
    """Every pair of points closer than r, once, as (lo, hi) ids: the points
    in square cells of side >= r, each cell against itself and four of its
    eight neighbours."""
    n = len(pts)
    if n < 2 or r <= 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    side = max(1, int(1.0 / r))
    cx = np.minimum((pts[:, 0] * side).astype(np.int64), side - 1)
    cy = np.minimum((pts[:, 1] * side).astype(np.int64), side - 1)
    order = np.argsort(cx * side + cy, kind="stable")
    cx, cy = cx[order], cy[order]
    start = np.zeros(side * side + 1, dtype=np.int64)
    np.cumsum(np.bincount(cx * side + cy, minlength=side * side),
              out=start[1:])
    pos = np.arange(n, dtype=np.int64)
    los, his = [], []
    for dx, dy in _OFFSETS:
        nx, ny = cx + dx, cy + dy
        ok = (nx >= 0) & (nx < side) & (ny >= 0) & (ny < side)
        cell = nx[ok] * side + ny[ok]
        first = pos[ok] + 1 if (dx, dy) == (0, 0) else start[cell]
        count = start[cell + 1] - first
        src = np.repeat(pos[ok], count)
        dst = (np.repeat(first, count) + np.arange(len(src))
               - np.repeat(np.cumsum(count) - count, count))
        a, b = order[src], order[dst]
        d = pts[a] - pts[b]
        close = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] < r * r
        los.append(np.minimum(a[close], b[close]))
        his.append(np.maximum(a[close], b[close]))
    return np.concatenate(los), np.concatenate(his)


def write_metis(path: str, weights, indptr, indices) -> None:
    """The symmetric CSR as a METIS file at ``path``; weights >= 0."""
    weights = np.asarray(weights, np.int64)
    indptr = np.asarray(indptr, np.int64)
    n = len(weights)
    line = indptr[:-1] + np.arange(n)  # each vertex line's first token
    tok = np.empty(n + int(indptr[-1]), np.int64)
    nbr = np.ones(len(tok), bool)
    nbr[line] = False
    tok[line] = weights
    tok[nbr] = np.asarray(indices, np.int64) + 1
    digits = np.ones(len(tok), np.int64)
    rest = tok // 10
    while rest.any():
        digits += rest > 0
        rest //= 10
    end = np.cumsum(digits + 1)  # one past each token's separator
    buf = np.empty(int(end[-1]) if len(end) else 0, np.uint8)
    buf[end - 1] = ord(" ")
    buf[end[line + np.diff(indptr)] - 1] = ord("\n")
    value = tok.copy()
    for k in range(int(digits.max()) if len(digits) else 0):
        has = digits > k
        buf[(end - 2 - k)[has]] = ord("0") + value[has] % 10
        value //= 10
    with open(path, "wb") as f:
        f.write(f"{n} {int(indptr[-1]) // 2} 10\n".encode())
        f.write(buf.tobytes())
