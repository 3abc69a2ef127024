"""Edge-list ("E N") format, MatrixMarket ingestion and weight generation:
the reference's data-prep chain.

* ``read_edge_graph`` / ``write_edge_graph``: the training-data format ``E
  N``, then the N vertex weights, then E edges with 1-indexed endpoints
  (the reference's ``gnn_train`` input).  Reversed pairs, duplicates and
  self-loops are canonicalised away.
* ``read_mtx_edges``: MatrixMarket coordinate and array files (the
  reference vendors NIST's ``mmio`` C library for this).
* ``gen_weights``: MTX edge list -> weighted instance with U[min, max]
  integer weights, seed = N when seed == -1, deduplicated, no self-loops
  (reference: old_files/src/apps/gen_weights.cpp:39-66).
* ``mtx_to_metis``: "E N" file -> METIS file (reference:
  old_files/src/apps/mtx_to_graph.cpp:26-52).

Every function gives the JAX package's ``graphio/edgelist.py`` result, byte
for byte where it writes a file.
"""

from __future__ import annotations

import numpy as np

from gnn_mwvc_tpu_torch.graph import Graph
from gnn_mwvc_tpu_torch.graphio.metis import _read_bytes, write_metis

__all__ = ["read_edge_graph", "write_edge_graph", "read_mtx_edges",
           "gen_weights", "mtx_to_metis"]


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


_MM_FIELDS = ("real", "integer", "pattern", "complex")
_MM_SYMMETRIES = ("general", "symmetric", "skew-symmetric", "hermitian")


def read_mtx_edges(path_or_buf, with_values: bool = False):
    """Parse a MatrixMarket file -> (n, edges 1-indexed, as read) or, with
    ``with_values=True``, (n, edges, values float64).

    The banner grammar of NIST's mmio: ``%%MatrixMarket matrix
    coordinate|array <field> <symmetry>``, field in real/integer/pattern/
    complex, symmetry in general/symmetric/skew-symmetric/hermitian.  A file
    without a banner is coordinate pattern general.  Symmetric variants store
    one triangle, and each entry is one undirected edge either way.  Values
    (real: 1 column, complex: 2, the real part kept) are read only on
    request; pattern entries have none (1.0).  The coordinate size line is
    ``N M E`` with n = max(N, M).  ``array`` (dense) files list one entry
    per line in column-major order, the lower triangle only for the
    symmetric variants; their nonzero entries become edges.
    """
    data = _read_bytes(path_or_buf)
    lines = data.split(b"\n")
    i = 0
    field, symmetry = "pattern", "general"
    if lines and lines[0].lstrip().lower().startswith(b"%%matrixmarket"):
        banner = lines[0].split()
        if len(banner) < 5:
            raise ValueError(f"malformed MatrixMarket banner: {lines[0]!r}")
        obj, fmt = banner[1].lower(), banner[2].lower()
        field, symmetry = banner[3].decode().lower(), banner[4].decode().lower()
        if obj != b"matrix":
            raise ValueError(f"unsupported MatrixMarket object {obj!r}")
        if fmt not in (b"coordinate", b"array"):
            raise ValueError(f"unsupported MatrixMarket format {fmt!r}")
        if field not in _MM_FIELDS:
            raise ValueError(f"unsupported MatrixMarket field {field!r}")
        if symmetry not in _MM_SYMMETRIES:
            raise ValueError(f"unsupported MatrixMarket symmetry {symmetry!r}")
        if fmt == b"array" and field == "pattern":
            raise ValueError(
                "MatrixMarket 'array' format cannot carry a 'pattern' "
                "field (every dense entry needs a value)")
    else:
        fmt = b"coordinate"
    while i < len(lines) and (not lines[i].strip()
                              or lines[i].lstrip().startswith(b"%")):
        i += 1
    if i >= len(lines):
        raise ValueError("MatrixMarket file has no size line")
    if fmt == b"array":
        return _read_mtx_array(lines, i, field, symmetry, with_values)
    header = lines[i].split()
    n_rows, n_cols, e = int(header[0]), int(header[1]), int(header[2])
    n = max(n_rows, n_cols)
    body_lines = [ln for ln in lines[i + 1:] if ln.strip()][:e]
    if len(body_lines) < e:
        raise ValueError(f"expected {e} entries, found {len(body_lines)}")
    us = np.empty(e, dtype=np.int64)
    vs = np.empty(e, dtype=np.int64)
    vals = np.ones(e, dtype=np.float64) if with_values else None
    for k, ln in enumerate(body_lines):
        parts = ln.split()
        if len(parts) < 2:
            raise ValueError(f"malformed entry line {ln!r}")
        us[k] = int(parts[0])
        vs[k] = int(parts[1])
        if with_values and field != "pattern":
            if len(parts) < 3:
                raise ValueError(f"{field} entry missing value: {ln!r}")
            vals[k] = float(parts[2])  # complex: the real part
    if (us > n_rows).any() or (vs > n_cols).any() or (us < 1).any() \
            or (vs < 1).any():
        raise ValueError("MatrixMarket entry index out of range")
    if symmetry == "skew-symmetric" and (us == vs).any():
        raise ValueError("skew-symmetric matrix carries a diagonal entry")
    edges = np.stack([us, vs], axis=1)
    return (n, edges, vals) if with_values else (n, edges)


def _read_mtx_array(lines, i, field, symmetry, with_values):
    """Dense ``array`` body: size line ``N M``, then one entry per line in
    column-major order; the symmetric variants store the lower triangle
    (without the diagonal for skew-symmetric).  Nonzero entries become
    1-indexed (row, col) edges."""
    header = lines[i].split()
    if len(header) < 2:
        raise ValueError(f"malformed array size line {lines[i]!r}")
    n_rows, n_cols = int(header[0]), int(header[1])
    if symmetry != "general" and n_rows != n_cols:
        raise ValueError(f"{symmetry} array matrix must be square")
    if symmetry == "general":
        expect = n_rows * n_cols
    elif symmetry == "skew-symmetric":
        expect = n_rows * (n_rows - 1) // 2
    else:  # symmetric / hermitian
        expect = n_rows * (n_rows + 1) // 2
    per = 2 if field == "complex" else 1
    toks = b" ".join(
        ln for ln in lines[i + 1:]
        if ln.strip() and not ln.lstrip().startswith(b"%")).split()
    if len(toks) < per * expect:
        raise ValueError(
            f"expected {expect} array entries, found {len(toks) // per}")
    vals = np.array(toks[:per * expect], dtype=np.float64)
    nz = (vals.reshape(-1, per) != 0).any(axis=1)
    vals = vals.reshape(-1, per)[:, 0]  # complex: the real part
    # column-major entry k -> (row, col), 1-indexed
    if symmetry == "general":
        rows = np.arange(expect, dtype=np.int64) % n_rows + 1
        cols = np.arange(expect, dtype=np.int64) // n_rows + 1
    else:
        lo = 1 if symmetry == "skew-symmetric" else 0
        cols = np.repeat(np.arange(1, n_cols + 1, dtype=np.int64),
                         np.arange(n_rows, 0, -1) - lo)
        starts = np.cumsum(np.concatenate(
            [[0], np.arange(n_rows, 0, -1)[:-1] - lo]))
        rows = (np.arange(expect, dtype=np.int64)
                - np.repeat(starts, np.arange(n_rows, 0, -1) - lo)
                + cols + lo)
    keep = np.nonzero(nz)[0]
    n = max(n_rows, n_cols)
    edges = np.stack([rows[keep], cols[keep]], axis=1)
    return (n, edges, vals[keep]) if with_values else (n, edges)


def gen_weights(n: int, edges_1idx: np.ndarray, wmin: int, wmax: int,
                seed: int) -> Graph:
    """Assign U[wmin, wmax] integer weights; seed == -1 means seed = N.

    numpy's MT19937, as in the JAX package, so both give the same weights
    for the same seed (the stream is not std::mt19937's; neither standard
    fixes it, and it is not a compatibility surface with the reference).
    """
    u = np.minimum(edges_1idx[:, 0], edges_1idx[:, 1]) - 1
    v = np.maximum(edges_1idx[:, 0], edges_1idx[:, 1]) - 1
    keep = u != v
    edges = np.stack([u[keep], v[keep]], axis=1)
    if len(edges):
        edges = np.unique(edges, axis=0)
    rng = np.random.Generator(np.random.MT19937(n if seed == -1 else seed))
    weights = rng.integers(wmin, wmax, size=n, endpoint=True, dtype=np.int64)
    return Graph(weights, edges)


def mtx_to_metis(in_path, out_path) -> None:
    """Convert an ``E N`` edge-graph file to METIS."""
    write_metis(out_path, read_edge_graph(in_path))
