"""METIS vertex-weighted graph format (the reference's dialect).

First line ``N E 10`` (10 = vertex weights), then one line per vertex: its
weight followed by its 1-indexed neighbours.  As in the JAX package, only
neighbours v > u are kept, then sorted and deduplicated, so self-loops and
one-sided entries drop out the same way.
"""

from __future__ import annotations

import io

import numpy as np

from gnn_mwvc_tpu_torch.graph import Graph

__all__ = ["read_metis", "write_metis"]

_WS = (ord(" "), ord("\t"), ord("\r"), ord("\n"))


def _tokenize(body: bytes):
    """(values, line index of each token) for all integer tokens."""
    buf = np.frombuffer(body, dtype=np.uint8)
    is_ws = np.isin(buf, _WS)
    prev_ws = np.empty_like(is_ws)
    prev_ws[0] = True
    prev_ws[1:] = is_ws[:-1]
    tok_pos = np.nonzero(~is_ws & prev_ws)[0]
    nl_pos = np.nonzero(buf == ord("\n"))[0]
    line_of_tok = np.searchsorted(nl_pos, tok_pos, side="left")
    values = np.array(body.split(), dtype=np.int64)
    if len(values) != len(tok_pos):
        raise ValueError("METIS body has non-integer tokens")
    return values, line_of_tok


def _read_bytes(path_or_buf) -> bytes:
    """The whole content of a path or of an open (text or binary) file."""
    if hasattr(path_or_buf, "read"):
        data = path_or_buf.read()
        return data.encode() if isinstance(data, str) else data
    with open(path_or_buf, "rb") as f:
        return f.read()


def read_metis(path_or_buf) -> Graph:
    data = _read_bytes(path_or_buf)
    header_end = data.find(b"\n")
    n = int(data[:header_end].split()[0])
    body = data[header_end + 1:]
    if n == 0:
        return Graph(np.zeros(0, dtype=np.int64), None)

    values, line_of_tok = _tokenize(body)
    counts = np.bincount(line_of_tok, minlength=n)[:n]
    if (counts < 1).any():
        bad = int(np.nonzero(counts < 1)[0][0])
        raise ValueError(f"METIS vertex line {bad + 1} has no weight token")
    starts = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    total = int(starts[-1])
    values = values[:total]

    weights = values[starts[:-1]]
    nbr_mask = np.ones(total, dtype=bool)
    nbr_mask[starts[:-1]] = False
    nbrs = values[nbr_mask] - 1
    rows = np.repeat(np.arange(n, dtype=np.int64), counts - 1)
    keep = nbrs > rows
    edges = np.stack([rows[keep], nbrs[keep]], axis=1)
    if len(edges):
        edges = np.unique(edges, axis=0)
    return Graph(weights, edges)


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
