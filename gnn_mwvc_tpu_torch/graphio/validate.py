"""Cover and independent-set checks, the IS -> VC conversion and the
solution file format."""

from __future__ import annotations

import numpy as np

from gnn_mwvc_tpu_torch.graph import Graph

__all__ = ["is_vertex_cover", "cover_cost", "read_solution", "write_solution",
           "is_independent_set", "independent_set_to_cover"]


def is_vertex_cover(g: Graph, s: np.ndarray) -> bool:
    """True iff every edge has at least one endpoint with s == 1."""
    s = np.asarray(s, dtype=bool)
    e = g.edge_array()
    return bool(np.all(s[e[:, 0]] | s[e[:, 1]])) if len(e) else True


def cover_cost(g: Graph, s: np.ndarray) -> int:
    return int(g.weights[np.asarray(s, dtype=bool)].sum())


def read_solution(path) -> np.ndarray:
    """A per-vertex 0/1 solution file, one value per line."""
    with open(path, "rb") as f:
        return np.array(f.read().split(), dtype=np.int64)


def write_solution(path, s: np.ndarray) -> None:
    with open(path, "w") as f:
        f.write("\n".join("1" if int(x) else "0" for x in s))
        f.write("\n")


def is_independent_set(g: Graph, s: np.ndarray) -> bool:
    """True iff no edge has both endpoints with s == 1."""
    s = np.asarray(s, dtype=bool)
    e = g.edge_array()
    return bool(np.all(~(s[e[:, 0]] & s[e[:, 1]]))) if len(e) else True


def independent_set_to_cover(g: Graph, s: np.ndarray) -> np.ndarray:
    """The complement of an independent set, a vertex cover (HILS solves
    max-weight IS; its cover costs sum(w) - IS weight).  Raises if ``s`` is
    not independent."""
    if not is_independent_set(g, s):
        raise ValueError("input is not an independent set")
    return (~np.asarray(s, dtype=bool)).astype(np.int64)
