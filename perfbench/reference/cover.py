"""The plain check of a vertex cover against the benchmark's own instance."""

from __future__ import annotations

import numpy as np

__all__ = ["judge_cover"]


def judge_cover(weights, indptr, indices, solution):
    """(uncovered directed CSR entries, cost) of a 0/1 ``solution``; a
    solution of the wrong length covers nothing."""
    weights = np.asarray(weights, np.int64)
    sol = np.asarray(solution)
    if sol.shape != weights.shape:
        return int(len(indices)), 0
    sol = sol.astype(bool)
    rows = np.repeat(np.arange(len(weights)), np.diff(indptr))
    uncovered = int((~sol[rows] & ~sol[np.asarray(indices)]).sum())
    return uncovered, int(weights[sol].sum())
