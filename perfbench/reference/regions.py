"""The plain reference of the exact region solver: the minimum-weight
vertex cover of each small region by enumerating every subset, in plain
PyTorch on any device.

A region is a row of ``adj`` (neighbour bitmasks) and ``w`` (int32
weights), of ``k`` vertices in the low bits.  A subset S covers the region
when every vertex j is in S or has all of ``adj[j]`` in S; a bit j set in
``adj[j]`` (a self-loop) thus puts j in every cover.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["region_optima", "judge_regions"]

_CELLS = 1 << 24  # subsets x regions per step: 64 MB of int32 per array


def region_optima(adj, w, ks, device) -> np.ndarray:
    """(B,) int64: the least cover cost of each region, by enumeration of
    its 2^k subsets (regions of equal k share a step)."""
    adj = np.asarray(adj, np.int64)
    w = np.asarray(w, np.int64)
    ks = np.asarray(ks, np.int64)
    out = np.zeros(len(ks), np.int64)
    for k in np.unique(ks):
        k = int(k)
        if k == 0:
            continue
        rows = np.nonzero(ks == k)[0]
        subsets = torch.arange(1 << k, dtype=torch.int64, device=device)[None]
        chunk = max(1, _CELLS >> k)
        for s in range(0, len(rows), chunk):
            r = rows[s:s + chunk]
            a = torch.from_numpy(adj[r, :k]).to(device)
            wc = torch.from_numpy(w[r, :k]).to(device)
            cost = torch.zeros((len(r), 1 << k), dtype=torch.int64,
                               device=device)
            valid = torch.ones_like(cost, dtype=torch.bool)
            for j in range(k):
                chosen = ((subsets >> j) & 1) == 1
                aj = a[:, j:j + 1]
                valid &= chosen | ((subsets & aj) == aj)
                cost += torch.where(chosen, wc[:, j:j + 1], 0)
            cost = torch.where(valid, cost, torch.iinfo(torch.int64).max)
            out[r] = cost.amin(1).cpu().numpy()
    return out


def judge_regions(adj, w, ks, best_cost, best_set, device) -> int:
    """How many regions' answers are wrong: the set has a bit outside the
    region's k vertices, or is no cover, or costs other than the cost
    given, or the cost given is not the least."""
    adj = np.asarray(adj, np.int64)
    w = np.asarray(w, np.int64)
    ks = np.asarray(ks, np.int64)
    bs = np.asarray(best_set, np.int64) & 0xFFFFFFFF
    bc = np.asarray(best_cost, np.int64)
    width = adj.shape[1]
    j = np.arange(width)
    inside = j[None, :] < ks[:, None]
    chosen = ((bs[:, None] >> j) & 1) == 1
    outside_bits = (bs >> np.minimum(ks, 62)) != 0
    covers = (chosen | ((bs[:, None] & adj) == adj) | ~inside).all(1)
    cost = (np.where(chosen & inside, w, 0)).sum(1)
    least = region_optima(adj, w, ks, device)
    wrong = outside_bits | ~covers | (cost != bc) | (bc != least)
    return int(wrong.sum())
