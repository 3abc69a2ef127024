"""Whole-graph reduction-rule predicates, in plain PyTorch on the tensors'
device.

The counterpart of the JAX package's ``ops/rules.py``, with the same outputs
bit for bit.  The reference checks rules one vertex at a time through
worklists; these masks evaluate every vertex at once.  The host core stays
the source of truth: it re-checks r1 and twin candidates before applying
them, and applies r5 verdicts only where the snapshot's proof still holds
(``solver/device_reduce.py``).

* r1 (neighbourhood reduction): NW(u) <= W(u), degree > 0.
* twin key: equal (degree, NW, neighbourhood hash) buckets; twins (equal
  open neighbourhoods) collide exactly, the host re-checks equality.
* r3 (domination) edge filter: the cheap necessary conditions
  D(u) >= D(v), W(u) + NW(u) >= W(v) + NW(v), W(v) >= W(u).
* isolated candidates: every neighbour passes the degree/weight precheck.
* r5 (neighbourhood meta-reduction): exact MWVC of N(u) for deg(u) <= 8.

The twin key is uint32 arithmetic in the reference.  torch has no uint32
multiply, so the hashes run in int64 masked to 32 bits after every step,
with each product split so it stays below 2^63; the per-row sum is a
segment sum in int64 taken mod 2^32, which equals a wrapping uint32 sum.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from gnn_mwvc_tpu_torch.graph import neighbour_weight_sum

__all__ = ["rule_masks", "twin_hash", "build_ell8", "r5_candidates",
           "twin_groups", "mask_inputs"]

_H1 = 0x9E3779B9
_H2 = 0x85EBCA6B
_M32 = 0xFFFFFFFF
_U32_LIMIT = float(2**32)
_I32_MAX = 2**31 - 1
R5_CHUNK = 1 << 16  # vertices per r5 step: (C, 256) int32 tables of 64 MB

# calls by "op/device type": shows on which device a run computed its masks
calls: collections.Counter = collections.Counter()


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2^32 for int64 x in [0, 2^32) and a constant c < 2^32:
    c splits into 16-bit halves so no product reaches 2^63."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix(x: torch.Tensor) -> torch.Tensor:
    x = _mul32(x ^ (x >> 16), _H2)
    x = _mul32(x ^ (x >> 13), _H1)
    return x ^ (x >> 16)


def _to_u32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> uint32 value in int64, truncating and saturating at
    2^32 - 1 as XLA converts.  (Clamping in float32 would not do: 2^32 - 1
    rounds up to 2^32 there.)"""
    big = x >= _U32_LIMIT
    x = torch.where(big, 0.0, x.clamp(min=0.0)).to(torch.int64)
    return torch.where(big, _M32, x)


def twin_hash(row: torch.Tensor, col: torch.Tensor, n: int) -> torch.Tensor:
    """Order-independent neighbourhood hash per vertex (int64 holding a
    uint32): the wrapping sum of mixed neighbour ids."""
    h = _mix((col.long() + _H1) & _M32)
    out = torch.zeros(n, dtype=torch.int64, device=h.device)
    out.index_add_(0, row.long(), h)
    return out & _M32


def mask_inputs(weights, indptr, indices):
    """Host arrays (row, col int32; W, D, NW float32) as the JAX package's
    ``DeviceGraph.build`` makes them (NW by ``neighbour_weight_sum``, as
    the port's ``DeviceGraph`` sums it), so r1 and the twin key see the same
    values once NW passes 2^24."""
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int64)
    n = len(weights)
    deg = np.diff(indptr)
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    w = np.asarray(weights, dtype=np.float32)
    nw = neighbour_weight_sum(w, rows, indices)
    return (rows.astype(np.int32), indices.astype(np.int32), w,
            deg.astype(np.float32), nw)


def rule_masks(row, col, weights, degrees, nw, node_mask):
    """Per-vertex masks and the per-edge filter, on the inputs' device.

    row/col: (e,) directed COO, rows sorted; weights, degrees, nw: (n,)
    float32; node_mask: (n,) bool.  Returns {"r1": (n,) bool, "twin_key":
    (n,) int64 holding a uint32, "dom_edge": (e,) bool, "iso_cand": (n,)
    bool}.
    """
    calls[f"rule_masks/{weights.device.type}"] += 1
    n = weights.shape[0]
    w, d = weights, degrees
    r1 = node_mask & (nw <= w) & (d > 0)

    key = (twin_hash(row, col, n)
           + _mix(_mul32(_to_u32(d), _H2))
           + _mix(_mul32(_to_u32(nw), _H1))) & _M32
    key = torch.where(node_mask, key, torch.zeros_like(key))

    row, col = row.long(), col.long()
    du, dv = d[row], d[col]
    wu, wv = w[row], w[col]
    nwu, nwv = nw[row], nw[col]
    dom_edge = (du >= dv) & (wu + nwu >= wv + nwv) & (wv >= wu)

    ok_nbr = (dv >= du) & (wv + nwv >= wu + nwu)
    bad = torch.zeros(n, dtype=torch.int32, device=w.device)
    bad.index_add_(0, row, (~ok_nbr).to(torch.int32))
    iso_cand = node_mask & (d > 0) & (bad == 0)
    return {"r1": r1, "twin_key": key, "dom_edge": dom_edge,
            "iso_cand": iso_cand}


def build_ell8(indptr: np.ndarray, indices: np.ndarray, deg: np.ndarray):
    """First-8-neighbours ELL table (host numpy).

    Returns (ell (n+1, 8) int32, valid (n+1, 8) bool); row n is an
    all-invalid sentinel so gathers of "no neighbour" slots stay in bounds.
    Rows of degree > 8 are truncated; r5_candidates says why that is sound.
    """
    n = len(deg)
    k = 8
    take = indptr[:-1, None] + np.arange(k, dtype=np.int64)[None]
    valid = np.arange(k)[None] < np.minimum(deg, k)[:, None]
    if len(indices):
        cols = indices[np.minimum(take, len(indices) - 1)]
    else:
        cols = np.zeros((n, k), np.int64)
    cols = np.where(valid, cols, n).astype(np.int32)
    ell = np.concatenate([cols, np.full((1, k), n, np.int32)], 0)
    ellv = np.concatenate([valid, np.zeros((1, k), bool)], 0)
    return ell, np.ascontiguousarray(ellv)


def r5_candidates(ell, ellv, weights, nw, deg, node_mask,
                  chunk: int = R5_CHUNK):
    """Rule-5 verdict mask: for every vertex u with deg(u) <= 8, the exact
    MWVC of the N(u) subgraph over all 2^8 subsets, and W(u) >= NW(u) -
    VC(N(u)).

    Adjacency among N(u) is rebuilt from the neighbours' own first-8 ELL
    rows, so a neighbour of degree > 8 may miss edges.  A missing edge
    relaxes the instance: VC is then a lower bound and the mask can only
    under-fire, never mis-fire.

    int32 arithmetic, as in the reference: the caller guarantees max NW <
    2^31.  ell/ellv: (n+1, 8) from build_ell8; weights, nw, deg: (n,)
    integers; node_mask: (n,) bool.  The result does not depend on
    ``chunk``, the vertices handled per step.
    """
    dev = weights.device
    calls[f"r5_candidates/{dev.type}"] += 1
    n = weights.shape[0]
    w32 = weights.to(torch.int32)
    nw32 = nw.to(torch.int32)
    w_pad = torch.cat([w32, torch.zeros(1, dtype=torch.int32, device=dev)])
    cand = node_mask & (deg <= 8)
    ell = ell.long()
    subsets = torch.arange(256, dtype=torch.int32, device=dev)[None]
    bits = torch.arange(8, dtype=torch.int32, device=dev)
    out = torch.empty(n, dtype=torch.bool, device=dev)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        loc, locv = ell[s:e], ellv[s:e]                   # (C, 8)
        nbr_w = w_pad[loc] * locv                         # invalid slots 0
        nn = ell[loc]                                     # (C, 8, 8)
        nnv = ellv[loc] & locv[:, :, None]
        # adj[c, i, j]: neighbour i adjacent to neighbour j (either way)
        hit = (nn[:, :, None, :] == loc[:, None, :, None]) & nnv[:, :, None, :]
        adj = hit.any(-1) & locv[:, :, None] & locv[:, None, :]
        adj = adj | adj.transpose(1, 2)
        adjmask = (adj.to(torch.int32) << bits).sum(-1, dtype=torch.int32)
        cost = torch.zeros((e - s, 256), dtype=torch.int32, device=dev)
        ok = torch.ones((e - s, 256), dtype=torch.bool, device=dev)
        for j in range(8):
            chosen = ((subsets >> j) & 1) == 1
            aj = adjmask[:, j:j + 1]
            ok &= chosen | ((subsets & aj) == aj)
            cost += torch.where(chosen, nbr_w[:, j:j + 1], 0)
        vc = torch.where(ok, cost, _I32_MAX).amin(1)
        out[s:e] = cand[s:e] & (w32[s:e] >= nw32[s:e] - vc)
    return out


def twin_groups(keys, node_mask):
    """Host post-processing: vertex ids grouped by equal twin key, in the
    order of a stable sort by key; groups of size >= 2 only."""
    def host(a):
        return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)

    keys = host(keys)
    ids = np.nonzero(host(node_mask))[0]
    k = keys[ids]
    order = np.argsort(k, kind="stable")
    ids, k = ids[order], k[order]
    if len(k) == 0:
        return []
    cuts = np.nonzero(k[1:] != k[:-1])[0] + 1
    return [grp for grp in np.split(ids, cuts) if len(grp) >= 2]
