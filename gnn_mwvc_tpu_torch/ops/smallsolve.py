"""Batched exact MWVC of up to 16 vertices by enumerating all 2^16 subsets,
in plain PyTorch on the inputs' device.

The counterpart of the JAX package's ``ops/smallsolve.py``: the same
contract and the same result bit for bit.  It is an oracle, not a path of
the solver: the tests and ``chip_smoke.py`` hold kernel K4
(``ops/smallsolve_mitm.py``) against it at n = 16.

Instances are padded to 16 vertices with adj = 0, w = 0; padding bits are
free and cost 0, so the minimum over the full enumeration is exact for any
instance of at most 16 vertices.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["batched_small_mwvc", "pack_instances"]

_N = 16
_INF = 2**31 - 1          # int32 costs, as in the JAX version
_CHUNK = 256              # instances per step: (256, 2^16) int32 = 64 MB


def pack_instances(instances):
    """instances: list of (weights list, edges list of (i, j) local pairs).

    Returns (adj (B, 16) int32 bitmasks, w (B, 16) int32) as numpy arrays.
    """
    b = len(instances)
    adj = np.zeros((b, _N), dtype=np.int32)
    w = np.zeros((b, _N), dtype=np.int32)
    for k, (wts, edges) in enumerate(instances):
        n = len(wts)
        assert n <= _N
        w[k, :n] = wts
        for i, j in edges:
            adj[k, i] |= 1 << j
            adj[k, j] |= 1 << i
    return adj, w


def batched_small_mwvc(adj: torch.Tensor, w: torch.Tensor):
    """adj: (B, 16) int32 neighbour bitmasks; w: (B, 16) int32 weights.

    Returns (best_cost (B,) int32, best_set (B,) int32): the minimum cover
    cost and the smallest subset bitmask reaching it (the first index, as
    ``jnp.argmin`` takes it), with padding bits cleared.  Per-instance total
    weight must stay below 2^31.
    """
    adj = torch.as_tensor(adj, dtype=torch.int32)
    w = torch.as_tensor(w, dtype=torch.int32, device=adj.device)
    if adj.dim() != 2 or adj.shape[1] != _N or w.shape != adj.shape:
        raise ValueError(f"adj and w must be (B, {_N}), got "
                         f"{tuple(adj.shape)} and {tuple(w.shape)}")
    b = adj.shape[0]
    dev = adj.device
    subsets = torch.arange(1 << _N, dtype=torch.int32, device=dev)[None]
    best_cost = torch.empty(b, dtype=torch.int32, device=dev)
    best_idx = torch.empty(b, dtype=torch.int32, device=dev)
    for s in range(0, b, _CHUNK):
        a, wc = adj[s:s + _CHUNK], w[s:s + _CHUNK]
        cost = torch.zeros((a.shape[0], 1 << _N), dtype=torch.int32,
                           device=dev)
        valid = torch.ones_like(cost, dtype=torch.bool)
        for j in range(_N):
            chosen = ((subsets >> j) & 1) == 1
            aj = a[:, j:j + 1]
            valid &= chosen | ((subsets & aj) == aj)
            cost += torch.where(chosen, wc[:, j:j + 1], 0)
        cost = torch.where(valid, cost, _INF)
        c = cost.amin(1)
        best_cost[s:s + _CHUNK] = c
        best_idx[s:s + _CHUNK] = torch.where(
            cost == c[:, None], subsets, 1 << _N).amin(1)
    used = ((w != 0) | (adj != 0)).to(torch.int32)
    used_mask = (used << torch.arange(_N, dtype=torch.int32, device=dev)).sum(
        1, dtype=torch.int32)
    return best_cost, best_idx & used_mask
