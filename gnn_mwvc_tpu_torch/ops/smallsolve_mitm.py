"""Batched exact small MWVC by meet-in-the-middle: kernel K4 and its plain
PyTorch version.

The port of the JAX package's one Pallas kernel,
``gnn_mwvc_tpu/ops/smallsolve_pallas.py::pallas_small_mwvc``, with the same
contract bit for bit: ``adj (B, n)`` int32 neighbour bitmasks (a self-loop
bit forces a vertex into the cover), ``w (B, n)`` int32 weights with
per-instance total below 2^30, n in {16, 20}.  Returns ``best_cost (B,)``
int32 and ``best_set (B,)`` int32: the smallest cover bitmask among the
minimum-cost covers, AND-ed with the used-vertex mask.

A subset is a cover iff its complement is an independent set.  CPU tensors
go through the plain version, the oracle: it enumerates the complements as
7 low bits x (n - 7) high bits from per-instance tables, in chunks of high
patterns.  CUDA tensors go through the hand-written kernel
(``csrc/smallsolve_mitm.cu``, one block per instance), which gets the same
minimum without the pair enumeration: a subset-maximum transform over the
high half's table, then one lookup per low pattern.
"""

from __future__ import annotations

import torch

from gnn_mwvc_tpu_torch.ops import _build

__all__ = ["small_mwvc_mitm", "small_mwvc_mitm_plain"]

_N_LOW = 7
_WIDTHS = (16, 20)
_CHUNK_ELEMS = 1 << 24  # bound on B * 128 * chunk per plain-version step
_INF_KEY = torch.iinfo(torch.long).max


def _tables(adj: torch.Tensor, w: torch.Tensor):
    """Per-instance tables (int64): base, ok_low, cross_low over the 128 low
    patterns; w_high, ok_high over the 2^(n-7) high patterns; used_mask."""
    b, n = adj.shape
    dev = adj.device
    adj = adj.long()
    w = w.long()
    nh = 1 << (n - _N_LOW)
    high_mask = nh - 1
    c_low = torch.arange(128, device=dev)
    c_high = torch.arange(nh, device=dev)

    w_low = torch.zeros(b, 128, dtype=torch.long, device=dev)
    viol_low = torch.zeros(b, 128, dtype=torch.bool, device=dev)
    cross = torch.zeros(b, 128, dtype=torch.long, device=dev)
    for j in range(_N_LOW):
        bit = ((c_low >> j) & 1).bool()
        aj = adj[:, j:j + 1]
        w_low += bit * w[:, j:j + 1]
        viol_low |= bit & ((aj & 0x7F & c_low) != 0)
        cross |= torch.where(bit, (aj >> _N_LOW) & high_mask, 0)

    w_high = torch.zeros(b, nh, dtype=torch.long, device=dev)
    viol_high = torch.zeros(b, nh, dtype=torch.bool, device=dev)
    for j in range(n - _N_LOW):
        bit = ((c_high >> j) & 1).bool()
        aj = adj[:, _N_LOW + j:_N_LOW + j + 1]
        w_high += bit * w[:, _N_LOW + j:_N_LOW + j + 1]
        viol_high |= bit & (((aj >> _N_LOW) & high_mask & c_high) != 0)

    base = w.sum(1, keepdim=True) - w_low
    used = ((w != 0) | (adj != 0)).long()
    used_mask = (used << torch.arange(n, device=dev)).sum(1)
    return base, ~viol_low, cross, w_high, ~viol_high, used_mask


def small_mwvc_mitm_plain(adj: torch.Tensor, w: torch.Tensor):
    """Reference version in torch ops: the lexicographic minimum of the
    packed key cost << 32 | s over all independent complements."""
    b, n = adj.shape
    base, ok_low, cross, w_high, ok_high, used_mask = _tables(adj, w)
    nh = w_high.shape[1]
    c_low = torch.arange(128, device=adj.device)
    s_low = ((1 << n) - 1) ^ c_low                       # (128,)
    chunk = max(1, min(nh, _CHUNK_ELEMS // max(b * 128, 1)))
    best = torch.full((b,), _INF_KEY, dtype=torch.long, device=adj.device)
    for start in range(0, nh, chunk):
        ch = torch.arange(start, min(start + chunk, nh), device=adj.device)
        ok = (ok_low[:, :, None] & ok_high[:, None, start:start + len(ch)]
              & ((cross[:, :, None] & ch) == 0))
        cost = base[:, :, None] - w_high[:, None, start:start + len(ch)]
        s = s_low[:, None] ^ (ch << _N_LOW)[None, :]      # (128, C)
        key = torch.where(ok, (cost << 32) | s, _INF_KEY)
        best = torch.minimum(best, key.flatten(1).amin(1))
    cost = (best >> 32).to(torch.int32)
    s = ((best & 0xFFFFFFFF) & used_mask).to(torch.int32)
    return cost, s


def _check_inputs(adj, w):
    if adj.dim() != 2 or adj.shape[1] not in _WIDTHS:
        raise ValueError(f"adj must be (B, n) with n in {_WIDTHS}, got "
                         f"{tuple(adj.shape)}")
    if w.shape != adj.shape:
        raise ValueError(f"w shape {tuple(w.shape)} != adj shape "
                         f"{tuple(adj.shape)}")
    if adj.dtype != torch.int32 or w.dtype != torch.int32:
        raise ValueError("adj and w must be int32")
    if adj.device != w.device:
        raise ValueError("adj and w must be on one device")
    if not (adj.is_contiguous() and w.is_contiguous()):
        raise ValueError("adj and w must be contiguous")


def small_mwvc_mitm(adj: torch.Tensor, w: torch.Tensor):
    """Exact batched MWVC; see the module docstring for the contract.
    Launches on the current CUDA stream."""
    _check_inputs(adj, w)
    if adj.device.type == "cpu":
        return small_mwvc_mitm_plain(adj, w)
    if adj.device.type != "cuda":
        raise ValueError(f"unsupported device {adj.device}")
    b, n = adj.shape
    best_cost = torch.empty(b, dtype=torch.int32, device=adj.device)
    best_set = torch.empty(b, dtype=torch.int32, device=adj.device)
    lib = _build.lib()
    with torch.cuda.device(adj.device):
        stream = torch.cuda.current_stream(adj.device).cuda_stream
        err = lib.small_mwvc_mitm_i32(
            adj.data_ptr(), w.data_ptr(), best_cost.data_ptr(),
            best_set.data_ptr(), b, n, stream)
    _build.check(err, "small_mwvc_mitm")
    _build.count("small_mwvc_mitm")
    return best_cost, best_set
