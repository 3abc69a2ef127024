"""Masked CSR neighbour sum: kernel K1 and its plain PyTorch version.

    agg[u, :] = sum over v in N(u) of x[v, :] * mask[v]

This is the only graph work in the GNN forward.  It replaces the JAX
package's ELL and windowed-MXU aggregation plans (``ops/aggregate.py``,
``ops/blocked.py``), which exist because scatter is slow on a TPU.  On CUDA
tensors the wrapper launches the hand-written kernel
(``csrc/csr_aggregate.cu``); on CPU tensors it runs the plain version.
"""

from __future__ import annotations

import torch

from gnn_mwvc_tpu_torch.ops import _build

__all__ = ["csr_aggregate", "csr_aggregate_plain"]

_MAX_WIDTH = 64
_MASK_KINDS = {torch.float32: 1, torch.uint8: 2}


def csr_aggregate_plain(x: torch.Tensor, indptr: torch.Tensor,
                        indices: torch.Tensor,
                        mask: torch.Tensor | None = None) -> torch.Tensor:
    """Reference version: gather, scale by the source mask, index_add_."""
    n = indptr.numel() - 1
    idx = indices.long()
    row = torch.repeat_interleave(
        torch.arange(n, device=x.device), (indptr[1:] - indptr[:-1]).long())
    src = x[idx]
    if mask is not None:
        src = src * mask.to(x.dtype)[idx, None]
    return torch.zeros(n, x.shape[1], dtype=x.dtype,
                       device=x.device).index_add_(0, row, src)


def _check_inputs(x, indptr, indices, mask):
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"x must be (n, w) float32, got {tuple(x.shape)} {x.dtype}")
    n, w = x.shape
    if not 1 <= w <= _MAX_WIDTH:
        raise ValueError(f"width {w} outside 1..{_MAX_WIDTH}")
    if indptr.dtype != torch.int32 or indptr.shape != (n + 1,):
        raise ValueError(f"indptr must be ({n + 1},) int32")
    if indices.dtype != torch.int32 or indices.dim() != 1:
        raise ValueError("indices must be 1-D int32")
    if mask is not None and (mask.dtype not in _MASK_KINDS
                             or mask.shape != (n,)):
        raise ValueError(f"mask must be ({n},) float32 or uint8")
    tensors = [x, indptr, indices] + ([mask] if mask is not None else [])
    if any(t.device != x.device for t in tensors):
        raise ValueError("all inputs must be on one device")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("inputs must be contiguous")


def csr_aggregate(x: torch.Tensor, indptr: torch.Tensor, indices: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Masked neighbour sum over a symmetric int32 CSR; (n, w) float32 out.

    CUDA tensors go through kernel K1 (deterministic: no atomics, each row
    summed in CSR order); CPU tensors through ``csr_aggregate_plain``.
    """
    _check_inputs(x, indptr, indices, mask)
    if x.device.type == "cpu":
        return csr_aggregate_plain(x, indptr, indices, mask)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    n, w = x.shape
    out = torch.empty_like(x)
    lib = _build.lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.csr_aggregate_f32(
            x.data_ptr(), indptr.data_ptr(), indices.data_ptr(),
            mask.data_ptr() if mask is not None else None,
            _MASK_KINDS[mask.dtype] if mask is not None else 0,
            out.data_ptr(), n, w, stream)
    _build.check(err, "csr_aggregate")
    _build.launches["csr_aggregate"] += 1
    return out
