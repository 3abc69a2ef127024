"""Masked CSR neighbour sum: kernel K1, its gradient and its plain version.

    agg[u, :] = sum over v in N(u) of x[v, :] * mask[v]

The CSR has ``n_out`` rows (``indptr.numel() - 1``) over the ``x.shape[0]``
source rows, and the mask is over the sources.  The whole graph's CSR is
square; a shard of the multi-device forward (``parallel/sharded.py``)
aggregates its own rows over the source space ``[local | halo]``, a
rectangular block.

This is the only graph work in the GNN forward.  It replaces the JAX
package's ELL and windowed-MXU aggregation plans (``ops/aggregate.py``,
``ops/blocked.py``), which exist because scatter is slow on a TPU.  On CUDA
tensors the wrapper launches the hand-written kernel
(``csrc/csr_aggregate.cu``); on CPU tensors it runs the plain version.

``csr_aggregate`` is differentiable in ``x`` on every device.  The backward
of ``agg = A (m * x)`` is ``grad_x = m * (A^T grad_agg)``: K1 again, on the
gradient, with no source mask, over the transposed CSR.  The whole graph's
CSR is symmetric (``Graph`` stores both directions of every edge), so there
A^T is A itself; a block is not symmetric, and its caller passes the
transposed CSR (``csr_transpose``).  That replaces the transpose
``jax.grad`` derives for the JAX aggregation (``train/trainer.py:66``).
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from gnn_mwvc_tpu_torch.ops import _build

__all__ = ["csr_aggregate", "csr_aggregate_plain", "csr_transpose"]

_MAX_WIDTH = 64
_MASK_KINDS = {torch.float32: 1, torch.uint8: 2}


def csr_aggregate_plain(x: torch.Tensor, indptr: torch.Tensor,
                        indices: torch.Tensor,
                        mask: torch.Tensor | None = None) -> torch.Tensor:
    """Reference version: gather, scale by the source mask, index_add_;
    ``indptr.numel() - 1`` output rows."""
    n = indptr.numel() - 1
    idx = indices.long()
    row = torch.repeat_interleave(
        torch.arange(n, device=x.device), (indptr[1:] - indptr[:-1]).long())
    src = x[idx]
    if mask is not None:
        src = src * mask.to(x.dtype)[idx, None]
    return torch.zeros(n, x.shape[1], dtype=x.dtype,
                       device=x.device).index_add_(0, row, src)


def csr_transpose(indptr: torch.Tensor, indices: torch.Tensor,
                  n_src: int) -> tuple:
    """The transposed int32 CSR of a block (``n_src`` rows over the block's
    output rows), each row's sources in ascending order; on the block's
    device."""
    n_out = indptr.numel() - 1
    counts = (indptr[1:] - indptr[:-1]).long()
    rows = torch.repeat_interleave(
        torch.arange(n_out, dtype=torch.int32, device=indptr.device), counts)
    cols = indices.long()
    t_indices = rows[torch.sort(cols, stable=True).indices]
    t_indptr = torch.zeros(n_src + 1, dtype=torch.int32, device=indptr.device)
    t_indptr[1:] = torch.cumsum(torch.bincount(cols, minlength=n_src), 0)
    return t_indptr, t_indices.contiguous()


def _check_inputs(x, indptr, indices, mask, transposed, block):
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"x must be (n, w) float32, got {tuple(x.shape)} {x.dtype}")
    n_src, w = x.shape
    if not 1 <= w <= _MAX_WIDTH:
        raise ValueError(f"width {w} outside 1..{_MAX_WIDTH}")
    csrs = [(indptr, indices)] + ([transposed] if transposed is not None else [])
    for ptr, idx in csrs:
        if ptr.dtype != torch.int32 or ptr.dim() != 1 or ptr.numel() < 1:
            raise ValueError("indptr must be 1-D int32 with at least 1 entry")
        if idx.dtype != torch.int32 or idx.dim() != 1:
            raise ValueError("indices must be 1-D int32")
        if idx.numel() >= 2**31:
            raise ValueError(f"{idx.numel()} CSR entries overflow int32")
    # K1 reads x through the indices unchecked.  Checking a CUDA CSR here
    # would cost a sync per call, so the code that makes it checks it once
    # (DeviceGraph.build, partition_device_graph); a CPU CSR is checked here.
    # The transposed CSR indexes the forward's output rows.
    n_out = indptr.numel() - 1
    for (ptr, idx), cols in zip(csrs, (n_src, n_out)):
        if ptr.device.type != "cpu" or idx.device.type != "cpu":
            continue
        if int(ptr[-1]) != idx.numel():
            raise ValueError(f"indptr[-1] is {int(ptr[-1])}, but there are "
                             f"{idx.numel()} indices")
        if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= cols):
            raise ValueError(f"a CSR index lies outside the {cols} source "
                             "rows")
    if not block and indptr.shape != (n_src + 1,):
        raise ValueError(f"indptr must be ({n_src + 1},) for {n_src} rows of "
                         "x (block=True for a rectangular block)")
    if transposed is not None and transposed[0].shape != (n_src + 1,):
        raise ValueError(f"the transposed CSR must have {n_src} rows")
    if mask is not None and (mask.dtype not in _MASK_KINDS
                             or mask.shape != (n_src,)):
        raise ValueError(f"mask must be ({n_src},) float32 or uint8")
    tensors = [x, mask] + [t for csr in csrs for t in csr]
    tensors = [t for t in tensors if t is not None]
    if any(t.device != x.device for t in tensors):
        raise ValueError("all inputs must be on one device")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("inputs must be contiguous")
    if (block and transposed is None and x.requires_grad
            and torch.is_grad_enabled()):
        raise ValueError("the gradient of a block needs its transposed CSR "
                         "(csr_transpose)")


def _aggregate(x, indptr, indices, mask, counter):
    """One neighbour sum: the plain version on the CPU, K1 on CUDA (counted
    under ``counter``)."""
    if x.device.type == "cpu":
        return csr_aggregate_plain(x, indptr, indices, mask)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    n = indptr.numel() - 1
    out = x.new_empty(n, x.shape[1])
    lib = _build.lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.csr_aggregate_f32(
            x.data_ptr(), indptr.data_ptr(), indices.data_ptr(),
            mask.data_ptr() if mask is not None else None,
            _MASK_KINDS[mask.dtype] if mask is not None else 0,
            out.data_ptr(), n, x.shape[1], stream)
    _build.check(err, counter)
    _build.count(counter)
    return out


class _CsrAggregate(torch.autograd.Function):
    """K1 with its gradient in ``x``; the mask is a constant."""

    @staticmethod
    def forward(ctx, x, indptr, indices, mask, t_indptr, t_indices):
        if t_indptr is None:   # symmetric: A^T = A
            t_indptr, t_indices = indptr, indices
        ctx.save_for_backward(t_indptr, t_indices, mask)
        return _aggregate(x, indptr, indices, mask, "csr_aggregate")

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        t_indptr, t_indices, mask = ctx.saved_tensors
        grad_x = _aggregate(grad_out.contiguous(), t_indptr, t_indices, None,
                            "csr_aggregate_backward")
        if mask is not None:
            grad_x = grad_x * mask.to(grad_x.dtype)[:, None]
        return grad_x, None, None, None, None, None


def csr_aggregate(x: torch.Tensor, indptr: torch.Tensor, indices: torch.Tensor,
                  mask: torch.Tensor | None = None,
                  transposed: tuple | None = None,
                  block: bool = False) -> torch.Tensor:
    """Masked neighbour sum over an int32 CSR; (n_out, w) float32 out.

    CUDA tensors go through kernel K1 (deterministic: no atomics, each row
    summed in CSR order); CPU tensors through ``csr_aggregate_plain``.  The
    result is differentiable in ``x``: the backward is the neighbour sum of
    the gradient over ``transposed`` (``csr_transpose`` of the block; K1 on
    CUDA, counted as ``csr_aggregate_backward``).

    block=False: the CSR is the whole graph's, square over ``x``'s rows and
    symmetric, so its own transpose.  block=True: a shard's block, any
    ``n_out``; its gradient needs ``transposed``, and without it a gradient
    raises.
    """
    block = block or transposed is not None
    _check_inputs(x, indptr, indices, mask, transposed, block)
    t_indptr, t_indices = transposed if transposed is not None else (None,
                                                                     None)
    return _CsrAggregate.apply(x, indptr, indices, mask, t_indptr, t_indices)
