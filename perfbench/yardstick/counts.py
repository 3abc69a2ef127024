"""Operations, bytes and peaks: the arithmetic behind every roofline and
utilisation share the benchmark reports.

Peaks are NVIDIA's data sheet figures for one H100 SXM at its 700 W limit
(dense, no sparsity).  A byte bound counts each input read once and each
output written once, at the shape of one launch, whatever the kernel reads
again (the pattern of ``gnn_mwvc_tpu_torch/tools/_common.py::hbm_bytes``).
The model is the published SEA-2022 network; its linear layers' widths
are fixed here, so a change to the program cannot change the counts.
"""

from __future__ import annotations

__all__ = ["HBM_BYTES_PER_S", "FP32_FLOPS_PER_S", "SEA2022_LINEARS",
           "SEA2022_AGG_WIDTHS", "k1_bytes", "k4_bytes", "forward_flops",
           "train_pass_flops", "linear_flops_per_vertex"]

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
FP32_FLOPS_PER_S = 67e12       # H100 SXM float32, outside the tensor cores

# (in, out) of the nine linear layers of the published 21-layer model
SEA2022_LINEARS = ((5, 32), (32, 32), (32, 16),
                   (35, 32), (32, 32), (32, 16),
                   (35, 32), (32, 16), (16, 1))
# widths of the graph layers that aggregate through K1 (the first graph
# layer reads the neighbourhood weight sum and aggregates nothing)
SEA2022_AGG_WIDTHS = (16, 16)


def linear_flops_per_vertex(linears=SEA2022_LINEARS) -> int:
    """2 FLOPs per multiply-add of every linear layer, per vertex."""
    return sum(2 * i * o for i, o in linears)


def forward_flops(n: int, nnz: int, linears=SEA2022_LINEARS,
                  agg_widths=SEA2022_AGG_WIDTHS) -> int:
    """FLOPs that one forward over ``n`` vertices and ``nnz`` directed edges
    needs: the linear layers, plus one add per directed edge and column of
    each neighbour sum."""
    return n * linear_flops_per_vertex(linears) + nnz * sum(agg_widths)


def train_pass_flops(n: int, nnz: int, linears=SEA2022_LINEARS,
                     agg_widths=SEA2022_AGG_WIDTHS) -> int:
    """FLOPs of one graph's forward and backward in a training step: the
    linear layers three times the forward's (the forward, the input
    gradient and the weight gradient), the neighbour sums twice (the
    forward, and the backward's sum of the gradient)."""
    return (3 * n * linear_flops_per_vertex(linears)
            + 2 * nnz * sum(agg_widths))


def k1_bytes(n_out: int, n_src: int, nnz: int, width: int,
             mask_bytes: int = 0) -> int:
    """Least HBM bytes of one masked CSR neighbour sum (K1): x (n_src,
    width) float32, indptr (n_out + 1,) and indices (nnz,) int32 and the
    source mask (``mask_bytes`` per source, 0 without one) read once; the
    (n_out, width) float32 result written once."""
    return (4 * n_src * width + 4 * (n_out + 1) + 4 * nnz
            + mask_bytes * n_src + 4 * n_out * width)


def k4_bytes(batch: int, width: int) -> int:
    """Least HBM bytes of one batch of the exact region solver (K4): adj
    and w (batch, width) int32 read once; best cost and best set (batch,)
    int32 written once.  Not an operation count, which would tie the bound
    to one algorithm."""
    return 2 * 4 * batch * width + 2 * 4 * batch
