"""The yardstick's arithmetic against hand counts, and the frozen instance
generator against the program's."""

import numpy as np
import pytest
import torch

from perfbench.yardstick import counts
from perfbench.yardstick.graphs import road_csr, rule_labels


def test_linear_flops_per_vertex_is_the_published_models():
    # 5*32 + 32*32 + 32*16 + 35*32 + 32*32 + 32*16 + 35*32 + 32*16 + 16*1
    macs = 160 + 1024 + 512 + 1120 + 1024 + 512 + 1120 + 512 + 16
    assert macs == 6000
    assert counts.linear_flops_per_vertex() == 2 * macs


def test_forward_and_train_flops_by_hand():
    # 7 vertices, 20 directed edges: two neighbour sums of 16 columns
    assert counts.forward_flops(7, 20) == 7 * 12000 + 20 * 32
    assert counts.train_pass_flops(7, 20) == 3 * 7 * 12000 + 2 * 20 * 32


@pytest.mark.parametrize("mask", [None, torch.float32])
def test_k1_bytes_counts_each_tensor_once(mask):
    n, nnz, w = 5, 12, 16
    x = torch.zeros(n, w)
    indptr = torch.zeros(n + 1, dtype=torch.int32)
    indices = torch.zeros(nnz, dtype=torch.int32)
    out = torch.zeros(n, w)
    ts = [x, indptr, indices, out]
    if mask is not None:
        ts.append(torch.zeros(n, dtype=mask))
    want = sum(t.numel() * t.element_size() for t in ts)
    got = counts.k1_bytes(n, n, nnz, w, 4 if mask is not None else 0)
    assert got == want
    # by hand, masked: 320 + 24 + 48 + 20 + 320
    if mask is not None:
        assert got == 732


def test_k4_bytes_by_hand():
    # adj, w (1024, 20) int32 in; cost, set (1024,) int32 out
    assert counts.k4_bytes(1024, 20) == 172_032
    assert counts.k4_bytes(3, 16) == 2 * 4 * 48 + 2 * 4 * 3


def test_peaks_are_the_data_sheets():
    assert counts.HBM_BYTES_PER_S == 3.35e12
    assert counts.FP32_FLOPS_PER_S == 67e12


@pytest.mark.parametrize("side,seed", [(20, 42), (57, 3), (90, 2**31 + 5)])
def test_road_csr_is_the_programs_road_graph(side, seed):
    from gnn_mwvc_tpu_torch.graph import build_road_graph

    g = build_road_graph(side, seed=seed)
    w, indptr, indices = road_csr(side, seed)
    np.testing.assert_array_equal(w, g.weights)
    np.testing.assert_array_equal(indptr, g.indptr)
    np.testing.assert_array_equal(indices, g.indices)


def test_rule_labels_by_hand():
    # path 0 - 1 - 2, weights 5, 1, 9: only vertex 1 is lighter than its
    # neighbours' mean (1 < 7); 0 (5 against 1) and 2 (9 against 1) are not
    w = np.array([5, 1, 9])
    indptr = np.array([0, 1, 3, 4])
    indices = np.array([1, 0, 2, 1])
    np.testing.assert_array_equal(rule_labels(w, indptr, indices),
                                  np.array([0, 1, 0], np.float32))

