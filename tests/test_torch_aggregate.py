"""K1's plain PyTorch version against JAX's segment sum over the same CSR.

Both sum the same float32 terms, in different orders, so the tolerance is
rtol = atol = 1e-6 on O(1) features.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_mwvc_tpu.graph import DeviceGraph as JaxDeviceGraph
from gnn_mwvc_tpu_torch.graph import DeviceGraph, Graph
from gnn_mwvc_tpu_torch.ops import _build
from gnn_mwvc_tpu_torch.ops.aggregate import (csr_aggregate, csr_aggregate_plain,
                                              csr_transpose)
from tests.conftest import random_graph


def _jax_sum(gj, x, mask):
    dgj = JaxDeviceGraph.from_graph(gj, aggregation="scatter")
    xp = np.zeros((dgj.n_pad, x.shape[1]), np.float32)
    xp[:gj.n] = x * (mask[:, None] if mask is not None else 1.0)
    out = jax.ops.segment_sum(jnp.asarray(xp).take(dgj.col, axis=0), dgj.row,
                              num_segments=dgj.n_pad, indices_are_sorted=True)
    return np.asarray(out)[:gj.n]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n,deg,w", [(300, 6, 16), (500, 12, 5), (64, 3, 40)])
def test_plain_matches_jax_segment_sum(n, deg, w, masked):
    rng = np.random.default_rng(n + w)
    gj = random_graph(n, deg, seed=n)
    g = Graph(gj.weights, gj.edge_array())
    dg = DeviceGraph.from_graph(g, "cpu")
    x = rng.standard_normal((n, w)).astype(np.float32)
    mask = (rng.random(n) < 0.6).astype(np.float32) if masked else None
    got = csr_aggregate(torch.from_numpy(x), dg.indptr, dg.indices,
                        torch.from_numpy(mask) if masked else None)
    np.testing.assert_allclose(got.numpy(), _jax_sum(gj, x, mask),
                               rtol=1e-6, atol=1e-6)


def test_uint8_mask_equals_float_mask():
    rng = np.random.default_rng(2)
    gj = random_graph(200, 8, seed=2)
    dg = DeviceGraph.from_graph(Graph(gj.weights, gj.edge_array()), "cpu")
    x = torch.from_numpy(rng.standard_normal((200, 16)).astype(np.float32))
    alive = rng.random(200) < 0.5
    a = csr_aggregate(x, dg.indptr, dg.indices,
                      torch.from_numpy(alive.astype(np.uint8)))
    b = csr_aggregate(x, dg.indptr, dg.indices,
                      torch.from_numpy(alive.astype(np.float32)))
    assert torch.equal(a, b)


def test_cpu_tensors_take_the_plain_version():
    gj = random_graph(50, 4, seed=1)
    dg = DeviceGraph.from_graph(Graph(gj.weights, gj.edge_array()), "cpu")
    x = torch.ones(50, 16)
    before = _build.launches["csr_aggregate"]
    got = csr_aggregate(x, dg.indptr, dg.indices)
    assert _build.launches["csr_aggregate"] == before
    assert torch.equal(got, csr_aggregate_plain(x, dg.indptr, dg.indices))
    np.testing.assert_array_equal(got[:, 0].numpy(), np.diff(gj.indptr))


@pytest.mark.parametrize("bad", ["x_dtype", "indptr_dtype", "mask_shape",
                                 "width", "noncontiguous",
                                 "indptr_length"])
def test_rejects_bad_inputs(bad):
    gj = random_graph(40, 4, seed=3)
    dg = DeviceGraph.from_graph(Graph(gj.weights, gj.edge_array()), "cpu")
    x, indptr, indices, mask = torch.ones(40, 16), dg.indptr, dg.indices, None
    if bad == "x_dtype":
        x = x.double()
    elif bad == "indptr_dtype":
        indptr = indptr.long()
    elif bad == "mask_shape":
        mask = torch.ones(39)
    elif bad == "width":
        x = torch.ones(40, 65)
    elif bad == "indptr_length":
        indptr = indptr[:-1].contiguous()
    else:
        x = torch.ones(16, 40).t()
    with pytest.raises(ValueError):
        csr_aggregate(x, indptr, indices, mask)


def test_device_graph_rejects_a_bad_csr():
    w = np.ones(3)
    with pytest.raises(ValueError):
        DeviceGraph.build(w, np.array([0, 1, 2, 2]), np.array([1, 3]), "cpu")
    with pytest.raises(ValueError):
        DeviceGraph.build(w, np.array([0, 1, 2]), np.array([1, 0]), "cpu")


def _block(rng, n_out, n_src, deg):
    """A random CSR block: n_out rows over n_src sources, not symmetric."""
    counts = rng.integers(0, 2 * deg + 1, size=n_out)
    indptr = np.zeros(n_out + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    indices = rng.integers(0, n_src, size=int(indptr[-1]))
    return (torch.from_numpy(indptr.astype(np.int32)),
            torch.from_numpy(indices.astype(np.int32)))


def _direct(x, indptr, indices, mask):
    """The neighbour sum written directly: gather, mask, index_add_."""
    rows = torch.repeat_interleave(torch.arange(indptr.numel() - 1),
                                   (indptr[1:] - indptr[:-1]).long())
    src = x[indices.long()]
    if mask is not None:
        src = src * mask[indices.long(), None]
    return torch.zeros(indptr.numel() - 1, x.shape[1]).index_add_(0, rows, src)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n_out,n_src", [(120, 300), (200, 200), (300, 90)])
def test_block_forward_and_gradient_match_direct(n_out, n_src, masked):
    """A rectangular (or square, non-symmetric) block: the forward, and the
    x-gradient through the block's transposed CSR, equal autograd through
    the direct formulation.  The symmetric shortcut (the block itself in
    place of its transpose) fails here: wrong shape or wrong sums."""
    rng = np.random.default_rng(n_out * 7 + n_src)
    indptr, indices = _block(rng, n_out, n_src, 5)
    x = torch.from_numpy(rng.standard_normal((n_src, 16)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((n_out, 16)).astype(np.float32))
    mask = (torch.from_numpy((rng.random(n_src) < 0.6).astype(np.float32))
            if masked else None)
    t = csr_transpose(indptr, indices, n_src)
    assert t[0].dtype == t[1].dtype == torch.int32
    assert t[0].shape == (n_src + 1,) and t[1].shape == indices.shape
    xa = x.clone().requires_grad_()
    xb = x.clone().requires_grad_()
    got = csr_aggregate(xa, indptr, indices, mask, transposed=t)
    want = _direct(xb, indptr, indices, mask)
    assert torch.equal(got, want)
    (ga,) = torch.autograd.grad(got, xa, g)
    (gb,) = torch.autograd.grad(want, xb, g)
    torch.testing.assert_close(ga, gb, rtol=1e-6, atol=1e-6)
    if n_out == n_src:   # the shortcut runs, and is wrong on this block
        xc = x.clone().requires_grad_()
        (gc,) = torch.autograd.grad(
            csr_aggregate(xc, indptr, indices, mask), xc, g)
        assert not torch.allclose(gc, gb, atol=1e-3)


def test_rectangular_block_gradient_needs_its_transpose():
    rng = np.random.default_rng(5)
    indptr, indices = _block(rng, 50, 80, 3)
    x = torch.ones(80, 16)
    assert csr_aggregate(x, indptr, indices, block=True).shape == (50, 16)
    with pytest.raises(ValueError, match="transposed"):
        csr_aggregate(x.requires_grad_(), indptr, indices, block=True)
    with pytest.raises(ValueError, match="block=True"):
        csr_aggregate(x.detach(), indptr, indices)   # not square: a block


def test_transpose_of_a_symmetric_csr_is_itself():
    gj = random_graph(150, 6, seed=8)
    dg = DeviceGraph.from_graph(Graph(gj.weights, gj.edge_array()), "cpu")
    t_indptr, t_indices = csr_transpose(dg.indptr, dg.indices, dg.n)
    assert torch.equal(t_indptr, dg.indptr) and torch.equal(t_indices, dg.indices)
