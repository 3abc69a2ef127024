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
from gnn_mwvc_tpu_torch.ops.aggregate import csr_aggregate, csr_aggregate_plain
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
                                 "width", "noncontiguous"])
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
