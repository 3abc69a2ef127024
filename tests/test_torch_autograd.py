"""Gradients of the port against autograd of the plain aggregation and
against ``jax.grad`` of the JAX trainer's loss, on the CPU.

On the CPU ``csr_aggregate``'s forward and backward are the plain version
(the backward is the plain neighbour sum of the gradient, valid because the
CSR is symmetric); ``index_add_``'s own autograd is the reference.
"""

import numpy as np
import pytest
import torch

import bench
from gnn_mwvc_tpu.graph import DeviceGraph as JaxDeviceGraph
from gnn_mwvc_tpu.models import init_params as jax_init_params
from gnn_mwvc_tpu.models.gnn import build_reference_arch as jax_arch
from gnn_mwvc_tpu.train.trainer import WEIGHT_SCALE, _make_fns
from gnn_mwvc_tpu_torch.graph import DeviceGraph, Graph
from gnn_mwvc_tpu_torch.models import MWVCModel, ModelSpec
from gnn_mwvc_tpu_torch.ops import _build
from gnn_mwvc_tpu_torch.ops.aggregate import csr_aggregate, csr_aggregate_plain
from gnn_mwvc_tpu_torch.train import loss_and_metrics, make_sample
from tests.conftest import random_graph


def _port_dg(gj):
    return DeviceGraph.from_graph(Graph(gj.weights, gj.edge_array()), "cpu")


@pytest.mark.parametrize("mask_kind", [None, "f32", "u8"])
def test_backward_equals_plain_autograd(mask_kind):
    rng = np.random.default_rng(7)
    gj = random_graph(300, 8, seed=7)
    dg = _port_dg(gj)
    x0 = rng.standard_normal((gj.n, 16)).astype(np.float32)
    g = torch.from_numpy(rng.standard_normal((gj.n, 16)).astype(np.float32))
    alive = rng.random(gj.n) < 0.6
    mask = {None: None,
            "f32": torch.from_numpy(alive.astype(np.float32)),
            "u8": torch.from_numpy(alive.astype(np.uint8))}[mask_kind]
    x = torch.from_numpy(x0).requires_grad_()
    out = csr_aggregate(x, dg.indptr, dg.indices, mask)
    assert out.grad_fn is not None
    before = dict(_build.launches)
    (got,) = torch.autograd.grad(out, x, g)
    assert dict(_build.launches) == before  # CPU tensors: no kernel launch
    xr = torch.from_numpy(x0).requires_grad_()
    (want,) = torch.autograd.grad(
        csr_aggregate_plain(xr, dg.indptr, dg.indices, mask), xr, g)
    # the same float32 terms (sums up to ~15 in magnitude) in another
    # order; index_add_'s own CPU backward varies by a few ulp run to run
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    if mask is not None:
        assert not got[torch.from_numpy(~alive)].any()


def _jax_params(seed):
    kinds, dims = jax_arch()
    params = [None if p is None else {k: np.asarray(v) for k, v in p.items()}
              for p in jax_init_params(kinds, dims, seed=seed)]
    return kinds, params


_GRAPHS = {
    "er400": lambda: random_graph(400, 10, seed=3, wmax=1000),
    "road40": lambda: bench.build_road_graph(40, seed=5),
}


@pytest.mark.parametrize("compat", [True, False])
@pytest.mark.parametrize("name", sorted(_GRAPHS))
def test_sse_gradient_matches_jax_grad(name, compat):
    """The full 21-layer model: every parameter's gradient of the
    unnormalised SSE within 1e-5 of that tensor's largest entry.  compat
    covers the w = 16 column overwrite, whose overwritten input columns get
    zero gradient on both sides."""
    gj = _GRAPHS[name]()
    rng = np.random.default_rng(len(name))
    labels = (rng.random(gj.n) < 0.5).astype(np.float32)
    kinds, params = _jax_params(seed=4)

    grad_fn, _ = _make_fns(kinds, compat)
    dgj = JaxDeviceGraph.from_graph(gj, with_ell=False)
    y = np.zeros(dgj.n_pad, np.float32)
    y[:gj.n] = labels
    ref = grad_fn(params, dgj, y, dgj.node_mask, np.float32(WEIGHT_SCALE))

    model = MWVCModel.from_spec(ModelSpec(kinds, params))
    s = make_sample(Graph(gj.weights, gj.edge_array()), labels, device="cpu")
    sse, _ = loss_and_metrics(model, s, WEIGHT_SCALE, compat)
    sse.backward()
    lins = iter(model.linears)
    for kind, r in zip(kinds, ref):
        if kind != "linear":
            continue
        lin = next(lins)
        for got, want in ((lin.weight.grad.T, r["w"]), (lin.bias.grad, r["b"])):
            want = np.asarray(want)
            scale = float(np.abs(want).max())
            assert scale > 0
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=1e-5 * scale)
