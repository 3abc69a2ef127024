"""The port's GNN forward against the JAX package's, on the CPU.

The parity gate is the repo's: activations within 2e-5.  Inputs are numpy
graphs and masks from seeds; the published weights reach both sides from the
same text file, through ``params_from_jax`` on the port's side.
"""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from gnn_mwvc_tpu.graph import DeviceGraph as JaxDeviceGraph
from gnn_mwvc_tpu.models import init_params
from gnn_mwvc_tpu.models import load_pretrained as jax_load_pretrained
from gnn_mwvc_tpu.models.gnn import Model, forward, score_graph as jax_score
from gnn_mwvc_tpu_torch.graph import DeviceGraph, Graph
from gnn_mwvc_tpu_torch.graphio import read_metis
from gnn_mwvc_tpu_torch.models import (MWVCModel, ModelSpec, load_pretrained,
                                       pretrained_model, score_graph)
from tests.conftest import EX3, random_graph

TOL = 2e-5


def _graphs():
    return {
        "er500": random_graph(500, 12, seed=11),
        "er300_heavy": random_graph(300, 6, seed=4, wmax=100000),
        "road60": bench.build_road_graph(60),
    }


def _port(gj):
    g = Graph(gj.weights, gj.edge_array())
    return g, DeviceGraph.from_graph(g, "cpu")


def test_pretrained_model_shape():
    m = pretrained_model()
    assert len(m.kinds) == 21 and m.num_params() == 6209
    spec = load_pretrained()
    jm = jax_load_pretrained()
    assert spec.kinds == jm.kinds
    for p, q in zip(spec.params, jm.params):
        if p is not None:
            np.testing.assert_array_equal(p["w"], np.asarray(q["w"]))
            np.testing.assert_array_equal(p["b"], np.asarray(q["b"]))


def test_ex3_golden_scores():
    g = read_metis(io.BytesIO(EX3))
    s = score_graph(pretrained_model(), DeviceGraph.from_graph(g, "cpu"), 20.0)
    np.testing.assert_allclose(s.numpy(), [0.1294, 0.1294, 0.9348], atol=1e-4)


@pytest.mark.parametrize("compat", [True, False])
@pytest.mark.parametrize("name", sorted(_graphs()))
def test_published_scores_match_jax(name, compat):
    gj = _graphs()[name]
    ws = float(gj.weights.max())
    ref = np.asarray(jax_score(jax_load_pretrained(),
                               JaxDeviceGraph.from_graph(gj), ws,
                               compat=compat))[:gj.n]
    _g, dg = _port(gj)
    got = score_graph(pretrained_model(), dg, ws, compat=compat).numpy()
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("compat", [True, False])
@pytest.mark.parametrize("name", sorted(_graphs()))
def test_masked_forward_matches_jax_on_live_rows(name, compat):
    """The sticky-scoring forward: x = W/ws * mask, first layer analytic,
    every later aggregation over live sources only."""
    gj = _graphs()[name]
    ws = float(gj.weights.max())
    rng = np.random.default_rng(len(name))
    alive = rng.random(gj.n) < 0.7
    dgj = JaxDeviceGraph.from_graph(gj)
    m = np.zeros(dgj.n_pad, np.float32)
    m[:gj.n] = alive
    xj = (np.asarray(dgj.weights) / ws * m).reshape(-1, 1)
    ref = np.asarray(forward(jax_load_pretrained(), jnp.asarray(xj), dgj, ws,
                             compat=compat, x_is_node_weights=True,
                             source_mask=jnp.asarray(m)))[:gj.n]
    _g, dg = _port(gj)
    mt = torch.from_numpy(m[:gj.n])
    x = (dg.weights / ws * mt).reshape(-1, 1)
    with torch.no_grad():
        got = pretrained_model()(x, dg, ws, compat=compat,
                                 x_is_node_weights=True,
                                 source_mask=mt).numpy()
    assert got.shape == ref.shape == (gj.n, 1)
    np.testing.assert_allclose(got[alive], ref[alive], atol=TOL, rtol=0)


@pytest.mark.parametrize("compat", [True, False])
def test_narrow_random_model_matches_jax(compat):
    """A w = 8 model from the JAX initialiser: the column quirk at another
    width, and every activation column (not just the score)."""
    kinds = ("graph", "linear", "relu", "graph", "linear", "relu",
             "graph", "linear", "relu", "linear", "sigmoid")
    dims = [(5, 8), (19, 8), (19, 8), (8, 1)]
    params = init_params(kinds, dims, seed=3)
    jm = Model(kinds=kinds, params=params)
    spec = ModelSpec(kinds, [None if p is None else
                             {"w": np.asarray(p["w"]), "b": np.asarray(p["b"])}
                             for p in params])
    tm = MWVCModel.from_spec(spec)
    gj = random_graph(400, 8, seed=21)
    ws = float(gj.weights.max())
    dgj = JaxDeviceGraph.from_graph(gj)
    xj = (np.asarray(dgj.weights) / ws).reshape(-1, 1)
    _g, dg = _port(gj)
    # outputs of each graph layer (19 columns at w = 8) and of the model
    for n_layers in (1, 4, 7, len(kinds)):
        jsub = Model(kinds=kinds[:n_layers], params=params[:n_layers])
        ref = np.asarray(forward(jsub, jnp.asarray(xj), dgj, ws, compat=compat,
                                 x_is_node_weights=True))[:gj.n]
        n_lin = sum(k == "linear" for k in kinds[:n_layers])
        tsub = MWVCModel(kinds[:n_layers], dims[:n_lin])
        tsub.load_state_dict({k: v for k, v in tm.state_dict().items()
                              if int(k.split(".")[1]) < n_lin})
        with torch.no_grad():
            got = tsub((dg.weights / ws).reshape(-1, 1), dg, ws, compat=compat,
                       x_is_node_weights=True).numpy()
        # hidden activations reach ~200 (raw degrees, untrained weights);
        # fp32 sums in another order differ there by a few ulp, so they get
        # a relative term; the final sigmoid scores are held to 2e-5 alone
        rtol = 0 if n_layers == len(kinds) else 1e-6
        np.testing.assert_allclose(got, ref, atol=TOL, rtol=rtol)
