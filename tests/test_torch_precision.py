"""The forward's ``precision`` option.

``"highest"`` is the fp32 forward bit for bit, on every path that takes the
option; ``"default"`` allows TF32 for the call alone.  On the CPU the flag
changes no product, so every setting gives the same bits here; what is
checked is that each call leaves the process's TF32 state as it found it,
whatever another library set before, and that inside the call the flag is
what the setting asks.
"""

import numpy as np
import pytest
import torch

import bench
from gnn_mwvc_tpu.graph import DeviceGraph as JaxDeviceGraph
from gnn_mwvc_tpu.models import load_pretrained
from gnn_mwvc_tpu.models.gnn import score_graph as jax_score_graph
from gnn_mwvc_tpu_torch.core import CoreSolver
from gnn_mwvc_tpu_torch.graph import DeviceGraph, Graph
from gnn_mwvc_tpu_torch.models import gnn, pretrained_model
from gnn_mwvc_tpu_torch.models.gnn import PRECISIONS, matmul_precision
from gnn_mwvc_tpu_torch.parallel import (gather_scores, make_mesh,
                                         make_sharded_forward,
                                         make_sticky_sharded_forward,
                                         partition_device_graph)
from gnn_mwvc_tpu_torch.solver.static_score import StickyGnnScorer

FLAGS = torch.backends.cuda.matmul
FLAG = "fp32_precision" if hasattr(FLAGS, "fp32_precision") else "allow_tf32"
TF32 = {"fp32_precision": ("tf32", "ieee"), "allow_tf32": (True, False)}[FLAG]


@pytest.fixture(scope="module")
def road():
    gj = bench.build_road_graph(40)
    g = Graph(gj.weights, gj.edge_array())
    return gj, g, DeviceGraph.from_graph(g, "cpu"), float(g.weights.max())


@pytest.fixture
def restore_flag():
    before = getattr(FLAGS, FLAG)
    yield
    setattr(FLAGS, FLAG, before)


def _forward(model, dg, ws, **kw):
    x = (dg.weights / ws).reshape(-1, 1)
    with torch.no_grad():
        return model(x, dg, ws, x_is_node_weights=True, **kw)[:, 0]


def _bits(t):
    return t.numpy().view(np.uint32)


def test_highest_is_the_fp32_forward_bit_for_bit(road):
    """``precision="highest"`` (the default) is the layer walk itself, and
    within 2e-5 of the JAX forward at HIGHEST."""
    gj, _g, dg, ws = road
    model = pretrained_model("cpu")
    x = (dg.weights / ws).reshape(-1, 1)
    with torch.no_grad():
        walk = model._layers(x, dg, ws, True, True, None)[:, 0]
    highest = _forward(model, dg, ws, precision="highest")
    np.testing.assert_array_equal(_bits(_forward(model, dg, ws)), _bits(walk))
    np.testing.assert_array_equal(_bits(highest), _bits(walk))
    ref = np.asarray(jax_score_graph(load_pretrained(),
                                     JaxDeviceGraph.from_graph(gj), ws))
    np.testing.assert_allclose(highest.numpy(), ref[:gj.n], atol=2e-5, rtol=0)


@pytest.mark.parametrize("before", ["unset", "tf32", "ieee"])
def test_each_call_restores_the_tf32_state(road, before, restore_flag,
                                           monkeypatch):
    """A "default" call then a "highest" call: the "highest" bits, the flag
    as the setting asks inside each call, and the earlier state after each,
    here also when another library had switched TF32 on or off."""
    _gj, _g, dg, ws = road
    if before != "unset":
        setattr(FLAGS, FLAG, TF32[0] if before == "tf32" else TF32[1])
    state = getattr(FLAGS, FLAG)
    model = pretrained_model("cpu")
    seen = []
    layers = gnn.MWVCModel._layers

    def spy(self, *args):
        seen.append(getattr(FLAGS, FLAG))
        return layers(self, *args)

    monkeypatch.setattr(gnn.MWVCModel, "_layers", spy)
    first = _forward(model, dg, ws, precision="highest")
    assert getattr(FLAGS, FLAG) == state
    _forward(model, dg, ws, precision="default")
    assert getattr(FLAGS, FLAG) == state
    again = _forward(model, dg, ws, precision="highest")
    assert getattr(FLAGS, FLAG) == state
    assert seen == [TF32[1], TF32[0], TF32[1]]
    np.testing.assert_array_equal(_bits(again), _bits(first))


def test_matmul_precision_restores_on_error_and_refuses_others(restore_flag):
    state = getattr(FLAGS, FLAG)
    with pytest.raises(RuntimeError, match="inside"):
        with matmul_precision("default"):
            assert getattr(FLAGS, FLAG) == TF32[0]
            raise RuntimeError("inside")
    assert getattr(FLAGS, FLAG) == state
    with pytest.raises(ValueError, match="not one of"):
        with matmul_precision("mixed"):
            pass
    assert PRECISIONS == ("highest", "default")


@pytest.mark.parametrize("precision", PRECISIONS)
def test_sticky_and_sharded_forwards_take_precision(road, precision):
    """The sticky scorer and both sharded forwards pass the option on; on
    the CPU every setting gives the "highest" bits."""
    _gj, g, dg, ws = road
    core = CoreSolver(g.weights, g.edge_array())
    core.reduce()
    scores = [StickyGnnScorer(device="cpu", force_sticky=True,
                              precision=p).score_core(core, ws)[1]
              for p in ("highest", precision)]
    np.testing.assert_array_equal(scores[0], scores[1])

    mesh = make_mesh(2, devices=["cpu"] * 2)
    sg = partition_device_graph(dg, 2, devices=mesh)
    model = pretrained_model("cpu")
    outs = [gather_scores(sg, make_sharded_forward(
        model, mesh, x_is_node_weights=True, precision=p)(sg, ws))
        for p in ("highest", precision)]
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_allclose(outs[0], _forward(model, dg, ws).numpy(),
                               atol=1e-5, rtol=0)
    bufs = [torch.stack([sh.weights, sh.nw, sh.degrees,
                         sh.node_mask.float()]) for sh in sg.shards]
    sticky = [gather_scores(sg, make_sticky_sharded_forward(
        model, mesh, precision=p)(sg, [b.clone() for b in bufs], ws))
        for p in ("highest", precision)]
    np.testing.assert_array_equal(sticky[0], sticky[1])
