"""Three repairs of the port against the JAX package, on the CPU.

1. NW (the neighbour weight sum) in the JAX package's float32 order, which
   differs from an exact sum once NW passes 2^24.
2. ``init_params`` bit-equal to the JAX ``init_params``: the JAX default
   PRNG in numpy (``models/_threefry.py``), each primitive held bitwise
   against ``jax.random``.
3. K1's CSR checks: a CPU CSR whose ``indptr[-1]`` is not its index count,
   or with an index outside x's rows, is refused; the partition refuses a
   corrupt shard block before it reaches the card.
"""

import jax
import numpy as np
import pytest
import torch

from gnn_mwvc_tpu.graph import DeviceGraph as JaxDeviceGraph
from gnn_mwvc_tpu.graph import Graph as JaxGraph
from gnn_mwvc_tpu.models import init_params as jax_init_params
from gnn_mwvc_tpu.models import load_pretrained as jax_load_pretrained
from gnn_mwvc_tpu.models.gnn import build_reference_arch as jax_arch
from gnn_mwvc_tpu.models.gnn import score_graph as jax_score_graph
from gnn_mwvc_tpu.train import make_sample as jax_make_sample
from gnn_mwvc_tpu_torch import graph as graph_module
from gnn_mwvc_tpu_torch.core import CoreSolver
from gnn_mwvc_tpu_torch.graph import DeviceGraph, Graph
from gnn_mwvc_tpu_torch.models import (MWVCModel, build_reference_arch,
                                       init_params, params_from_jax,
                                       pretrained_model, score_graph)
from gnn_mwvc_tpu_torch.models import _threefry as threefry
from gnn_mwvc_tpu_torch.ops.aggregate import csr_aggregate
from gnn_mwvc_tpu_torch.ops.rules import mask_inputs
from gnn_mwvc_tpu_torch.parallel import make_mesh, partition_device_graph
from gnn_mwvc_tpu_torch.solver.sharded_score import ShardedGnnScorer
from gnn_mwvc_tpu_torch.solver.static_score import StickyGnnScorer
from gnn_mwvc_tpu_torch.train import make_sample

SEEDS = (0, 1, 7, 12345)


def _heavy_graph(n=3000, deg=12, seed=5):
    """A random graph whose weights lie in [2^24, 2^31), so NW passes 2^24
    and float32 sums depend on their order."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n, size=n * deg)
    v = rng.integers(0, n, size=n * deg)
    lo, hi = np.minimum(u, v), np.maximum(u, v)
    edges = np.unique(np.stack([lo, hi], 1)[lo != hi], axis=0)
    w = rng.integers(2**24, 2**31, size=n)
    return JaxGraph(w, edges), Graph(w, edges)


def test_nw_bitwise_equal_to_jax_past_2_24():
    gj, g = _heavy_graph()
    want = np.asarray(JaxDeviceGraph.from_graph(gj).nw)[:g.n]
    dg = DeviceGraph.from_graph(g, "cpu")
    got = dg.nw.numpy()
    assert want.max() > 2**24
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    # the rule prepass sums NW with the same helper
    nw_rules = mask_inputs(g.weights, g.indptr, g.indices)[4]
    np.testing.assert_array_equal(nw_rules.view(np.uint32),
                                  want.view(np.uint32))
    # an exact sum rounded once differs on this graph: the order matters
    exact = np.bincount(g.row_ids(), weights=g.weights[g.indices].astype(
        np.float64), minlength=g.n).astype(np.float32)
    assert (exact != want).any()

    ws = float(g.weights.max())
    ref = np.asarray(jax_score_graph(jax_load_pretrained(),
                                     JaxDeviceGraph.from_graph(gj), ws))[:g.n]
    np.testing.assert_allclose(score_graph(pretrained_model(), dg, ws).numpy(),
                               ref, rtol=0, atol=2e-5)

    y = (np.arange(g.n) % 2).astype(np.float32)
    nw_sample = make_sample(g, y, device="cpu").dg.nw.numpy()
    nw_jax = np.asarray(jax_make_sample(gj, y).dg.nw)[:g.n]
    np.testing.assert_array_equal(nw_sample.view(np.uint32),
                                  nw_jax.view(np.uint32))


@pytest.mark.parametrize("sharded", [False, True], ids=["sticky", "sharded"])
def test_sticky_rebuild_takes_the_snapshot_nw(sharded, monkeypatch):
    """The sticky scorers score with the core's live NW, so a rebuild
    passes the snapshot's NW to ``DeviceGraph.build`` and sums none."""
    _gj, g = _heavy_graph(n=400)

    def refuse(*_args):
        raise AssertionError("a sticky rebuild summed NW")

    monkeypatch.setattr(graph_module, "neighbour_weight_sum", refuse)
    scorer = (ShardedGnnScorer(mesh=make_mesh(2, devices=["cpu"] * 2))
              if sharded else StickyGnnScorer(device="cpu", force_sticky=True))
    core = CoreSolver(g.weights, g.edge_array())
    _ids, prob, _w, _d = scorer.score_core(core, float(g.weights.max()))
    assert scorer.stats["rebuilds"] == 1 and np.isfinite(prob).all()
    if not sharded:
        np.testing.assert_array_equal(scorer._state[0].nw.numpy(),
                                      core.snapshot().nw.astype(np.float32))
    with pytest.raises(ValueError, match="nw has shape"):
        DeviceGraph.build(g.weights, g.indptr, g.indices, "cpu",
                          nw=np.zeros(g.n - 1))


@pytest.mark.parametrize("seed", SEEDS)
def test_init_params_bitwise_equal_to_jax(seed):
    kinds, dims = build_reference_arch()
    assert (kinds, dims) == jax_arch()
    want = params_from_jax(kinds, jax_init_params(kinds, dims, seed=seed))
    got = init_params(MWVCModel(kinds, dims), seed=seed).state_dict()
    assert list(got) == list(want)
    for name, t in got.items():
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy().view(np.uint32),
                                      want[name].numpy().view(np.uint32),
                                      err_msg=name)


@pytest.mark.parametrize("seed", SEEDS + (2**31 - 1,))
def test_threefry_key_bitwise_equal_to_jax(seed):
    want = np.asarray(jax.random.key_data(jax.random.key(seed)))
    np.testing.assert_array_equal(threefry.key(seed), want)


@pytest.mark.parametrize("num", [2, 3, 8])
@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_split_bitwise_equal_to_jax(seed, num):
    want = np.asarray(jax.random.key_data(
        jax.random.split(jax.random.key(seed), num)))
    np.testing.assert_array_equal(threefry.split(threefry.key(seed), num),
                                  want)


@pytest.mark.parametrize("shape", [(5, 32), (35, 32), (16, 1), (32,), (7,)])
@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_uniform_bitwise_equal_to_jax(seed, shape):
    lim = 1.0 / np.sqrt(shape[0] + 1)
    k = jax.random.key(seed)
    for lo, hi in ((-lim, lim), (0.0, 1.0)):
        want = np.asarray(jax.random.uniform(k, shape, jax.numpy.float32,
                                             lo, hi))
        got = threefry.uniform(threefry.key(seed), shape, lo, hi)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
    bits = np.asarray(jax.random.bits(k, shape, jax.numpy.uint32))
    np.testing.assert_array_equal(threefry.random_bits(threefry.key(seed),
                                                       shape), bits)


def _block():
    """A 3-row block over 5 sources, as a shard holds one."""
    x = torch.arange(10, dtype=torch.float32).reshape(5, 2)
    indptr = torch.tensor([0, 2, 3, 5], dtype=torch.int32)
    indices = torch.tensor([0, 4, 1, 2, 3], dtype=torch.int32)
    return x, indptr, indices


def test_block_csr_is_checked():
    x, indptr, indices = _block()
    out = csr_aggregate(x, indptr, indices, block=True)
    np.testing.assert_array_equal(out.numpy(), [[8, 10], [2, 3], [10, 12]])
    with pytest.raises(ValueError, match="indptr\\[-1\\]"):
        csr_aggregate(x, torch.tensor([0, 2, 3, 4], dtype=torch.int32),
                      indices, block=True)
    with pytest.raises(ValueError, match="indptr\\[-1\\]"):
        csr_aggregate(x, torch.tensor([0, 2, 3, 6], dtype=torch.int32),
                      indices, block=True)
    for bad in (5, -1):
        idx = indices.clone()
        idx[1] = bad
        with pytest.raises(ValueError, match="outside the 5 source rows"):
            csr_aggregate(x, indptr, idx, block=True)
    with pytest.raises(ValueError, match="at least 1 entry"):
        csr_aggregate(x, torch.zeros(0, dtype=torch.int32), indices,
                      block=True)
    # the transposed CSR indexes the 3 output rows
    t_ptr = torch.tensor([0, 1, 2, 3, 4, 5], dtype=torch.int32)
    t_idx = torch.tensor([0, 1, 2, 2, 3], dtype=torch.int32)
    with pytest.raises(ValueError, match="outside the 3 source rows"):
        csr_aggregate(x.requires_grad_(), indptr, indices,
                      transposed=(t_ptr, t_idx))


@pytest.mark.parametrize("fault", ["index", "indptr_end", "indptr_order"])
@pytest.mark.parametrize("parts,halo", [(1, True), (2, False)])
def test_partition_refuses_a_corrupt_block(fault, parts, halo):
    g = Graph(np.arange(1, 9), np.array([[0, 1], [1, 2], [2, 3], [4, 5],
                                         [5, 6], [6, 7], [0, 7]]))
    dg = DeviceGraph.from_graph(g, "cpu")
    partition_device_graph(dg, parts, halo=halo)   # the sound graph passes
    indptr, indices = dg.indptr.clone(), dg.indices.clone()
    if fault == "index":
        indices[-1] = 8 * (parts + 1)   # past every shard's source space
    elif fault == "indptr_end":
        indptr[-1] += 1
    else:
        a, b = int(indptr[2]), int(indptr[3])
        indptr[2], indptr[3] = b + 1, a   # row 2 ends before it starts
    bad = DeviceGraph(n=dg.n, indptr=indptr, indices=indices,
                      weights=dg.weights, degrees=dg.degrees, nw=dg.nw)
    with pytest.raises(ValueError, match="block CSR is corrupt"):
        partition_device_graph(bad, parts, halo=halo)
