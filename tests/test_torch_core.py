"""The port's own native-core bindings against the JAX package's.

Both bind the same C++ sources; the port compiles them into its own
``_build/`` directory.  Same inputs, same calls: the arrays must be equal.
"""

import os

import numpy as np
import pytest

import bench
from gnn_mwvc_tpu import core as jax_core
from gnn_mwvc_tpu_torch import core
from gnn_mwvc_tpu_torch.core import api
from tests.conftest import random_graph

GRAPHS = {"road60": lambda: bench.build_road_graph(60),
          "er800": lambda: random_graph(800, 6, seed=11, wmax=300)}
SNAPSHOT_FIELDS = ("ids", "weights", "nw", "deg", "indptr", "indices")


def test_library_is_built_into_the_port():
    core.CoreSolver(np.ones(2), np.array([[0, 1]]))
    build_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(core.__file__))), "_build")
    assert os.path.dirname(api.LIB_PATH) == build_dir
    assert os.path.exists(api.LIB_PATH)


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("num_rules", [3, 7])
def test_reduce_and_snapshot_equal_jax(name, num_rules):
    gj = GRAPHS[name]()
    ours = core.CoreSolver(gj.weights, gj.edge_array(), num_rules=num_rules)
    ref = jax_core.CoreSolver(gj.weights, gj.edge_array(), num_rules=num_rules)
    ours.reduce()
    ref.reduce()
    assert (ours.active_count, ours.cost, ours.n_nodes, ours.timestamp) == (
        ref.active_count, ref.cost, ref.n_nodes, ref.timestamp)
    np.testing.assert_array_equal(ours.counters, ref.counters)
    a, b = ours.snapshot(), ref.snapshot()
    for field in SNAPSHOT_FIELDS:
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field),
                                      err_msg=field)


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("rmax", [16, 20])
def test_extract_regions_equal_jax(name, rmax):
    gj = GRAPHS[name]()
    rng = np.random.default_rng(3)
    cover = np.ones(gj.n, np.uint8)
    cover[rng.random(gj.n) < 0.3] = 0
    u, v = gj.edge_array().T
    cover[u[(cover[u] == 0) & (cover[v] == 0)]] = 1   # repair to a cover
    ours = core.CoreLocalSearch(gj.weights, gj.edge_array(), cover)
    ref = jax_core.CoreLocalSearch(gj.weights, gj.edge_array(), cover)
    centers = rng.choice(np.nonzero(cover)[0], size=256).astype(np.uint32)
    got = ours.extract_regions(centers, rmax=rmax)
    want = ref.extract_regions(centers, rmax=rmax)
    assert int((got[3] > 0).sum()) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert ours.cost == ref.cost


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_orders_equal_jax(name):
    gj = GRAPHS[name]()
    rng = np.random.default_rng(4)
    prob = rng.random(gj.n).astype(np.float32)
    deg = np.diff(gj.indptr).astype(np.uint32)
    np.testing.assert_array_equal(
        core.confidence_order_native(prob, gj.weights, deg, 1e-4),
        jax_core.confidence_order_native(prob, gj.weights, deg, 1e-4))
    np.testing.assert_array_equal(
        core.cluster_order(gj.indptr, gj.indices),
        jax_core.cluster_order(gj.indptr, gj.indices))
