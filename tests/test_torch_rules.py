"""The port's rule masks, r5 verdicts and twin groups against the JAX
package's ``ops/rules.py`` on the same graphs: bitwise equal.

The JAX masks read W, D and NW as float32 from its padded
``DeviceGraph.build`` (NW summed in float32); the port builds its inputs
the same way (``mask_inputs``).  The large-weight graphs push NW past 2^24,
where a sum rounded once would differ, and past 2^32, where the twin key's
float -> uint32 conversion saturates.
"""

import numpy as np
import pytest
import torch

import bench
import jax.numpy as jnp
from gnn_mwvc_tpu.graph import DeviceGraph as JaxDeviceGraph
from gnn_mwvc_tpu.graph import Graph as JaxGraph
from gnn_mwvc_tpu.ops import rules as jax_rules
from gnn_mwvc_tpu_torch.ops import rules
from tests.conftest import random_graph


def _star_twin(seed=0):
    """Stars with light leaves (r1 fires on the centres) and vertex pairs
    with equal neighbourhoods (twins)."""
    rng = np.random.default_rng(seed)
    edges = [(c, leaf) for c in range(0, 2000, 20)
             for leaf in range(c + 1, c + 20)]
    for i in range(2000, 2200, 2):
        a, b = 2200 + (i % 100), 2200 + ((i + 7) % 100)
        edges += [(i, a), (i, b), (i + 1, a), (i + 1, b)]
    w = rng.integers(1, 10, size=2300)
    w[:2000:20] = 1000
    w[2000:2200] = 7
    return JaxGraph(w, np.unique(np.array(edges), axis=0))


def _heavy(seed, wmax):
    """Random graph whose weights push NW past 2^24 (and past 2^32 when
    wmax is near 2^31)."""
    g = random_graph(3000, 8, seed=seed)
    rng = np.random.default_rng(seed)
    w = rng.integers(wmax // 2, wmax, size=g.n)
    w[rng.random(g.n) < 0.3] = 1
    return JaxGraph(w, g.edge_array())


GRAPHS = {
    "random": lambda: random_graph(2000, 6, seed=3, wmax=200),
    "road": lambda: bench.build_road_graph(60),
    "star_twin": _star_twin,
    "nw_over_2^24": lambda: _heavy(5, 2**26),
    "nw_over_2^32": lambda: _heavy(6, 2**31 - 1),
}


def _jax_masks(g):
    dg = JaxDeviceGraph.build(g.weights, g.indptr, g.indices, with_ell=False)
    m = jax_rules.rule_masks(
        jnp.asarray(dg.row), jnp.asarray(dg.col), jnp.asarray(dg.weights),
        jnp.asarray(dg.degrees), jnp.asarray(dg.nw),
        jnp.asarray(dg.node_mask))
    cut = {"r1": g.n, "twin_key": g.n, "iso_cand": g.n,
           "dom_edge": len(g.indices)}
    return {k: np.asarray(v)[:cut[k]] for k, v in m.items()}


def _port_masks(g):
    arrays = rules.mask_inputs(g.weights, g.indptr, g.indices)
    t = [torch.from_numpy(a) for a in arrays]
    m = rules.rule_masks(*t, torch.ones(g.n, dtype=torch.bool))
    return {k: v.numpy() for k, v in m.items()}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_rule_masks_bitwise_equal_jax(name):
    g = GRAPHS[name]()
    want = _jax_masks(g)
    got = _port_masks(g)
    for key in ("r1", "dom_edge", "iso_cand"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert got[key].dtype == np.bool_
    # the port holds the uint32 key in int64
    np.testing.assert_array_equal(got["twin_key"],
                                  want["twin_key"].astype(np.int64))
    assert got["twin_key"].min() >= 0 and got["twin_key"].max() < 2**32
    assert want["r1"].any() or name.startswith("nw_over")


def test_large_weight_cases_reach_their_ranges():
    """The two heavy graphs really exercise float32 rounding and the
    uint32 saturation of NW."""
    for name, lo in (("nw_over_2^24", 2**24), ("nw_over_2^32", 2**32)):
        g = GRAPHS[name]()
        nw = rules.mask_inputs(g.weights, g.indptr, g.indices)[4]
        exact = np.bincount(np.repeat(np.arange(g.n), np.diff(g.indptr)),
                            weights=g.weights[g.indices].astype(np.float64),
                            minlength=g.n)
        assert (nw.astype(np.float64) > lo).any(), name
        # a float32 sum rounded at every add differs from the exact sum
        assert (nw.astype(np.float64) != exact).any(), name


def test_float32_nw_is_summed_the_jax_way():
    """A once-rounded NW gives another r1 or twin key here: the masks and
    the port's DeviceGraph both sum NW in the JAX package's order."""
    from gnn_mwvc_tpu_torch.graph import DeviceGraph

    g = GRAPHS["nw_over_2^24"]()
    ours = rules.mask_inputs(g.weights, g.indptr, g.indices)[4]
    once = np.bincount(np.repeat(np.arange(g.n), np.diff(g.indptr)),
                       weights=g.weights[g.indices].astype(np.float32)
                       .astype(np.float64), minlength=g.n).astype(np.float32)
    assert (ours != once).any()
    dg = JaxDeviceGraph.build(g.weights, g.indptr, g.indices, with_ell=False)
    np.testing.assert_array_equal(ours, dg.nw[:g.n])
    port = DeviceGraph.build(g.weights, g.indptr, g.indices, "cpu").nw.numpy()
    np.testing.assert_array_equal(port, dg.nw[:g.n])


def _ell_inputs(g):
    deg = np.diff(g.indptr)
    ell, ellv = rules.build_ell8(g.indptr.astype(np.int64),
                                 g.indices.astype(np.int64), deg)
    nw = np.zeros(g.n, np.int64)
    np.add.at(nw, np.repeat(np.arange(g.n), deg), g.weights[g.indices])
    return ell, ellv, deg, nw


@pytest.mark.parametrize("name", sorted(n for n in GRAPHS
                                        if n != "nw_over_2^32"))
def test_build_ell8_and_r5_bitwise_equal_jax(name):
    g = GRAPHS[name]()
    ell, ellv, deg, nw = _ell_inputs(g)
    assert nw.max() < 2**31  # r5's int32 domain (device_reduce guards it)
    jell, jellv = jax_rules.build_ell8(g.indptr.astype(np.int64),
                                       g.indices.astype(np.int64), deg)
    np.testing.assert_array_equal(ell, jell)
    np.testing.assert_array_equal(ellv, jellv)
    args = (ell, ellv, g.weights.astype(np.int32), nw.astype(np.int32),
            deg.astype(np.int32))
    want = np.asarray(jax_rules.r5_candidates(
        *[jnp.asarray(a) for a in args], jnp.ones(g.n, bool)))
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    everyone = torch.ones(g.n, dtype=torch.bool)
    # the result does not depend on the chunk of vertices per step
    for chunk in (rules.R5_CHUNK, 97):
        got = rules.r5_candidates(*t, everyone, chunk=chunk).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"chunk {chunk}")
    assert want.dtype == got.dtype == np.bool_


def test_r5_candidates_respects_node_mask():
    g = GRAPHS["star_twin"]()
    ell, ellv, deg, nw = _ell_inputs(g)
    mask = np.random.default_rng(1).random(g.n) < 0.5
    args = (ell, ellv, g.weights.astype(np.int32), nw.astype(np.int32),
            deg.astype(np.int32), mask)
    want = np.asarray(jax_rules.r5_candidates(*[jnp.asarray(a)
                                                for a in args]))
    got = rules.r5_candidates(*[torch.from_numpy(np.ascontiguousarray(a))
                                for a in args]).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[~mask].any()


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_twin_groups_equal_jax(name):
    g = GRAPHS[name]()
    keys = _port_masks(g)["twin_key"]
    jkeys = _jax_masks(g)["twin_key"]
    everyone = np.ones(g.n, bool)
    got = rules.twin_groups(torch.from_numpy(keys), torch.from_numpy(everyone))
    want = jax_rules.twin_groups(jkeys, everyone)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    if name == "star_twin":
        assert any({2000, 2001} <= set(grp.tolist()) for grp in got)


def test_twin_hash_wraps_like_uint32():
    """Rows of many large ids: the per-row sum wraps past 2^32."""
    n = 5000
    row = np.repeat(np.arange(10), 500).astype(np.int32)
    col = np.tile(np.arange(n - 500, n), 10).astype(np.int32)
    want = np.asarray(jax_rules.twin_hash(jnp.asarray(row), jnp.asarray(col),
                                          n))
    got = rules.twin_hash(torch.from_numpy(row), torch.from_numpy(col), n)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
