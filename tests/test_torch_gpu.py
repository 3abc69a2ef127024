"""The CUDA kernels and the CUDA solve path; these need a GPU and skip
without one.  This file imports no jax, so on a machine without it run:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import io

import numpy as np
import pytest
import torch

from gnn_mwvc_tpu_torch.graph import DeviceGraph, Graph, build_road_graph
from gnn_mwvc_tpu_torch.graphio import cover_cost, is_vertex_cover, read_metis
from gnn_mwvc_tpu_torch.ops import _build
from gnn_mwvc_tpu_torch.ops.aggregate import csr_aggregate, csr_aggregate_plain
from gnn_mwvc_tpu_torch.ops.smallsolve_mitm import (small_mwvc_mitm,
                                                    small_mwvc_mitm_plain)
from gnn_mwvc_tpu_torch.solver.pipeline import solve

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _random_graph(n, deg, seed, wmax=1000):
    rng = np.random.default_rng(seed)
    m = n * deg // 2
    u, v = rng.integers(0, n, size=(2, 2 * m))
    lo, hi = np.minimum(u, v), np.maximum(u, v)
    e = np.unique(np.stack([lo, hi], 1)[lo != hi], axis=0)[:m]
    return Graph(rng.integers(1, wmax + 1, size=n), e)


@pytest.mark.parametrize("masked", [False, True])
def test_k1_matches_plain_and_repeats(cuda, masked):
    rng = np.random.default_rng(1)
    dg = DeviceGraph.from_graph(build_road_graph(100), cuda)
    x = torch.from_numpy(rng.standard_normal((dg.n, 16)).astype(np.float32)).to(cuda)
    mask = (torch.from_numpy((rng.random(dg.n) < 0.7).astype(np.float32)).to(cuda)
            if masked else None)
    before = _build.launches["csr_aggregate"]
    a = csr_aggregate(x, dg.indptr, dg.indices, mask)
    b = csr_aggregate(x, dg.indptr, dg.indices, mask)
    assert _build.launches["csr_aggregate"] == before + 2
    assert torch.equal(a, b)
    ref = csr_aggregate_plain(x, dg.indptr, dg.indices, mask)
    torch.testing.assert_close(a, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [16, 20])
def test_k4_bitwise_equals_plain(cuda, n):
    rng = np.random.default_rng(n)
    adj = np.zeros((256, n), np.int32)
    w = np.zeros((256, n), np.int32)
    for i in range(256):
        k = int(rng.integers(1, n + 1))
        w[i, :k] = 1 if i % 3 == 0 else rng.integers(1, 1000, size=k)
        for _ in range(2 * k):
            a, b = rng.integers(0, k, size=2)  # a == b: forced vertex
            adj[i, a] |= 1 << b
            adj[i, b] |= 1 << a
    d_adj, d_w = torch.from_numpy(adj).to(cuda), torch.from_numpy(w).to(cuda)
    c1, s1 = small_mwvc_mitm(d_adj, d_w)
    c0, s0 = small_mwvc_mitm_plain(d_adj, d_w)
    assert torch.equal(c0, c1) and torch.equal(s0, s1)


def test_solve_on_cuda_uses_both_kernels(cuda):
    ex3 = read_metis(io.BytesIO(b"3 2 10\n15 3\n15 3\n20 1 2\n"))
    assert solve(ex3, time_limit=0.5, device=cuda).cost == 20
    g = _random_graph(3000, 12, seed=2, wmax=500)
    _build.launches.clear()
    res = solve(g, time_limit=3.0, device=cuda, assist_batch=64)
    assert is_vertex_cover(g, res.solution)
    assert cover_cost(g, res.solution) == res.cost
    assert _build.launches["csr_aggregate"] >= 2 * res.phase1["rounds"] > 0
    assert _build.launches["small_mwvc_mitm"] >= 1
    assert res.assist_stats["batches"] >= 1
