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
from gnn_mwvc_tpu_torch.models import (MWVCModel, build_reference_arch,
                                       init_params)
from gnn_mwvc_tpu_torch.ops import _build
from gnn_mwvc_tpu_torch.ops.aggregate import csr_aggregate, csr_aggregate_plain
from gnn_mwvc_tpu_torch.ops.smallsolve_mitm import (small_mwvc_mitm,
                                                    small_mwvc_mitm_plain)
from gnn_mwvc_tpu_torch.solver.pipeline import solve
from gnn_mwvc_tpu_torch.train import TrainConfig, make_sample, train

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


@pytest.mark.parametrize("masked", [False, True])
def test_k1_backward_matches_plain_autograd_and_repeats(cuda, masked):
    rng = np.random.default_rng(3)
    dg = DeviceGraph.from_graph(build_road_graph(100), cuda)
    x = torch.from_numpy(rng.standard_normal((dg.n, 16)).astype(np.float32)
                         ).to(cuda).requires_grad_()
    g = torch.from_numpy(rng.standard_normal((dg.n, 16)).astype(np.float32)).to(cuda)
    mask = (torch.from_numpy((rng.random(dg.n) < 0.7).astype(np.float32)).to(cuda)
            if masked else None)
    before = _build.launches["csr_aggregate_backward"]
    out = csr_aggregate(x, dg.indptr, dg.indices, mask)
    (a,) = torch.autograd.grad(out, x, g, retain_graph=True)
    (b,) = torch.autograd.grad(out, x, g)
    assert _build.launches["csr_aggregate_backward"] == before + 2
    assert torch.equal(a, b)
    (ref,) = torch.autograd.grad(
        csr_aggregate_plain(x, dg.indptr, dg.indices, mask), x, g)
    # index_add_'s backward sums in another order, with atomics
    torch.testing.assert_close(a, ref, rtol=1e-5, atol=1e-5)


def test_train_step_on_cuda_matches_cpu(cuda):
    """One pass with one SGD step (batch_vertices 600 over three
    500-vertex training graphs) from the same parameters on both devices:
    parameters within 1e-5 of each tensor's largest entry, losses 1e-5
    relative (fp32 sums in other orders)."""
    rng = np.random.default_rng(4)
    graphs = [_random_graph(500, 8, seed=10 + i) for i in range(4)]
    labels = [(rng.random(g.n) < 0.5).astype(np.float32) for g in graphs]
    cfg = TrainConfig(epochs=0, batch_vertices=600, seed=1, log=False)
    runs = {}
    for dev in (torch.device("cpu"), cuda):
        samples = [make_sample(g, y, device=dev) for g, y in zip(graphs, labels)]
        start = init_params(MWVCModel(*build_reference_arch()), seed=7)
        before = _build.launches["csr_aggregate_backward"]
        model, hist = train(samples, cfg, model=start, device=dev)
        runs[dev.type] = (model, hist,
                          _build.launches["csr_aggregate_backward"] - before)
    (cm, ch, c_launch), (gm, gh, g_launch) = runs["cpu"], runs["cuda"]
    assert c_launch == 0 and g_launch >= 2 * 3
    assert ch[0]["steps"] == gh[0]["steps"] == 1
    for split in ("train", "test"):
        np.testing.assert_allclose(gh[0][split]["loss"], ch[0][split]["loss"],
                                   rtol=1e-5)
    for p, q in zip(gm.parameters(), cm.parameters()):
        p, q = p.detach().cpu(), q.detach()
        assert float((p - q).abs().max()) <= 1e-5 * float(q.abs().max())


def _k4_batch(rng, b, n):
    """Random regions with padding, unit weights (tie-heavy) and forced
    vertices, plus all-padding rows, full n-vertex cliques and rows of
    random asymmetric bits (the reference reads only some of them)."""
    adj = np.zeros((b, n), np.int32)
    w = np.zeros((b, n), np.int32)
    for i in range(b):
        kind = i % 6
        if kind == 0:
            continue                                    # all padding
        k = n if kind == 1 else int(rng.integers(1, n + 1))
        w[i, :k] = 1 if kind in (1, 2) else rng.integers(1, 1000, size=k)
        if kind == 1:                                   # clique
            adj[i, :k] = ((1 << k) - 1) ^ (1 << np.arange(k))
        elif kind == 5:                                 # asymmetric bits
            adj[i] = rng.integers(0, 2**31, size=n)
        else:
            for _ in range(2 * k):
                a, c = rng.integers(0, k, size=2)       # a == c: forced
                adj[i, a] |= 1 << c
                adj[i, c] |= 1 << a
    return adj, w


@pytest.mark.parametrize("b", [1, 7, 1024, 1500])
@pytest.mark.parametrize("n", [16, 20])
def test_k4_bitwise_equals_plain(cuda, n, b):
    adj, w = _k4_batch(np.random.default_rng(n * 10_000 + b), b, n)
    d_adj, d_w = torch.from_numpy(adj).to(cuda), torch.from_numpy(w).to(cuda)
    before = _build.launches["small_mwvc_mitm"]
    c1, s1 = small_mwvc_mitm(d_adj, d_w)
    assert _build.launches["small_mwvc_mitm"] == before + 1
    c0, s0 = small_mwvc_mitm_plain(d_adj, d_w)
    assert torch.equal(c0, c1) and torch.equal(s0, s1)


def _hub_graph():
    """A random graph with one isolated vertex (row of degree 0) and one
    hub of degree 150."""
    g = _random_graph(2000, 8, seed=5)
    hub = np.stack([np.zeros(150, np.int64), np.arange(10, 160)], 1)
    keep = (g.edge_array() != 1).all(1)                 # vertex 1 isolated
    edges = np.unique(np.concatenate([g.edge_array()[keep], hub]), axis=0)
    return Graph(g.weights, edges)


def _cpu_plain(x, dg, mask):
    return csr_aggregate_plain(x.cpu(), dg.indptr.cpu(), dg.indices.cpu(),
                               None if mask is None else mask.cpu())


@pytest.mark.parametrize("mask_kind", ["none", "f32", "u8"])
@pytest.mark.parametrize("w", [1, 3, 16, 35, 64])
def test_k1_bitwise_equals_cpu_plain(cuda, w, mask_kind):
    rng = np.random.default_rng(w)
    dg = DeviceGraph.from_graph(_hub_graph(), cuda)
    deg = (dg.indptr[1:] - dg.indptr[:-1]).cpu()
    assert int(deg.min()) == 0 and int(deg.max()) >= 100
    x = torch.from_numpy(rng.standard_normal((dg.n, w)).astype(np.float32)).to(cuda)
    alive = rng.random(dg.n) < 0.7
    mask = {"none": None,
            "f32": torch.from_numpy(alive.astype(np.float32)).to(cuda),
            "u8": torch.from_numpy(alive.astype(np.uint8)).to(cuda)}[mask_kind]
    got = csr_aggregate(x, dg.indptr, dg.indices, mask)
    assert torch.equal(got.cpu(), _cpu_plain(x, dg, mask))


def test_k1_unaligned_x_takes_the_scalar_path(cuda):
    """A contiguous x at a 4-byte storage offset: a float4 load from it
    would fault, so a bitwise-right result means the scalar path ran."""
    rng = np.random.default_rng(2)
    dg = DeviceGraph.from_graph(_hub_graph(), cuda)
    flat = torch.from_numpy(rng.standard_normal(dg.n * 16 + 1).astype(np.float32))
    x = flat.to(cuda)[1:].view(dg.n, 16)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    mask = torch.from_numpy((rng.random(dg.n) < 0.7).astype(np.float32)).to(cuda)
    got = csr_aggregate(x, dg.indptr, dg.indices, mask)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), _cpu_plain(x, dg, mask))


@pytest.mark.parametrize("masked", [False, True])
def test_k1_backward_bitwise_equals_cpu_autograd(cuda, masked):
    rng = np.random.default_rng(6)
    dg = DeviceGraph.from_graph(_hub_graph(), cuda)
    x = torch.from_numpy(rng.standard_normal((dg.n, 16)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((dg.n, 16)).astype(np.float32))
    mask = (torch.from_numpy((rng.random(dg.n) < 0.7).astype(np.float32))
            if masked else None)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        xd = x.to(dev).requires_grad_()
        out = csr_aggregate(xd, dg.indptr.to(dev), dg.indices.to(dev),
                            None if mask is None else mask.to(dev))
        (gx,) = torch.autograd.grad(out, xd, g.to(dev))
        grads.append(gx.cpu())
    assert torch.equal(grads[0], grads[1])


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
