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


def _big_weights(n, deg, seed):
    """Weights that push NW past 2^24 and some rows past 2^32."""
    g = _random_graph(n, deg, seed)
    rng = np.random.default_rng(seed)
    w = rng.integers(2**24, 2**31 - 1, size=n)
    w[rng.random(n) < 0.3] = 1
    return Graph(w, g.edge_array())


@pytest.mark.parametrize("name", ["road", "heavy"])
def test_rule_masks_and_r5_on_cuda_equal_cpu(cuda, name):
    from gnn_mwvc_tpu_torch.ops import rules

    g = build_road_graph(80) if name == "road" else _big_weights(3000, 8, 9)
    arrays = rules.mask_inputs(g.weights, g.indptr, g.indices)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        t = [torch.from_numpy(a).to(dev) for a in arrays]
        m = rules.rule_masks(*t, torch.ones(g.n, dtype=torch.bool, device=dev))
        assert all(v.device.type == dev.type for v in m.values())
        outs.append({k: v.cpu() for k, v in m.items()})
    for key in outs[1]:
        assert torch.equal(outs[0][key], outs[1][key]), key
    if name == "road":
        deg = np.diff(g.indptr)
        nw = np.bincount(np.repeat(np.arange(g.n), deg),
                         weights=g.weights[g.indices], minlength=g.n)
        ell, ellv = rules.build_ell8(g.indptr, g.indices, deg)
        args = (ell, ellv, g.weights.astype(np.int32), nw.astype(np.int32),
                deg.astype(np.int32), np.ones(g.n, bool))
        r5 = [rules.r5_candidates(*[torch.from_numpy(a).to(dev) for a in args],
                                  chunk=997).cpu()
              for dev in (cuda, torch.device("cpu"))]
        assert torch.equal(r5[0], r5[1])


def test_prepass_on_cuda_gives_the_cpu_stats(cuda):
    from gnn_mwvc_tpu_torch.core import CoreSolver
    from gnn_mwvc_tpu_torch.ops import rules
    from gnn_mwvc_tpu_torch.solver.device_reduce import device_reduce_prepass

    g = build_road_graph(120)
    runs = []
    for dev in (cuda, "cpu"):
        core = CoreSolver(g.weights, g.edge_array())
        rules.calls.clear()
        stats = device_reduce_prepass(core, min_nodes=0, device=dev)
        assert rules.calls[f"rule_masks/{torch.device(dev).type}"] == \
            stats["rounds"] >= 1
        snap = core.snapshot()
        runs.append((stats, core.cost, core.counters.tolist(),
                     snap.ids.tolist()))
    assert runs[0] == runs[1]


def test_enumeration_on_cuda_equals_k4(cuda):
    from gnn_mwvc_tpu_torch.ops.smallsolve import batched_small_mwvc

    adj, w = _k4_batch(np.random.default_rng(77), 1200, 16)
    # the enumeration reads each vertex's own bits; K4 the reference's
    # symmetrised conflicts, so they agree on symmetric rows only
    sym = np.arange(len(adj)) % 6 != 5
    adj, w = np.ascontiguousarray(adj[sym]), np.ascontiguousarray(w[sym])
    d_adj, d_w = torch.from_numpy(adj).to(cuda), torch.from_numpy(w).to(cuda)
    c0, s0 = batched_small_mwvc(d_adj, d_w)
    c1, s1 = small_mwvc_mitm(d_adj, d_w)
    assert c0.device.type == "cuda"
    assert torch.equal(c0, c1) and torch.equal(s0, s1)


def _cuda_block(rng, n_out, n_src):
    counts = rng.integers(0, 11, size=n_out)
    counts[3] = 200                                     # one long row
    indptr = np.zeros(n_out + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    indices = rng.integers(0, n_src, size=int(indptr[-1]))
    return (torch.from_numpy(indptr.astype(np.int32)),
            torch.from_numpy(indices.astype(np.int32)))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n_out,n_src", [(700, 2500), (2500, 700)])
def test_k1_block_and_its_backward_bitwise_equal_cpu(cuda, n_out, n_src,
                                                     masked):
    """K1 on a rectangular block, and its backward on the block's transposed
    CSR, bitwise equal to the plain version's on CPU copies."""
    from gnn_mwvc_tpu_torch.ops.aggregate import csr_transpose

    rng = np.random.default_rng(n_out + n_src)
    indptr, indices = _cuda_block(rng, n_out, n_src)
    x = torch.from_numpy(rng.standard_normal((n_src, 16)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((n_out, 16)).astype(np.float32))
    mask = (torch.from_numpy((rng.random(n_src) < 0.7).astype(np.float32))
            if masked else None)
    runs = []
    for dev in (cuda, torch.device("cpu")):
        ptr, idx = indptr.to(dev), indices.to(dev)
        t = csr_transpose(ptr, idx, n_src)
        xd = x.to(dev).requires_grad_()
        before = _build.launches["csr_aggregate_backward"]
        out = csr_aggregate(xd, ptr, idx, None if mask is None else mask.to(dev),
                            transposed=t)
        (gx,) = torch.autograd.grad(out, xd, g.to(dev))
        launched = _build.launches["csr_aggregate_backward"] - before
        assert launched == (1 if dev.type == "cuda" else 0)
        runs.append((out.detach().cpu(), gx.cpu(), [a.cpu() for a in t]))
    assert torch.equal(runs[0][2][0], runs[1][2][0])
    assert torch.equal(runs[0][2][1], runs[1][2][1])
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])


def test_sharded_forward_on_four_shards_of_one_card(cuda):
    """Four shards on cuda:0: every K1 output bitwise equal to the CPU's,
    2 x 4 K1 launches per forward, scores within 1e-6 of one device's."""
    from gnn_mwvc_tpu_torch.models import pretrained_model, score_graph
    from gnn_mwvc_tpu_torch.parallel import (gather_scores, make_mesh,
                                             make_sharded_forward,
                                             partition_device_graph)

    g = build_road_graph(150)
    ws = float(g.weights.max())
    outs = {}
    for dev in ("cuda:0", "cpu"):
        mesh = make_mesh(4, devices=[dev] * 4)
        sg = partition_device_graph(DeviceGraph.from_graph(g, dev), 4,
                                    devices=mesh)
        fwd = make_sharded_forward(pretrained_model(dev), mesh, masked=True,
                                   x_is_node_weights=True)
        before = _build.launches["csr_aggregate"]
        outs[dev] = gather_scores(sg, fwd(sg, ws))
        assert _build.launches["csr_aggregate"] - before == (
            8 if dev != "cpu" else 0)
    single = score_graph(pretrained_model(cuda), DeviceGraph.from_graph(g, cuda),
                         ws).cpu().numpy()
    np.testing.assert_allclose(outs["cuda:0"], single, atol=1e-6, rtol=0)
    np.testing.assert_allclose(outs["cuda:0"], outs["cpu"], atol=1e-6, rtol=0)


def test_sharded_forward_one_shard_per_card_k1_bitwise(cuda):
    """Two shards, one on each of cuda:0 and cuda:1: each shard's K1 output
    lies on its own card and is bitwise equal to its rows of the
    single-card K1 output; scores within 1e-5 of one card's."""
    import gnn_mwvc_tpu_torch.models.gnn as gnn_mod
    import gnn_mwvc_tpu_torch.parallel.sharded as sharded_mod
    from gnn_mwvc_tpu_torch.models import pretrained_model, score_graph
    from gnn_mwvc_tpu_torch.parallel import (gather_scores, make_mesh,
                                             make_sharded_forward,
                                             partition_device_graph)

    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 CUDA cards")

    def recorded(module, fn):
        kernel, outs = module.csr_aggregate, []

        def record(*args, **kw):
            outs.append(kernel(*args, **kw))
            return outs[-1]

        module.csr_aggregate = record
        try:
            return fn(), outs
        finally:
            module.csr_aggregate = kernel

    g = build_road_graph(150)
    ws = float(g.weights.max())
    dg = DeviceGraph.from_graph(g, "cuda:0")
    model = pretrained_model("cuda:0")
    single, want = recorded(gnn_mod, lambda: score_graph(model, dg, ws))
    mesh = make_mesh(2)
    sg = partition_device_graph(dg, 2, devices=mesh)
    fwd = make_sharded_forward(model, mesh, x_is_node_weights=True)
    before = _build.launches["csr_aggregate"]
    outs, aggs = recorded(sharded_mod, lambda: fwd(sg, ws))
    assert _build.launches["csr_aggregate"] - before == 2 * 2
    for layer in range(2):
        for p in range(2):
            a = aggs[layer * 2 + p]
            assert a.device == torch.device(f"cuda:{p}")
            real = int(sg.shards[p].node_mask.sum())
            lo = p * sg.n_loc
            assert torch.equal(a[:real].cpu(),
                               want[layer][lo:lo + real].cpu())
    np.testing.assert_allclose(gather_scores(sg, outs),
                               single.cpu().numpy()[:g.n], atol=1e-5, rtol=0)


def test_precision_on_cuda_is_scoped(cuda):
    """"default" (TF32) then "highest" on the card: "highest" gives its
    first bits again, and the process's TF32 flag is what it was after each
    call, also when it was switched on before."""
    from gnn_mwvc_tpu_torch.models import pretrained_model

    flags = torch.backends.cuda.matmul
    name = "fp32_precision" if hasattr(flags, "fp32_precision") \
        else "allow_tf32"
    before = getattr(flags, name)
    g = build_road_graph(200)
    dg = DeviceGraph.from_graph(g, cuda)
    ws = float(g.weights.max())
    model = pretrained_model(cuda)
    x = (dg.weights / ws).reshape(-1, 1)
    try:
        for state in (before, "tf32" if name == "fp32_precision" else True):
            setattr(flags, name, state)
            state = getattr(flags, name)
            with torch.no_grad():
                first = model(x, dg, ws, x_is_node_weights=True)
                assert getattr(flags, name) == state
                tf32 = model(x, dg, ws, x_is_node_weights=True,
                             precision="default")
                assert getattr(flags, name) == state
                again = model(x, dg, ws, x_is_node_weights=True,
                              precision="highest")
                assert getattr(flags, name) == state
            assert torch.equal(again, first)
            assert torch.allclose(tf32, first, atol=1e-2, rtol=0)
    finally:
        setattr(flags, name, before)


def test_sticky_rounds_under_the_threshold_run_on_cuda(cuda):
    """road100 (under 4M live edges): every round per snapshot, on the
    card, with K1's two launches each."""
    from gnn_mwvc_tpu_torch.solver.static_score import StickyGnnScorer

    g = build_road_graph(100)
    scorer = StickyGnnScorer(device=cuda)
    _build.launches.clear()
    res = solve(g, time_limit=0.0, device=cuda, scorer=scorer,
                device_assist=False)
    rounds = res.phase1["rounds"]
    assert is_vertex_cover(g, res.solution)
    assert scorer.stats["legacy_rounds"] == rounds > 0
    assert scorer.stats["rounds"] == 0
    assert scorer._snapshot_scorer.device.type == "cuda"
    assert _build.launches["csr_aggregate"] == 2 * rounds
