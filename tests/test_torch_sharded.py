"""The port's multi-device path against the JAX package's, on the CPU.

The JAX side runs on the 8 virtual CPU devices of ``tests/conftest.py``; the
port's meshes put P shards on the CPU (``make_mesh(P, devices=["cpu"] * P)``),
which drives the partition, the exchange and the per-shard layer walk.  The
graphs are the JAX package's ``tests/test_sharded.py`` ones.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import bench
from gnn_mwvc_tpu.graph import DeviceGraph as JaxDeviceGraph
from gnn_mwvc_tpu.models import load_pretrained
from gnn_mwvc_tpu.models.gnn import score_graph as jax_score_graph
from gnn_mwvc_tpu.parallel import make_mesh as jax_make_mesh
from gnn_mwvc_tpu.parallel import make_sharded_forward as jax_sharded_forward
from gnn_mwvc_tpu.parallel import make_sharded_train_step as jax_train_step
from gnn_mwvc_tpu.parallel import partition_device_graph as jax_partition
from gnn_mwvc_tpu_torch.core import CoreSolver
from gnn_mwvc_tpu_torch.graph import DeviceGraph, Graph
from gnn_mwvc_tpu_torch.graphio import (cover_cost, is_vertex_cover,
                                        read_solution, write_metis)
from gnn_mwvc_tpu_torch.models import (params_from_jax, pretrained_model,
                                       score_graph)
from gnn_mwvc_tpu_torch.ops.aggregate import csr_aggregate_plain
from gnn_mwvc_tpu_torch.parallel import (gather_scores, make_mesh,
                                         make_sharded_forward,
                                         make_sharded_train_step,
                                         partition_device_graph)
from gnn_mwvc_tpu_torch.parallel.dryrun import dryrun_multichip
from gnn_mwvc_tpu_torch.parallel.sharded import _aggregate
from gnn_mwvc_tpu_torch.solver.pipeline import (confidence_order, gnn_peel,
                                                solve)
from gnn_mwvc_tpu_torch.solver.sharded_score import ShardedGnnScorer
from gnn_mwvc_tpu_torch.solver.static_score import StickyGnnScorer
from tests.conftest import random_graph

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jax_make_mesh(8)


def _cpu_mesh(parts):
    return make_mesh(parts, devices=["cpu"] * parts)


def _port(gj):
    return Graph(gj.weights, gj.edge_array())


def _decode(sg, shard):
    """Each edge's source of a shard's block as a global node id."""
    idx = shard.indices.long()
    if shard.send_idx is None:
        return idx
    n_loc = sg.n_loc
    if not sg.halo:
        return torch.where(idx < n_loc, shard.index * n_loc + idx, idx - n_loc)
    slot = (idx - n_loc).clamp(min=0)
    q, j = slot // sg.h_max, slot % sg.h_max
    sends = torch.stack([sh.send_idx for sh in sg.shards])
    remote = q * n_loc + sends[q, shard.index * sg.h_max + j]
    return torch.where(idx < n_loc, shard.index * n_loc + idx, remote)


@pytest.mark.parametrize("halo", [True, False])
def test_partition_covers_all_edges(halo):
    """Every edge is recovered exactly once, in the graph's CSR order, from
    the shards' blocks (ports of test_partition_covers_all_edges and
    test_halo_partition_covers_all_edges)."""
    g = _port(random_graph(300, 6, seed=1))
    dg = DeviceGraph.from_graph(g, "cpu")
    sg = partition_device_graph(dg, 4, halo=halo)
    assert sg.halo == halo and len(sg.shards) == 4
    rows, cols = [], []
    for sh in sg.shards:
        deg = (sh.indptr[1:] - sh.indptr[:-1]).long()
        local = torch.repeat_interleave(torch.arange(sg.n_loc), deg)
        assert bool(sh.node_mask[local].all())   # padding rows have no edges
        rows.append(sh.index * sg.n_loc + local)
        cols.append(_decode(sg, sh))
        assert int(sh.indices.max()) < sh.n_src
    assert int(torch.cat(rows).numel()) == int(dg.indices.numel())
    np.testing.assert_array_equal(torch.cat(rows).numpy(), g.row_ids())
    np.testing.assert_array_equal(torch.cat(cols).numpy(), g.indices)


def test_halo_bytes_proportional_to_boundary():
    """On a pure grid the exchange moves the cut, not the graph (port of
    the JAX test of the same name)."""
    side = 120
    dg = DeviceGraph.from_graph(_port(bench.build_road_graph(side, extra=0.0)),
                                "cpu")
    sg = partition_device_graph(dg, 8)
    full = partition_device_graph(dg, 8, halo=False)
    assert sg.halo_bytes_per_chip() < full.halo_bytes_per_chip() / 10
    assert sg.h_max <= 2 * side + 8
    sg4 = partition_device_graph(dg, 4)
    assert abs(sg4.h_max - sg.h_max) <= 16


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("parts", [2, 4, 8])
def test_shard_aggregate_bitwise_equals_single(parts, masked):
    """Each shard's neighbour sum of a given h is bitwise equal to its rows
    of the single-device plain aggregate."""
    g = _port(random_graph(700, 10, seed=21))
    dg = DeviceGraph.from_graph(g, "cpu")
    mesh = _cpu_mesh(parts)
    sg = partition_device_graph(dg, parts, devices=mesh)
    rng = np.random.default_rng(parts)
    h = torch.from_numpy(rng.standard_normal(
        (parts * sg.n_loc, 16)).astype(np.float32))
    mask = torch.from_numpy((rng.random(parts * sg.n_loc) < 0.7)
                            .astype(np.float32))
    if masked:
        want = csr_aggregate_plain(h[:g.n], dg.indptr, dg.indices, mask[:g.n])
        hs = list((h * mask[:, None]).split(sg.n_loc))
        got = _aggregate(hs, sg, mesh, list(mask.split(sg.n_loc)))
    else:
        want = csr_aggregate_plain(h[:g.n], dg.indptr, dg.indices)
        got = _aggregate(list(h.split(sg.n_loc)), sg, mesh)
    for sh, a in zip(sg.shards, got):
        lo = sh.index * sg.n_loc
        real = int(sh.node_mask.sum())
        assert torch.equal(a[:real], want[lo:lo + real])
        assert not bool(a[real:].any())


def test_sharded_forward_matches_jax_and_single(mesh8):
    gj = random_graph(700, 10, seed=21)
    ws = float(gj.weights.max())
    mj = load_pretrained()
    dgj = JaxDeviceGraph.from_graph(gj)
    jax_single = np.asarray(jax_score_graph(mj, dgj, ws))[:gj.n]
    sgj = jax_partition(dgj, 8)
    out = np.asarray(jax_sharded_forward(mj.kinds, mesh8)(mj.params, sgj, ws))
    jax_sharded = out.reshape(-1)[np.asarray(sgj.node_mask).reshape(-1)][:gj.n]

    dg = DeviceGraph.from_graph(_port(gj), "cpu")
    model = pretrained_model("cpu")
    single = score_graph(model, dg, ws).numpy()
    for parts in (4, 8):
        mesh = _cpu_mesh(parts)
        sg = partition_device_graph(dg, parts, devices=mesh)
        for x_nw in (False, True):
            got = gather_scores(sg, make_sharded_forward(
                model, mesh, x_is_node_weights=x_nw)(sg, ws))
            np.testing.assert_allclose(got, jax_sharded, atol=1e-5, rtol=0)
            np.testing.assert_allclose(got, jax_single, atol=1e-5, rtol=0)
            np.testing.assert_allclose(got, single, atol=1e-6, rtol=0)


def test_halo_fullgather_parity():
    """halo=True and halo=False give the same scores."""
    g = _port(random_graph(500, 8, seed=5))
    dg = DeviceGraph.from_graph(g, "cpu")
    ws = float(g.weights.max())
    mesh = _cpu_mesh(8)
    fwd = make_sharded_forward(pretrained_model("cpu"), mesh)
    outs = [gather_scores(sg, fwd(sg, ws)) for sg in (
        partition_device_graph(dg, 8, halo=halo, devices=mesh)
        for halo in (True, False))]
    np.testing.assert_allclose(outs[0], outs[1], atol=1e-6, rtol=0)


@pytest.mark.parametrize("side,frac", [(40, 1.0), (100, 0.02)])
def test_sticky_sharded_forward_matches_sticky_scorer(side, frac):
    """Two cores peeled in step, one scored by the sticky scorer and one by
    the sharded scorer: equal ids and scores within 1e-6 every round, on one
    build with gadget nodes (road40) and through rebuilds (road100)."""
    g = _port(bench.build_road_graph(side))
    ws = float(g.weights.max())
    ca = CoreSolver(g.weights, g.edge_array())
    cb = CoreSolver(g.weights, g.edge_array())
    ca.reduce()
    cb.reduce()
    single = StickyGnnScorer(device="cpu", rebuild_gadget_frac=frac,
                             force_sticky=True)
    sharded = ShardedGnnScorer(mesh=_cpu_mesh(4), rebuild_gadget_frac=frac)
    rounds = 0
    while True:
        ca.solve_small_components(75)
        cb.solve_small_components(75)
        assert ca.active_count == cb.active_count
        if ca.active_count == 0:
            break
        ids_a, p_a, w_a, d_a = single.score_core(ca, ws)
        ids_b, p_b, w_b, d_b = sharded.score_core(cb, ws)
        np.testing.assert_array_equal(ids_b, ids_a)
        np.testing.assert_array_equal(w_b, w_a)
        np.testing.assert_array_equal(d_b, d_a)
        np.testing.assert_allclose(p_b, p_a, atol=1e-6, rtol=0)
        order = confidence_order(p_a, w_a, d_a)
        for core in (ca, cb):
            core.reset_label_count()
            core.peel(ids_a[order], p_a[order].astype(np.float32), -1)
        rounds += 1
    assert ca.cost == cb.cost
    assert sharded.stats["rounds"] == rounds >= 2
    assert sharded.stats["rebuilds"] == single.stats["rebuilds"]
    if frac == 1.0:   # no rebuild: later rounds re-score the first build
        assert sharded.stats["rebuilds"] == 1
    else:             # a fresh partition past the gadget bound
        assert sharded.stats["rebuilds"] >= 2


def test_sharded_scorer_matches_jax_scorer(mesh8):
    """Port of test_sharded_scorer_matches_legacy_scores: the same reduced
    core scored by both packages' sharded scorers."""
    from gnn_mwvc_tpu.core import CoreSolver as JaxCore
    from gnn_mwvc_tpu.solver.sharded_score import \
        ShardedGnnScorer as JaxShardedScorer

    gj = random_graph(3000, 12, seed=2, wmax=500)
    ws = float(gj.weights.max())
    cj = JaxCore(gj.weights, gj.edge_array())
    ct = CoreSolver(gj.weights, gj.edge_array())
    cj.reduce()
    ct.reduce()
    assert ct.active_count == cj.active_count > 100
    ids_j, p_j, _w, _d = JaxShardedScorer(mesh=mesh8).score_core(cj, ws)
    sh = ShardedGnnScorer(mesh=_cpu_mesh(8))
    ids_t, p_t, _w, _d = sh.score_core(ct, ws)
    oj, ot = np.argsort(ids_j), np.argsort(ids_t)
    np.testing.assert_array_equal(ids_t[ot], ids_j[oj])
    np.testing.assert_allclose(p_t[ot], p_j[oj], atol=2e-5, rtol=0)
    assert sh.stats["rounds"] == 1 and sh.stats["parts"] == 8


def test_sharded_solve_equals_jax_and_single(mesh8):
    """solve(time_limit=0): the sharded cover equals the JAX package's
    sharded cover and the port's single-device cover."""
    from gnn_mwvc_tpu.solver import solve as jax_solve
    from gnn_mwvc_tpu.solver.sharded_score import \
        ShardedGnnScorer as JaxShardedScorer

    gj = random_graph(3000, 12, seed=2, wmax=500)
    ref = jax_solve(gj, time_limit=0.0, scorer=JaxShardedScorer(mesh=mesh8),
                    device_assist=False)
    g = _port(gj)
    res = solve(g, time_limit=0, scorer=ShardedGnnScorer(mesh=_cpu_mesh(8)),
                device="cpu", device_assist=False)
    one = solve(g, time_limit=0, device="cpu", device_assist=False)
    assert is_vertex_cover(g, res.solution)
    assert cover_cost(g, res.solution) == res.cost
    np.testing.assert_array_equal(res.solution, ref.solution)
    np.testing.assert_array_equal(res.solution, one.solution)
    assert res.cost == ref.cost == one.cost


def test_sharded_scorer_rebuilds_past_the_gadget_bound():
    """Past the gadget drift bound the partition is built afresh; a full
    peel through the sharded scorer empties the core."""
    g = _port(bench.build_road_graph(60))
    ws = float(g.weights.max())
    core = CoreSolver(g.weights, g.edge_array())
    sh = ShardedGnnScorer(mesh=_cpu_mesh(4), rebuild_gadget_frac=0.005)
    _t, _k, _c, split = gnn_peel(core, sh, ws)
    assert core.active_count == 0
    assert sh.stats["rebuilds"] >= 2   # the first build, then a rebuild
    assert split["rounds"] == sh.stats["rounds"]


def test_sharded_train_step_matches_jax(mesh8):
    """Two steps of full-batch MSE + SGD(momentum 0.9): the loss of each
    step and every parameter tensor after them within 1e-5 of the JAX
    package's make_sharded_train_step on 8 devices."""
    import optax

    gj = random_graph(256, 6, seed=13)
    ws = float(gj.weights.max())
    labels = (np.random.default_rng(13).random(gj.n) < 0.5).astype(np.float32)
    mj = load_pretrained()
    sgj = jax_partition(JaxDeviceGraph.from_graph(gj), 8)
    yj = np.zeros(8 * sgj.n_loc, np.float32)
    yj[:gj.n] = labels
    step_j, tx = jax_train_step(mj.kinds, mesh8)
    params, state = mj.params, tx.init(mj.params)
    jax_losses = []
    for _ in range(2):
        params, state, loss = step_j(params, state, sgj,
                                     yj.reshape(8, -1), ws)
        jax_losses.append(float(loss))
    assert isinstance(tx, optax.GradientTransformation)

    for parts in (4, 8):
        model = pretrained_model("cpu")
        mesh = _cpu_mesh(parts)
        sg = partition_device_graph(DeviceGraph.from_graph(_port(gj), "cpu"),
                                    parts, devices=mesh)
        y = np.zeros(parts * sg.n_loc, np.float32)
        y[:gj.n] = labels
        step, _opt = make_sharded_train_step(model, mesh)
        losses = [step(sg, y.reshape(parts, -1), ws) for _ in range(2)]
        np.testing.assert_allclose(losses, jax_losses, atol=1e-5, rtol=0)
        assert losses[1] < losses[0]
        want = params_from_jax(mj.kinds, params)
        for name, p in model.state_dict().items():
            np.testing.assert_allclose(p.numpy(), want[name].numpy(),
                                       atol=1e-5, rtol=0, err_msg=name)


def test_sharded_train_step_gradients_match_single_device():
    """The first step's parameter gradients equal those of the full-batch
    MSE through MWVCModel on the whole graph."""
    g = _port(bench.build_road_graph(30))
    ws = float(g.weights.max())
    labels = (np.random.default_rng(2).random(g.n) < 0.5).astype(np.float32)
    dg = DeviceGraph.from_graph(g, "cpu")
    ref = pretrained_model("cpu")
    out = ref((dg.weights / ws).reshape(-1, 1), dg, ws)[:, 0]
    ((out - torch.from_numpy(labels)) ** 2).mean().backward()
    model = pretrained_model("cpu")
    mesh = _cpu_mesh(4)
    sg = partition_device_graph(dg, 4, devices=mesh)
    y = np.zeros(4 * sg.n_loc, np.float32)
    y[:g.n] = labels
    step, _opt = make_sharded_train_step(model, mesh)
    step(sg, y.reshape(4, -1), ws)
    for (name, p), q in zip(model.named_parameters(), ref.parameters()):
        scale = float(q.grad.abs().max())
        assert scale > 0, name
        assert float((p.grad - q.grad).abs().max()) <= 1e-5 * scale, name


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "gnn_mwvc_tpu_torch.solver.cli", *map(str, args)],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO))


def test_cli_shards_writes_the_single_device_cover(tmp_path):
    g = _port(random_graph(1500, 14, seed=5, wmax=500))
    path = tmp_path / "g.metis"
    write_metis(str(path), g)
    sols = []
    for shards in (0, 4):
        sol = tmp_path / f"g{shards}.sol"
        out = _cli(path, sol, 0, -1, 0, "--device", "cpu", "--shards", shards)
        assert out.returncode == 0, out.stderr[-2000:]
        sols.append(read_solution(str(sol)))
    assert is_vertex_cover(g, sols[1])
    np.testing.assert_array_equal(sols[0], sols[1])


@pytest.mark.parametrize("extra", [["--quick"], ["--device", "cuda:1"]])
def test_cli_refuses_shards_it_would_not_honour(tmp_path, capsys, extra):
    """--shards with --quick (no GNN to shard) or with a card other than
    cuda:0 (the mesh starts at cuda:0) exits 2 before reading the graph."""
    from gnn_mwvc_tpu_torch.solver import cli

    with pytest.raises(SystemExit) as e:
        cli.main([str(tmp_path / "g.metis"), str(tmp_path / "g.sol"), "1",
                  "--shards", "2", *extra])
    assert e.value.code == 2
    assert "--shards" in capsys.readouterr().err


def test_dist_worker_defaults_to_a_card():
    """A rank started without --device takes cuda:<rank % cards>; with no
    card it fails, naming the missing card, instead of running on the
    host."""
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    init = f"tcp://127.0.0.1:{s.getsockname()[1]}"
    s.close()
    out = subprocess.run(
        [sys.executable, "-m", "gnn_mwvc_tpu_torch.parallel.dryrun", "dist",
         "0", "1", init, "--road", "10"], capture_output=True, text=True,
        timeout=120, cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO))
    if torch.cuda.device_count() == 0:
        assert out.returncode != 0
        assert "needs a CUDA card, found 0" in out.stderr
    else:
        assert out.returncode == 0, out.stderr[-2000:]
        assert '"device": "cuda:0"' in out.stdout


def test_make_mesh():
    mesh = _cpu_mesh(4)
    assert mesh.devices == (torch.device("cpu"),) * 4 and mesh.parts == 4
    assert mesh.shard_ids == (0, 1, 2, 3) and mesh.group is None
    assert make_mesh(devices=["cpu"] * 3).parts == 3
    with pytest.raises(ValueError):
        make_mesh(3, devices=["cpu"] * 4)
    with pytest.raises(RuntimeError, match=r"9 shards needs 9 CUDA cards, "
                                           rf"found {torch.cuda.device_count()}"):
        make_mesh(9)


def test_dryrun_multichip_on_four_cpu_shards():
    out = dryrun_multichip(4, devices=["cpu"] * 4)
    assert np.isfinite(out["loss"]) and out["solve_cost"] > 0
