"""The port's training path against the JAX package's, on the CPU: the
trainer's trajectory, the initialiser, the model writer, the edge-list
format, the 3-rule kernelisation, the labelled-set loader and the
``gnn-train-torch`` chain from data to a solve."""

import io

import numpy as np
import pytest
import torch

from gnn_mwvc_tpu.graphio import read_edge_graph as jax_read_edge_graph
from gnn_mwvc_tpu.graphio import write_edge_graph as jax_write_edge_graph
from gnn_mwvc_tpu.models import Model as JaxModel
from gnn_mwvc_tpu.models import dumps_model as jax_dumps_model
from gnn_mwvc_tpu.models import init_params as jax_init_params
from gnn_mwvc_tpu.models import load_model as jax_load_model
from gnn_mwvc_tpu.models import loads_model as jax_loads_model
from gnn_mwvc_tpu.models.gnn import build_reference_arch as jax_arch
from gnn_mwvc_tpu.train import TrainConfig as JaxTrainConfig
from gnn_mwvc_tpu.train import gen_reduced_graph as jax_gen_reduced_graph
from gnn_mwvc_tpu.train import load_training_set as jax_load_training_set
from gnn_mwvc_tpu.train import make_sample as jax_make_sample
from gnn_mwvc_tpu.train import train as jax_train
from gnn_mwvc_tpu_torch.graph import Graph
from gnn_mwvc_tpu_torch.graphio import (cover_cost, is_vertex_cover,
                                        read_edge_graph, write_edge_graph)
from gnn_mwvc_tpu_torch.models import (MWVCModel, ModelSpec,
                                       build_reference_arch, dumps_model,
                                       init_params, load_model, loads_model,
                                       params_to_jax)
from gnn_mwvc_tpu_torch.solver.pipeline import solve
from gnn_mwvc_tpu_torch.train import (TrainConfig, gen_reduced_graph,
                                      load_training_set, make_sample, train)
from gnn_mwvc_tpu_torch.train.cli import main as train_main
from tests.conftest import random_graph


def _port(gj):
    return Graph(gj.weights, gj.edge_array())


def _jax_params(seed):
    kinds, dims = jax_arch()
    return kinds, [None if p is None else {k: np.asarray(v) for k, v in p.items()}
                   for p in jax_init_params(kinds, dims, seed=seed)]


def test_train_trajectory_matches_jax():
    """3 epochs (4 passes) from the same parameters.  Graphs of 100
    vertices with batch_vertices=150: the third graph of a pass fires a
    step with t = 200 (its own 100 not counted), the rest end in the final
    step, so the counter quirk is on the path.  Tolerances: losses 1e-4
    relative, parameters 1e-4 absolute (fp32 sums in other orders, through
    8 SGD steps)."""
    graphs = [random_graph(100, 6, seed=60 + i, wmax=200) for i in range(6)]
    rng = np.random.default_rng(0)
    labels = [(rng.random(g.n) < 0.5).astype(np.float32) for g in graphs]
    kinds, params = _jax_params(seed=2)
    cfg = dict(epochs=3, batch_vertices=150, seed=5, log=False,
               weight_decay=1e-3)

    jm, jhist = jax_train([jax_make_sample(g, y) for g, y in zip(graphs, labels)],
                          JaxTrainConfig(**cfg),
                          model=JaxModel(kinds=kinds, params=params))
    tm, thist = train([make_sample(_port(g), y, device="cpu")
                       for g, y in zip(graphs, labels)],
                      TrainConfig(**cfg),
                      model=MWVCModel.from_spec(ModelSpec(kinds, params)),
                      device="cpu")
    assert len(thist) == len(jhist) == 4
    assert [h["steps"] for h in thist] == [2] * 4
    for th, jh in zip(thist, jhist):
        for split in ("train", "test"):
            assert th[split]["total"] == jh[split]["total"]
            np.testing.assert_allclose(th[split]["loss"], jh[split]["loss"],
                                       rtol=1e-4)
    assert thist[-1]["train"]["loss"] != thist[0]["train"]["loss"]
    for got, want in zip(params_to_jax(tm), jm.params):
        if want is not None:
            for k in ("w", "b"):
                np.testing.assert_allclose(got[k], np.asarray(want[k]),
                                           rtol=0, atol=1e-4)


def test_init_params_shapes_bounds_and_seed():
    kinds, dims = build_reference_arch()
    assert (kinds, dims) == jax_arch()
    m = init_params(MWVCModel(kinds, dims), seed=3)
    assert len(m.kinds) == 21 and m.num_params() == 6209
    for lin, (din, dout) in zip(m.linears, dims):
        assert lin.weight.shape == (dout, din) and lin.bias.shape == (dout,)
        lim = 1.0 / np.sqrt(din + 1)
        w, b = lin.weight.detach(), lin.bias.detach()
        assert float(w.abs().max()) <= lim and float(b.abs().max()) <= lim
        assert float(w.std()) > lim / 4  # spread over the interval
    same = init_params(MWVCModel(kinds, dims), seed=3)
    other = init_params(MWVCModel(kinds, dims), seed=4)
    for a, b, c in zip(m.parameters(), same.parameters(), other.parameters()):
        assert torch.equal(a, b) and not torch.equal(a, c)


def test_dumps_model_is_byte_equal_to_jax_and_loads_in_both():
    kinds, dims = build_reference_arch()
    m = init_params(MWVCModel(kinds, dims, name="trained"), seed=1)
    text = dumps_model(m)
    assert text == jax_dumps_model(JaxModel(kinds=kinds,
                                            params=params_to_jax(m),
                                            name="trained"))
    spec = loads_model(text)
    jm = jax_loads_model(text)
    assert spec.kinds == jm.kinds == kinds and spec.name == jm.name
    for p, q, r in zip(spec.params, jm.params, params_to_jax(m)):
        if p is not None:
            for k in ("w", "b"):
                np.testing.assert_array_equal(p[k], np.asarray(q[k]))
                # %g keeps 6 significant digits
                np.testing.assert_allclose(p[k], r[k], rtol=1e-5, atol=1e-7)
    # 6 significant digits survive float32 and back
    assert dumps_model(MWVCModel.from_spec(spec)) == text


def test_edge_graph_io_matches_jax(tmp_path):
    # reversed pairs, a duplicate and a self-loop, 1-indexed
    raw = b"6 4\n5 7 1 9\n2 1\n1 2\n3 3\n4 1\n2 3\n3 4\n"
    gj, g = jax_read_edge_graph(io.BytesIO(raw)), read_edge_graph(io.BytesIO(raw))
    np.testing.assert_array_equal(g.weights, gj.weights)
    np.testing.assert_array_equal(g.edge_array(), gj.edge_array())
    big = random_graph(300, 7, seed=8)
    a, b = io.StringIO(), io.StringIO()
    write_edge_graph(a, _port(big))
    jax_write_edge_graph(b, big)
    assert a.getvalue() == b.getvalue()
    path = tmp_path / "g.mtx"
    write_edge_graph(str(path), _port(big))
    back = read_edge_graph(str(path))
    np.testing.assert_array_equal(back.weights, big.weights)
    np.testing.assert_array_equal(back.indptr, big.indptr)
    np.testing.assert_array_equal(back.indices, big.indices)


@pytest.mark.parametrize("seed", [11, 12])
def test_gen_reduced_graph_matches_jax(seed):
    gj = random_graph(600, 10, seed=seed, wmax=100)
    kj, cj, ij = jax_gen_reduced_graph(gj)
    k, c, ids = gen_reduced_graph(_port(gj))
    assert 0 < k.n < gj.n and c == cj
    np.testing.assert_array_equal(ids, ij)
    np.testing.assert_array_equal(k.weights, kj.weights)
    np.testing.assert_array_equal(k.edge_array(), kj.edge_array())


def test_load_training_set_filters_like_jax(tmp_path):
    gd, ld = tmp_path / "graphs", tmp_path / "labels"
    gd.mkdir()
    ld.mkdir()
    for i, frac in enumerate([0.5, 0.05, 0.95, 0.4]):
        g = random_graph(50, 4, seed=i)
        jax_write_edge_graph(str(gd / f"g{i}.mtx"), g)
        y = (np.random.default_rng(i).random(g.n) < frac).astype(int)
        np.savetxt(str(ld / f"g{i}.txt"), y, fmt="%d")
    np.savetxt(str(ld / "orphan.txt"), np.ones(5), fmt="%d")
    got = load_training_set(str(gd), str(ld), device="cpu")
    want = jax_load_training_set(str(gd), str(ld))
    assert [s.name for s in got] == [s.name for s in want] == ["g0", "g3"]
    for s, sj in zip(got, want):
        assert s.n == sj.n and bool(s.mask.all()) and s.mask.shape == (s.n,)
        np.testing.assert_array_equal(s.y.numpy(), sj.y[:sj.n])


def test_train_on_cuda_without_a_gpu_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    s = make_sample(_port(random_graph(30, 4, seed=1)), np.ones(30),
                    device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train([s], TrainConfig(epochs=0, log=False), device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_main([str(tmp_path), str(tmp_path), str(tmp_path / "m.txt"),
                    "1"])


def test_train_rejects_samples_on_another_device():
    s = make_sample(_port(random_graph(30, 4, seed=1)), np.ones(30),
                    device="cpu")
    with pytest.raises(ValueError, match="labels for"):
        make_sample(_port(random_graph(30, 4, seed=1)), np.ones(29),
                    device="cpu")
    with pytest.raises(ValueError, match="training on meta"):
        train([s], TrainConfig(epochs=0, log=False), device="meta")


def test_data_prep_to_gnn_train_torch_to_solve_chain(tmp_path, capsys):
    """Weighted graphs -> 3-rule kernels -> labels from the port's
    phase-1 cover -> gnn-train-torch --device cpu -> a model both packages
    load -> a valid solve() with it."""
    gdir, ldir = tmp_path / "graphs", tmp_path / "labels"
    gdir.mkdir()
    ldir.mkdir()
    for i in range(4):
        kernel, _cost, _ids = gen_reduced_graph(
            _port(random_graph(800, 10, seed=100 + i, wmax=100)))
        assert kernel.n >= 200
        y = solve(kernel, time_limit=0, device="cpu").solution.astype(int)
        write_edge_graph(str(gdir / f"k{i}.mtx"), kernel)
        np.savetxt(str(ldir / f"k{i}.txt"), y, fmt="%d")

    out = tmp_path / "model.txt"
    assert train_main([str(gdir), str(ldir), str(out), "2", "0",
                       "--batch-vertices", "300", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "Training graphs: 3, Test graphs: 1"
    assert [ln.split(",")[0] for ln in lines[2:]] == ["0", "1", "2"]
    assert jax_load_model(str(out)).num_params() == 6209
    model = MWVCModel.from_spec(load_model(str(out)))
    assert model.num_params() == 6209

    g = _port(random_graph(1500, 8, seed=999, wmax=100))
    res = solve(g, model=model, time_limit=0.5, device="cpu")
    assert is_vertex_cover(g, res.solution)
    assert cover_cost(g, res.solution) == res.cost
