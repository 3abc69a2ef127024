"""The port's solve() end to end on the CPU, against the JAX package's."""

import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench
from gnn_mwvc_tpu.solver.pipeline import GnnScorer as JaxGnnScorer
from gnn_mwvc_tpu.solver.pipeline import solve as jax_solve
from gnn_mwvc_tpu_torch.graph import Graph
from gnn_mwvc_tpu_torch.graphio import (cover_cost, is_vertex_cover,
                                        read_metis, read_solution,
                                        write_metis)
from gnn_mwvc_tpu_torch.solver.pipeline import GnnScorer, solve
from tests.conftest import EX3, random_graph

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_graph(gj):
    return Graph(gj.weights, gj.edge_array())


def test_solve_ex3():
    res = solve(read_metis(io.BytesIO(EX3)), time_limit=1.0, device="cpu")
    assert res.cost == 20
    np.testing.assert_array_equal(res.solution, [0, 0, 1])


@pytest.mark.parametrize("assist", [False, True])
@pytest.mark.parametrize("n,deg,wmax,seed", [(800, 10, 50, 4),
                                             (1500, 14, 500, 5)])
def test_solve_random_valid(n, deg, wmax, seed, assist):
    g = _port_graph(random_graph(n, deg, seed=seed, wmax=wmax))
    # phase 1 (model load included) must leave the assist some phase 2,
    # also on a loaded host; width-16 regions keep each CPU batch cheap
    res = solve(g, time_limit=3.0 if assist else 1.0, device="cpu",
                device_assist=assist, assist_batch=32, assist_rmax=16)
    assert is_vertex_cover(g, res.solution)
    assert cover_cost(g, res.solution) == res.cost
    assert res.best_seen <= res.cost
    if assist and res.kernel_size:
        assert res.assist_stats["batches"] >= 1, (res.time_gnn,
                                                  res.assist_stats)


def test_solve_reordered_maps_back_to_input_ids():
    gj = bench.build_road_graph(50)
    g = _port_graph(gj)
    res = solve(g, time_limit=0.5, device="cpu", reorder=True)
    assert is_vertex_cover(g, res.solution)
    assert cover_cost(g, res.solution) == res.cost


@pytest.mark.parametrize("name", ["er1500", "road60", "road100"])
def test_phase1_cover_cost_equals_jax(name):
    """time_limit=0: the peeled cover alone, per-snapshot scoring on both
    sides.  Equal costs mean the same peel: scores agree well inside the
    confidence buckets (CONF_EPS = 1e-4) on every round."""
    gj = {"er1500": lambda: random_graph(1500, 14, seed=5, wmax=500),
          "road60": lambda: bench.build_road_graph(60),
          "road100": lambda: bench.build_road_graph(100)}[name]()
    ref = jax_solve(gj, time_limit=0, scorer=JaxGnnScorer(),
                    device_assist=False)
    g = _port_graph(gj)
    res = solve(g, time_limit=0, scorer=GnnScorer(device="cpu"), device="cpu")
    assert is_vertex_cover(g, res.solution)
    assert res.cost == ref.cost
    assert res.kernel_size == ref.kernel_size


def test_cuda_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        solve(read_metis(io.BytesIO(EX3)), time_limit=1.0, device="cuda")


def test_port_imports_no_jax():
    code = (
        "import io, os, sys\n"
        "import gnn_mwvc_tpu_torch.solver.cli, gnn_mwvc_tpu_torch.solver.pipeline\n"
        "import gnn_mwvc_tpu_torch.train, gnn_mwvc_tpu_torch.train.cli\n"
        "from gnn_mwvc_tpu_torch.graphio import read_metis\n"
        "from gnn_mwvc_tpu_torch.solver.pipeline import solve\n"
        f"g = read_metis(io.BytesIO({EX3!r}))\n"
        "assert solve(g, time_limit=0.5, device='cpu').cost == 20\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m.startswith('jaxlib') or m == 'gnn_mwvc_tpu'\n"
        "       or m.startswith('gnn_mwvc_tpu.')]\n"
        "# a file of the JAX package executed under any module name\n"
        f"pkg = {os.path.join(os.path.realpath(REPO), 'gnn_mwvc_tpu')!r} + os.sep\n"
        "bad += [m for m, mod in list(sys.modules.items())\n"
        "        if os.path.realpath(getattr(mod, '__file__', None) or '')\n"
        "        .startswith(pkg)]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stdout + out.stderr[-2000:]


def test_cli_contract(tmp_path):
    g = _port_graph(random_graph(400, 8, seed=7))
    gpath, spath = tmp_path / "g.metis", tmp_path / "g.sol"
    write_metis(str(gpath), g)
    out = subprocess.run(
        [sys.executable, "-m", "gnn_mwvc_tpu_torch.solver.cli", str(gpath),
         str(spath), "1", "-1", "0", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr[-2000:]
    fields = [ln for ln in out.stdout.splitlines()
              if ln.startswith("g,")][-1].split(",")
    sol = read_solution(spath)
    assert len(sol) == g.n and is_vertex_cover(g, sol)
    cost = int(fields[-2]) if len(fields) == 8 else int(fields[1])
    assert cover_cost(g, sol) == cost
