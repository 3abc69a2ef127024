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


def test_phase1_counts_the_meta_rules_instances():
    """phase1 carries the core's meta-rule counts beside dependent_folds:
    each small instance was either decided by a weight bound or solved."""
    res = solve(_port_graph(bench.build_road_graph(50)), time_limit=0,
                device="cpu")
    p1 = res.phase1
    assert "dependent_folds" in p1
    assert p1["meta_evals"] > 0
    assert p1["meta_bound_decided"] + p1["meta_solved"] == p1["meta_evals"]


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
        "import gnn_mwvc_tpu_torch.utils\n"
        "import gnn_mwvc_tpu_torch.ops.rules, gnn_mwvc_tpu_torch.ops.smallsolve\n"
        "import gnn_mwvc_tpu_torch.solver.device_reduce\n"
        "import gnn_mwvc_tpu_torch.solver.quick\n"
        "import gnn_mwvc_tpu_torch.solver.checkpoint\n"
        "import gnn_mwvc_tpu_torch.solver.approximation\n"
        "import gnn_mwvc_tpu_torch.solver.ablation\n"
        "from gnn_mwvc_tpu_torch.solver.batch import main as _batch\n"
        "from gnn_mwvc_tpu_torch.solver.benchmark import main as _bench\n"
        "from gnn_mwvc_tpu_torch.graphio.cli import main as _tools\n"
        "from gnn_mwvc_tpu_torch.solver.baselines.cli import main as _base\n"
        "from gnn_mwvc_tpu_torch.solver.cli import main as _cli\n"
        "from gnn_mwvc_tpu_torch.graphio import read_metis\n"
        "from gnn_mwvc_tpu_torch.solver.pipeline import solve\n"
        f"g = read_metis(io.BytesIO({EX3!r}))\n"
        "assert solve(g, time_limit=0.5, device='cpu').cost == 20\n"
        "from gnn_mwvc_tpu_torch.core import CoreSolver\n"
        "from gnn_mwvc_tpu_torch.solver.quick import QuickScorer\n"
        "gnn_mwvc_tpu_torch.solver.device_reduce.device_reduce_prepass(\n"
        "    CoreSolver(g.weights, g.edge_array()), min_nodes=0, device='cpu')\n"
        "assert solve(g, time_limit=0, scorer=QuickScorer(),\n"
        "             device='cpu').cost == 20\n"
        "gnn_mwvc_tpu_torch.solver.ablation.run_ablation(g, device='cpu')\n"
        "import gnn_mwvc_tpu_torch.parallel, gnn_mwvc_tpu_torch.parallel.dryrun\n"
        "from gnn_mwvc_tpu_torch.parallel import make_mesh\n"
        "from gnn_mwvc_tpu_torch.solver.sharded_score import ShardedGnnScorer\n"
        "mesh = make_mesh(2, devices=['cpu', 'cpu'])\n"
        "assert solve(g, time_limit=0, scorer=ShardedGnnScorer(mesh=mesh),\n"
        "             device='cpu').cost == 20\n"
        "# every port tool, run at a tiny size\n"
        "import tempfile\n"
        "from gnn_mwvc_tpu_torch.tools import (assist_ab, canonical,\n"
        "    dump_kernel, er_slice_bench, reduce_scale, scale_bench,\n"
        "    scaling_weak, sharded_solve)\n"
        "tmp = tempfile.mkdtemp()\n"
        "out = lambda name: ['--out', os.path.join(tmp, name), '--device', 'cpu']\n"
        "assert dump_kernel.main(['road20', *out('k.npz')]) == 0\n"
        "assert assist_ab.main([os.path.join(tmp, 'k.npz'), '--time', '0.2',\n"
        "                       '--batch', '8', *out('ab.json')]) == 0\n"
        "assert canonical.main(['road20', '--time', '0.2', *out('c.json')]) == 0\n"
        "assert sharded_solve.main(['road20', '--parts', '2', *out('s.json')]) == 0\n"
        "assert er_slice_bench.main(['--n', '400', '--parts', '1,2', '--iters',\n"
        "                            '1', '--batches', '1', *out('e.json')]) == 0\n"
        "assert scale_bench.main(['--n', '400', '--parts', '1,2', '--iters', '1',\n"
        "                         '--device', 'cpu']) == 0\n"
        "assert scaling_weak.main(['--side', '20', '--er-n', '400', '--parts',\n"
        "                          '1,2', *out('w.json')]) == 0\n"
        "assert reduce_scale.main(['--side', '20', *out('r.json')]) == 0\n"
        "from gnn_mwvc_tpu_torch.tools import (precision_study,\n"
        "    smallsolve_bench, train_quality)\n"
        "from gnn_mwvc_tpu_torch.graph import build_road_graph\n"
        "assert precision_study.main(['--side', '20', '--iters', '1',\n"
        "                             '--batches', '1', *out('p.json')]) == 0\n"
        "assert smallsolve_bench.main(['--batch', '2', '--bursts', '1',\n"
        "                              '--per', '1', *out('b.json')]) == 0\n"
        "train_quality.corpus = lambda rng=None: [\n"
        "    ('grid0', build_road_graph(40, seed=300))] * 2\n"
        "train_quality.heldout = lambda: [('g30', build_road_graph(30))]\n"
        "assert train_quality.main(['--epochs', '0', '--label-budget', '0.1',\n"
        "    '--eval-budget', '0.1', '--workdir', os.path.join(tmp, 'tq'),\n"
        "    *out('q.json')]) == 0\n"
        "# the bench line, entry() and the kernel-dump / local-search tools\n"
        "os.environ.update(BENCH_SIDE='20', BENCH_ITERS='1', BENCH_BATCHES='1')\n"
        "from gnn_mwvc_tpu_torch import bench as port_bench, entry\n"
        "from gnn_mwvc_tpu_torch.tools import kernel_dump, ls_run\n"
        "assert port_bench.main(['--device', 'cpu']) == 0\n"
        "assert entry.main(['--device', 'cpu']) == 0\n"
        "stem = os.path.join(tmp, 'k20')\n"
        "assert kernel_dump.main(['--instance', 'road20', '--out', stem,\n"
        "                         '--device', 'cpu']) == 0\n"
        "assert ls_run.main([stem + '.kern', '--steps', '5000']) == 0\n"
        "from gnn_mwvc_tpu_torch.tools import watch\n"
        "assert watch.main(['--every', '1', *out('wt.json')[:2], '--',\n"
        "                   sys.executable, '-c', 'pass']) == 0\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m.startswith('jaxlib') or m == 'gnn_mwvc_tpu'\n"
        "       or m.startswith('gnn_mwvc_tpu.') or m == 'bench'\n"
        "       or m in ('tests', 'tools') or m.startswith(('tests.', 'tools.'))]\n"
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
