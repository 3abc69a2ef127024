"""The command line's relabel gate: ``pipeline.ids_lack_locality`` on
graphs whose ids follow the geometry (a grid-order road graph) or the
generator (a random geometric graph in generation order), and
``gnn-vc-torch`` on METIS files the gate takes and refuses, held against
the JAX package's ``solve(reorder=True)`` (``--quick``) and the port's
``solve`` with and without the clustered relabel (``GnnScorer``, and
``--shards`` over a host mesh), on the CPU."""

import contextlib
import io
import json

import numpy as np
import pytest

from gnn_mwvc_tpu_torch.graph import (Graph, build_road_graph,
                                      geometric_graph)
from gnn_mwvc_tpu_torch.graphio import (cover_cost, is_vertex_cover,
                                        read_metis, read_solution,
                                        write_metis, write_solution)
from gnn_mwvc_tpu_torch.solver import cli
from gnn_mwvc_tpu_torch.solver.pipeline import (LOCALITY_MIN_N,
                                                LOCALITY_SAMPLE, GnnScorer,
                                                ids_lack_locality, solve)

GRAPHS = {"rgg16": lambda: geometric_graph(1 << 16, seed=7),
          "rgg12": lambda: geometric_graph(1 << 12, seed=7),
          "road256": lambda: build_road_graph(256, seed=5)}


@pytest.fixture(scope="module")
def graphs():
    return {}


def _graph(graphs, name):
    if name not in graphs:
        graphs[name] = GRAPHS[name]()
    return graphs[name]


# -- the gate -----------------------------------------------------------------

@pytest.mark.parametrize("name,applied,lo,hi", [
    # generation order: a neighbour anywhere in the id range
    ("rgg16", True, 0.2, 0.4),
    # the same order, but under 2^16 vertices: refused for its size
    ("rgg12", False, 0.2, 0.4),
    # grid order at 2^16 vertices: most neighbours a row (side ids) away
    ("road256", False, 1 / 512, 1 / 128)])
def test_gate_takes_generation_order_and_refuses_grid_order(
        graphs, name, applied, lo, hi):
    g = _graph(graphs, name)
    got, share = ids_lack_locality(g)
    assert got is applied
    assert lo < share < hi
    assert (g.n >= LOCALITY_MIN_N) == (name != "rgg12")


def test_gate_reads_every_entry_of_a_small_csr_and_a_stride_of_a_large_one(
        graphs):
    g = _graph(graphs, "rgg12")
    assert len(g.indices) <= LOCALITY_SAMPLE  # the sample is the whole CSR
    exact = np.median(np.abs(g.row_ids() - g.indices)) / g.n
    assert ids_lack_locality(g)[1] == exact
    big = _graph(graphs, "rgg16")
    stride = len(big.indices) // LOCALITY_SAMPLE
    pos = np.arange(0, len(big.indices), stride)[:LOCALITY_SAMPLE]
    gaps = np.abs(big.row_ids()[pos] - big.indices[pos])
    assert ids_lack_locality(big)[1] == np.median(gaps) / big.n


def test_gate_on_a_graph_without_edges():
    g = Graph.from_csr(np.ones(LOCALITY_MIN_N, np.int64),
                       np.zeros(LOCALITY_MIN_N + 1, np.int64),
                       np.zeros(0, np.int64))
    assert ids_lack_locality(g) == (False, 0.0)


# -- the command line ---------------------------------------------------------

def _cli(*argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main([str(a) for a in argv])
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def _solve(g, reorder):
    return solve(g, time_limit=0, reorder=reorder, device="cpu",
                 scorer=GnnScorer(device="cpu"))


def test_cli_relabels_a_generation_order_file_and_writes_its_ids(graphs,
                                                                 tmp_path):
    path, sol = tmp_path / "rgg16.metis", tmp_path / "rgg16.sol"
    write_metis(str(path), _graph(graphs, "rgg16"))
    line = _cli(path, sol, 0, -1, 0, "--json", "--device", "cpu")
    assert line["relabel"]["applied"] is True
    assert 0.2 < line["relabel"]["gap_share"] < 0.4
    relabel = line["phase1"]["spans"]["relabel"]
    assert relabel["calls"] == 1 and relabel["seconds"] > 0
    g = read_metis(str(path))
    cover = read_solution(str(sol))
    assert is_vertex_cover(g, cover) and cover_cost(g, cover) == line["cost"]
    ref = _solve(g, reorder=True)
    assert line["cost"] == ref.cost
    np.testing.assert_array_equal(cover, ref.solution)


@pytest.mark.parametrize("name", ["rgg12", "road256"])
def test_cli_on_a_refused_file_writes_the_unrelabelled_cover(graphs, name,
                                                             tmp_path):
    path, sol = tmp_path / f"{name}.metis", tmp_path / f"{name}.sol"
    write_metis(str(path), _graph(graphs, name))
    line = _cli(path, sol, 0, -1, 0, "--json", "--device", "cpu")
    assert line["relabel"]["applied"] is False
    assert "relabel" not in line["phase1"]["spans"]
    ref = tmp_path / "ref.sol"
    write_solution(str(ref), _solve(read_metis(str(path)), False).solution)
    assert sol.read_bytes() == ref.read_bytes()


def test_cli_quick_relabelled_cover_equals_jax(graphs, tmp_path):
    """``--quick`` on a file the gate takes: the written cover and its cost
    are the JAX package's ``solve(reorder=True)`` on the same file."""
    from gnn_mwvc_tpu.graphio.metis import read_metis as jax_read_metis
    from gnn_mwvc_tpu.solver.pipeline import solve as jax_solve
    from gnn_mwvc_tpu.solver.quick import QuickScorer as JaxQuickScorer

    path, sol = tmp_path / "rgg16.metis", tmp_path / "rgg16.sol"
    write_metis(str(path), _graph(graphs, "rgg16"))
    line = _cli(path, sol, 0, -1, 0, "--quick", "--json", "--device", "cpu")
    assert line["relabel"]["applied"] is True
    assert line["phase1"]["spans"]["relabel"]["calls"] == 1
    g = read_metis(str(path))
    cover = read_solution(str(sol))
    assert is_vertex_cover(g, cover) and cover_cost(g, cover) == line["cost"]
    ref = jax_solve(jax_read_metis(str(path)), time_limit=0, reorder=True,
                    scorer=JaxQuickScorer(), device_assist=False)
    assert line["cost"] == ref.cost
    np.testing.assert_array_equal(cover, ref.solution)


def test_cli_shards_relabelled_cover_equals_sharded_solve(graphs, tmp_path):
    """``--shards 4`` over a host mesh on a file the gate takes writes
    ``solve(reorder=True)``'s cover under the same sharded scorer."""
    from gnn_mwvc_tpu_torch.parallel.mesh import make_mesh
    from gnn_mwvc_tpu_torch.solver.sharded_score import ShardedGnnScorer

    path, sol = tmp_path / "rgg16.metis", tmp_path / "rgg16.sol"
    write_metis(str(path), _graph(graphs, "rgg16"))
    line = _cli(path, sol, 0, -1, 0, "--json", "--device", "cpu",
                "--shards", 4)
    assert line["relabel"]["applied"] is True
    assert line["phase1"]["spans"]["relabel"]["calls"] == 1
    g = read_metis(str(path))
    cover = read_solution(str(sol))
    assert is_vertex_cover(g, cover) and cover_cost(g, cover) == line["cost"]
    mesh = make_mesh(4, devices=["cpu"] * 4)
    ref = solve(g, time_limit=0, reorder=True, device="cpu",
                scorer=ShardedGnnScorer(mesh=mesh))
    assert line["cost"] == ref.cost
    np.testing.assert_array_equal(cover, ref.solution)
