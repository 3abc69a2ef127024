"""``solve(...).phase1["phase2_start_cost"]``: the full cover's cost when
phase 2 starts, held against the cover recomputed from the input graph, on
the CPU; and the command line's default output, which it must not touch."""

import contextlib
import io
import json
import os
import re

import numpy as np
import pytest

from gnn_mwvc_tpu_torch.core import CoreLocalSearch, CoreSolver
from gnn_mwvc_tpu_torch.graph import build_road_graph, geometric_graph
from gnn_mwvc_tpu_torch.graphio import (cover_cost, is_vertex_cover,
                                        read_solution, write_metis)
from gnn_mwvc_tpu_torch.solver import cli, pipeline
from gnn_mwvc_tpu_torch.solver.pipeline import GnnScorer, solve

GRAPHS = {"rgg12": lambda: geometric_graph(1 << 12, seed=3),
          "road40": lambda: build_road_graph(40, seed=5)}


@pytest.fixture(scope="module", autouse=True)
def warm():
    """The core built and the model loaded before any timed solve: a
    fresh checkout builds the core at its first use, inside the budget."""
    solve(build_road_graph(8), time_limit=0, device="cpu",
          scorer=GnnScorer(device="cpu"))


def _start_cover_probe(monkeypatch, g):
    """Record, as phase 2's search is built, the full cover of ``g`` that
    its start cover gives: the kernel's start values put into the core and
    every reduction unfolded in a preview."""
    seen = {}

    class Core(CoreSolver):
        def __init__(self, *args):
            super().__init__(*args)
            seen["core"] = self

        def snapshot(self):
            seen["snap"] = super().snapshot()
            return seen["snap"]

    class Search(CoreLocalSearch):
        def __init__(self, weights, edges, initial):
            super().__init__(weights, edges, initial)
            core = seen["core"]
            core.apply_cover(seen["snap"].ids, initial)
            full = (core.preview_solution() == 1).astype(np.int8)
            seen["covers"] = is_vertex_cover(g, full)
            seen["cost"] = cover_cost(g, full)

    monkeypatch.setattr(pipeline, "CoreSolver", Core)
    monkeypatch.setattr(pipeline, "CoreLocalSearch", Search)
    return seen


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_phase2_start_cost_is_the_start_covers_cost(monkeypatch, name):
    g = GRAPHS[name]()
    seen = _start_cover_probe(monkeypatch, g)
    res = solve(g, time_limit=2.0, device="cpu",
                scorer=GnnScorer(device="cpu"), device_assist=True,
                assist_batch=32, assist_rmax=16)
    assert res.kernel_size > 0 and res.ls_steps > 0, "phase 2 did not run"
    assert seen["covers"]
    assert res.phase1["phase2_start_cost"] == seen["cost"]
    assert res.cost <= seen["cost"]  # the search keeps its best
    # the assist's part of the fall to the written cover
    st = res.assist_stats
    assert 0 <= st["best_gain"] <= min(st["gain"], seen["cost"] - res.cost)
    assert is_vertex_cover(g, res.solution)
    assert cover_cost(g, res.solution) == res.cost


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_phase2_start_cost_absent_without_a_phase_2(name):
    res = solve(GRAPHS[name](), time_limit=0, device="cpu",
                scorer=GnnScorer(device="cpu"))
    assert res.kernel_size > 0
    assert "phase2_start_cost" not in res.phase1


def test_best_gain_is_the_best_covers_drop(monkeypatch):
    """Phase 2's fall to the written cover is the best cover's drops at the
    search's chunk ends and at the assist's commits; ``best_gain`` is the
    latter, none of them more than the patches' own drop, so never more
    than ``gain``, which also counts repairs of kicked covers."""
    drops = {"search": 0}

    class Search(CoreLocalSearch):
        def search(self, *args):
            before = self.best_cost
            improved = super().search(*args)
            drops["search"] += before - self.best_cost
            return improved

    monkeypatch.setattr(pipeline, "CoreLocalSearch", Search)
    res = solve(GRAPHS["road40"](), time_limit=2.0, device="cpu",
                scorer=GnnScorer(device="cpu"), device_assist=True,
                assist_batch=32, assist_rmax=16)
    st = res.assist_stats
    assert st["batches"] > 0
    fall = res.phase1["phase2_start_cost"] - res.cost
    assert st["best_gain"] + drops["search"] == fall
    assert 0 <= st["best_gain"] <= st["gain"]


def _cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    return rc, out.getvalue()


def test_gnn_vc_default_stdout_is_the_reference_csv(tmp_path):
    g = GRAPHS["rgg12"]()
    path = str(tmp_path / "rgg12.metis")
    write_metis(path, g)
    sol = str(tmp_path / "rgg12.sol")
    rc, text = _cli([path, sol, "2", "-1", "0", "--device", "cpu"])
    assert rc == 0
    cost = cover_cost(g, read_solution(sol))
    # [graph],[VC written],[best VC seen],[time to best], nothing else
    m = re.fullmatch(r"rgg12,(\d+),(\d+),([0-9.e+-]+)\n", text)
    assert m, text
    assert int(m.group(1)) == cost and int(m.group(2)) <= cost
    rc, text = _cli([path, sol + "2", "2", "-1", "0", "--json",
                     "--device", "cpu"])
    line = json.loads(text.splitlines()[-1])
    assert rc == 0 and os.path.exists(sol + "2")
    assert line["phase1"]["phase2_start_cost"] >= line["cost"]
