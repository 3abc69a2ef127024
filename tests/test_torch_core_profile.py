"""The native core's per-rule profile (``CoreSolver.profile``) and the child
spans that ``gnn_peel`` makes of it: ``reduce.<rule>``,
``reduce.critical``, ``peel.<rule>``, ``peel.select``, ``peel.critical``,
``components.scan`` and ``components.exact``, with the rules' fires and the
critical-weight flows' live vertices in ``phase1["core_counts"]``.  Counts
are held exactly; seconds only within their parent's, never as ratios of
each other, which the parallel test run's load moves."""

import contextlib
import io
import json

import numpy as np
import pytest

from gnn_mwvc_tpu_torch.core import PROFILE_RULES, CoreSolver
from gnn_mwvc_tpu_torch.graph import build_road_graph
from gnn_mwvc_tpu_torch.graphio import read_metis, write_metis
from gnn_mwvc_tpu_torch.solver import cli
from gnn_mwvc_tpu_torch.solver.pipeline import solve

PARENTS = ("reduce", "peel", "components")


def core_children(spans):
    return {k: v for k, v in spans.items()
            if "." in k and k.split(".")[0] in PARENTS}


def road_solve(side=60):
    return solve(build_road_graph(side), time_limit=0, device="cpu")


def reduced(weights, edges):
    core = CoreSolver(np.array(weights, np.uint32),
                      np.array(edges, np.int64).reshape(-1, 2))
    core.reduce()
    return core


def rule_counts(prof, what):
    return {r: prof[f"{r}.{what}"] for r in PROFILE_RULES}


def only(rule_counts_):
    """Every rule's count 0 but those given."""
    return {r: rule_counts_.get(r, 0) for r in PROFILE_RULES}


# Each cascade by hand.  The worklists start as 0..n-1 and pop from the
# back; a rule's pop of a vertex that is gone is no evaluation; a fire
# restarts at the first rule, whose list then holds the re-queued vertices.
HAND = {
    # 0-1-2, weights 1, 5, 1: the neighbourhood rule passes 2 (N weighs 5)
    # and fires on 1 (N weighs 2 <= 5), taking 0 and 2; nothing is left
    "path": ([1, 5, 1], [(0, 1), (1, 2)], 2,
             only({"neighborhood": 2}), only({"neighborhood": 1})),
    # centre 0 of weight 100, leaves 1-3 of weight 1: the rule passes the
    # three leaves, then fires on the centre and takes them
    "star": ([100, 1, 1, 1], [(0, 1), (0, 2), (0, 3)], 3,
             only({"neighborhood": 4}), only({"neighborhood": 1})),
    # K(2,2) of weight 10 each: the neighbourhood rule passes all four (N
    # weighs 20); the twin rule, on 3 first, folds its twin 2 into it
    # (weight 20) and re-queues 3, 1 and 0; the neighbourhood rule passes
    # 1 and 0 again and fires on 3 (N weighs 20 <= 20), taking 0 and 1
    "twins": ([10, 10, 10, 10], [(0, 2), (0, 3), (1, 2), (1, 3)], 20,
              only({"neighborhood": 7, "twin": 1}),
              only({"neighborhood": 1, "twin": 1})),
}


@pytest.mark.parametrize("name", sorted(HAND))
def test_fires_and_evaluations_are_the_hand_counts(name):
    weights, edges, cost, evals, fires = HAND[name]
    core = reduced(weights, edges)
    assert core.active_count == 0 and core.cost == cost
    prof = core.profile
    assert rule_counts(prof, "evals") == evals
    assert rule_counts(prof, "fires") == fires
    # below 1,000 live vertices the flow runs once the cascade ends, here
    # on an empty graph, and decides nothing
    assert (prof["critical.calls"], prof["critical.live"]) == (1, 0)
    for key in ("select.calls", "components.calls", "exact.calls"):
        assert prof[key] == 0, key


def test_the_profile_counts_each_piece_of_a_solve():
    g = build_road_graph(60)
    core = CoreSolver(g.weights, g.edge_array())
    core.reduce()
    first = core.profile
    assert first["critical.calls"] == 0  # more than 1,000 live vertices
    assert sum(rule_counts(first, "evals").values()) > 0
    core.solve_small_components(75)
    prof = core.profile
    assert prof["components.calls"] == 1
    assert prof["exact.ns"] <= prof["components.ns"]
    for key, value in first.items():  # the components leave the rules be
        if not key.startswith(("components.", "exact.")):
            assert prof[key] == value, key


def test_two_solves_of_one_seed_count_alike():
    a, b = road_solve(), road_solve()
    assert a.cost == b.cost
    calls = [{k: v["calls"] for k, v in core_children(r.phase1["spans"])
              .items()} for r in (a, b)]
    assert calls[0] == calls[1]
    assert a.phase1["core_counts"] == b.phase1["core_counts"]
    for parent in ("reduce", "peel"):
        assert sum(calls[0].get(f"{parent}.{r}", 0)
                   for r in PROFILE_RULES) > 0, parent
    assert calls[0]["peel.select"] > 0
    assert calls[0]["peel.critical"] > 0  # the last rounds run the flow
    assert a.phase1["core_counts"]["peel.critical.live"] > 0


def test_children_lie_within_their_parents():
    res = road_solve()
    spans = res.phase1["spans"]
    children = core_children(spans)
    assert {"components.scan", "components.exact", "peel.select",
            "peel.critical"} <= set(children)
    for parent in PARENTS:
        mine = {k: v for k, v in children.items()
                if k.split(".")[0] == parent}
        assert mine, parent
        inside = sum(v["seconds"] for v in mine.values())
        assert 0 < inside <= spans[parent]["seconds"], parent
        for k, v in mine.items():
            assert 0 <= v["seconds"] <= spans[parent]["seconds"], k
    assert spans["components.scan"]["calls"] == spans["components"]["calls"]
    # a fire is an evaluation that found something
    counts = res.phase1["core_counts"]
    for parent in ("reduce", "peel"):
        for r in PROFILE_RULES:
            evals = children.get(f"{parent}.{r}", {"calls": 0})["calls"]
            assert counts[f"{parent}.{r}.fires"] <= evals, (parent, r)


def _cli_stdout(*argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main([str(a) for a in argv])
    assert rc == 0
    return out.getvalue()


def test_command_line_json_carries_the_children_and_csv_is_unchanged(
        tmp_path):
    path = tmp_path / "road40.metis"
    write_metis(str(path), build_road_graph(40))
    line = json.loads(_cli_stdout(path, tmp_path / "a.sol", 0, -1, 0,
                                  "--json", "--device", "cpu")
                      .strip().splitlines()[-1])
    spans = line["phase1"]["spans"]
    for parent in PARENTS:
        assert any(k.startswith(parent + ".") for k in spans), parent
    assert set(line["phase1"]["core_counts"]) >= {
        f"{p}.{r}.fires" for p in ("reduce", "peel") for r in PROFILE_RULES}

    # without --json: one line of the reference's CSV, the reduced path's
    # eight fields (no local search ran), nothing of the profile
    out = _cli_stdout(path, tmp_path / "b.sol", 0, -1, 0, "--device", "cpu")
    assert out.endswith("\n") and out.count("\n") == 1
    fields = out.rstrip("\n").split(",")
    g = read_metis(str(path))
    assert len(fields) == 8
    assert fields[:5] == ["road40", str(g.n), str(g.m),
                          str(line["kernel_size"]), str(line["cost"])]
    assert fields[6] == str(line["cost"])
    assert float(fields[5]) >= 0 and float(fields[7]) >= 0  # the times
