"""meta_bound_share on synthetic counters: the bound's share of the core's
meta-rule instances, summed over the window's solves, and None where
phase 1 keeps no such counters, as a program before the bounds does."""

import pytest

from perfbench.run import load_module


def solve_ctx(n_solves=2):
    solves = [{"seconds": 30.0, "cost": 1_000_100, "yardstick": 1_000_000,
               "phase1": {"t_reduce0_s": 5.0, "t_score_s": 8.0,
                          "t_peel_s": 12.0}}
              for _ in range(n_solves)]
    return {"setup_s": 12.5, "window_s": 60.0, "trace": None,
            "counters": {"solves": solves}}


def read(ctx):
    return load_module("metrics", "meta_bound_share").read(ctx)


@pytest.mark.parametrize("side", ["change", "parent"])
def test_meta_bound_share_reads_the_core_counters(side):
    c = solve_ctx()
    if side == "parent":
        assert read(c) is None
        return
    for s, (evals, decided) in zip(c["counters"]["solves"],
                                   [(1000, 900), (3000, 2900)]):
        s["phase1"].update(meta_evals=evals, meta_bound_decided=decided,
                           meta_solved=evals - decided)
    assert read(c) == pytest.approx(3800 / 4000)


def test_meta_bound_share_without_evaluations_or_solves():
    c = solve_ctx(1)
    c["counters"]["solves"][0]["phase1"].update(
        meta_evals=0, meta_bound_decided=0, meta_solved=0)
    assert read(c) is None
    assert read(solve_ctx(0)) is None
