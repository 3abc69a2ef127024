"""The port's study tools ``precision_study``, ``train_quality`` and
``smallsolve_bench`` against the JAX package's, on the CPU, at small sizes:
the same instances bit for bit, the same report keys, and results equal to
the plain versions they are held against."""

import json

import numpy as np
import pytest
import torch

import tools.smallsolve_bench as jax_smallsolve_bench
import tools.train_quality as jax_train_quality
from gnn_mwvc_tpu.ops.smallsolve import batched_small_mwvc as jax_enumeration
from gnn_mwvc_tpu_torch.graph import (build_road_graph, powerlaw_graph,
                                      random_graph)
from gnn_mwvc_tpu_torch.ops.smallsolve_mitm import small_mwvc_mitm
from gnn_mwvc_tpu_torch.tools import (precision_study, smallsolve_bench,
                                      train_quality)
from tools.soak import powerlaw_graph as jax_powerlaw_graph

CPU = ["--device", "cpu"]


def _same_graph(a, b, name=""):
    assert a.n == b.n and a.m == b.m, name
    for k in ("weights", "indptr", "indices"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k),
                                      err_msg=f"{name} {k}")


@pytest.mark.parametrize("n,m,seed", [(3000, 3, 200), (15_000, 4, 903),
                                      (500, 5, 7)])
def test_powerlaw_graph_equals_jax(n, m, seed):
    _same_graph(powerlaw_graph(n, m, seed), jax_powerlaw_graph(n, m, seed))


def test_train_quality_instances_equal_jax():
    """The corpus and the held-out set: the JAX tool's names and graphs."""
    ours = train_quality.corpus(np.random.default_rng(0)) + \
        train_quality.heldout()
    ref = jax_train_quality.corpus(np.random.default_rng(0)) + \
        jax_train_quality.heldout()
    assert [n for n, _ in ours] == [n for n, _ in ref]
    assert len(ours) == 35
    for (name, a), (_name, b) in zip(ours, ref):
        _same_graph(a, b, name)


def test_train_quality_runs_a_small_corpus(tmp_path, monkeypatch, capsys):
    """The chain end to end on a cut-down corpus: the JAX report's keys,
    one row per held-out graph, valid covers' costs."""
    monkeypatch.setattr(train_quality, "corpus", lambda rng=None: [
        ("pl0", powerlaw_graph(3000, 3, seed=200)),
        ("grid0", build_road_graph(40, seed=300)),
        ("er0", random_graph(2000, 8, seed=100))])
    monkeypatch.setattr(train_quality, "heldout", lambda: [
        ("grid60", build_road_graph(60, seed=904))])
    out = str(tmp_path / "tq.json")
    assert train_quality.main(["--epochs", "1", "--label-budget", "0.2",
                               "--eval-budget", "0.2", "--workdir",
                               str(tmp_path / "work"), "--out", out,
                               *CPU]) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with open(out) as f:
        rep = json.load(f)
    assert {"epochs", "samples", "rows", "worst_final_delta_pct"} <= set(rep)
    assert rep["samples"] >= 2 and rep["epochs"] == 1
    (row,) = rep["rows"]
    assert row["name"] == "grid60" and row["n"] == 3600
    for tag in ("published", "trained"):
        assert 0 < row[tag]["final"] <= row[tag]["phase1"]
        assert row[tag]["assist"] is None     # the CPU solve: no assist
    assert last["worst_final_delta_pct"] == rep["worst_final_delta_pct"]


def test_smallsolve_bench_batches_and_results_equal_jax(tmp_path):
    """The tool's regions are the JAX tool's; on the CPU K4 runs its plain
    version, which the tool holds against the enumeration, and both equal
    the JAX enumeration."""
    rng_a, rng_b = np.random.default_rng(3), np.random.default_rng(3)
    for n in (16, 20):
        a = smallsolve_bench.random_batch(rng_a, 12, n)
        b = jax_smallsolve_bench.random_batch(rng_b, 12, n)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    adj, w = smallsolve_bench.random_batch(np.random.default_rng(3), 12, 16)
    cost, sset = small_mwvc_mitm(torch.from_numpy(adj), torch.from_numpy(w))
    jc, js = jax_enumeration(adj, w)
    np.testing.assert_array_equal(cost.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(sset.numpy(), np.asarray(js))

    out = str(tmp_path / "sb.json")
    assert smallsolve_bench.main(["--batch", "8", "--bursts", "1", "--per",
                                  "1", "--out", out, *CPU]) == 0
    with open(out) as f:
        rows = json.load(f)
    assert rows["parity_n16"].startswith("bitwise equal")
    assert rows["batch"] == 8 and rows["device"] == "cpu"
    assert rows["k4_16_regions_per_s"] > 0 and rows["k4_20_regions_per_s"] > 0


def test_precision_study_on_the_cpu(tmp_path):
    """The JAX tool's rows and keys; on the CPU every setting is the fp32
    forward, so each equals the ground truth bit for bit."""
    out = str(tmp_path / "ps.json")
    assert precision_study.main(["--side", "30", "--iters", "1",
                                 "--batches", "1", "--out", out, *CPU]) == 0
    with open(out) as f:
        rep = json.load(f)
    assert rep["n"] == 900 and rep["e_directed"] > 0
    for tag in ("highest", "mixed", "default"):
        row = rep[tag]
        assert {"edges_per_s", "ms_per_forward", "first_call_s",
                "max_abs_err", "mean_abs_err", "frac_gt_2e-5"} <= set(row)
        assert row["max_abs_err"] == 0.0
    assert rep["mixed"]["precision"] == "highest"
