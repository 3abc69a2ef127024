"""The port's phase-2 and protocol tools against the JAX package's, on the
CPU: ``dump_kernel``, ``assist_ab``, ``canonical`` and ``reduce_scale``
(``gnn_mwvc_tpu_torch/tools/``).  Each JAX tool runs in this process as the
oracle, its relay-probe gate skipped and its output sent to ``tmp_path``;
each port tool runs through its ``main(argv)`` with ``--device cpu``.
"""

import importlib
import itertools
import json
import time

import numpy as np
import pytest
import torch

import tools.assist_ab as jax_assist_ab
import tools.canonical as jax_canonical
import tools.dump_kernel as jax_dump_kernel
import tools.reduce_scale as jax_reduce_scale
from gnn_mwvc_tpu_torch.graph import build_road_graph
from gnn_mwvc_tpu_torch.graphio import cover_cost, is_vertex_cover
from gnn_mwvc_tpu_torch.solver.static_score import StickyGnnScorer
from gnn_mwvc_tpu_torch.tools import (assist_ab, canonical, dump_kernel,
                                      reduce_scale)

CPU = ["--device", "cpu"]
KERNEL_KEYS = ("weights", "edges", "s0", "prob", "initial_cost", "t_phase1")


@pytest.fixture(scope="module")
def kernels(tmp_path_factory):
    """road60's kernel dumped by both packages: (port npz, JAX npz).  Both
    sticky scorers peel per snapshot on the CPU."""
    d = tmp_path_factory.mktemp("kernels")
    ours, ref = str(d / "port.npz"), str(d / "jax.npz")
    assert dump_kernel.main(["road60", "--out", ours, *CPU]) == 0
    jax_dump_kernel.main(["road60", "--out", ref])
    return ours, ref


def test_dump_kernel_equals_jax(kernels):
    ours, ref = (dict(np.load(p)) for p in kernels)
    assert sorted(ours) == sorted(ref) == sorted(KERNEL_KEYS)
    for k in ("weights", "edges", "s0", "initial_cost"):
        assert ours[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    assert ours["prob"].dtype == np.float32
    np.testing.assert_allclose(ours["prob"], ref["prob"], rtol=0, atol=2e-5)


def test_dump_kernel_sticky_is_a_valid_kernel(tmp_path, capsys):
    """The production (sticky) phase 1: the same kernel graph, a cover of it,
    every kernel vertex scored."""
    out = str(tmp_path / "k.npz")
    assert dump_kernel.main(["road40", "--out", out, *CPU]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    k = dict(np.load(out))
    assert (rec["n"], rec["m"]) == (len(k["weights"]), len(k["edges"]))
    u, v = k["edges"].astype(np.int64).T
    assert ((k["s0"][u] == 1) | (k["s0"][v] == 1)).all()
    assert rec["cover_cost"] == int(k["initial_cost"]) + int(
        k["weights"][k["s0"] == 1].sum())
    assert ((k["prob"] >= 0) & (k["prob"] <= 1)).all()
    assert not (k["prob"] == 0.5).all()


@pytest.mark.parametrize("which", [0, 1], ids=["port_npz", "jax_npz"])
def test_assist_ab_four_variants(kernels, which, tmp_path, capsys):
    """Either package's npz replays in the port's A/B: four rows, assist
    batches in the region variants, no row worse than the initial cover.
    The region variants get a longer budget: on the CPU each batch is
    solved by K4's plain version inside the search loop, and a batch counts
    once the next tick collects it."""
    rows = []
    for variants, budget in (("plain,guided", "0.5"), ("regions,full", "5")):
        out = str(tmp_path / f"{variants}.json")
        assert assist_ab.main([kernels[which], "--variants", variants,
                               "--time", budget, "--batch", "16", "--out",
                               out, *CPU]) == 0
        printed = [json.loads(ln) for ln in
                   capsys.readouterr().out.splitlines() if ln.startswith("{")]
        with open(out) as f:
            assert json.load(f)["rows"] == printed
        rows += printed
    assert [r["variant"] for r in rows] == list(assist_ab.VARIANTS)
    k = dict(np.load(kernels[which]))
    initial = int(k["initial_cost"]) + int(k["weights"][k["s0"] == 1].sum())
    for r in rows:
        assert r["total_with_init"] == r["best_cost"] + int(k["initial_cost"])
        assert r["total_with_init"] <= initial
        assert r["best_seen"] <= r["best_cost"] and r["steps"] > 0
        if r["variant"] in ("regions", "full"):
            st = r["assist"]
            assert st["batches"] > 0
            assert {"patches", "gain", "t_host_s", "t_device_s"} <= set(st)
        else:
            assert r["assist"] is None


@pytest.mark.parametrize("variant", ["plain", "guided"])
def test_assist_ab_variant_equals_jax(kernels, variant, monkeypatch):
    """Without the assist a variant is deterministic once the clock is a
    counter (one second a read): the port's row equals the JAX
    ``run_variant``'s on the JAX npz, ILS kicks included."""
    kern = dict(np.load(kernels[1]))
    rows = []
    for run in (jax_assist_ab.run_variant, assist_ab.run_variant):
        ticks = itertools.count()
        monkeypatch.setattr(time, "perf_counter", lambda: float(next(ticks)))
        args = (kern, variant, 2000.0, 1)
        rows.append(run(*args) if run is jax_assist_ab.run_variant
                    else run(*args, torch.device("cpu")))
        monkeypatch.undo()
    ref, ours = rows
    assert ours.pop("launches") == {}
    assert ours == ref
    assert ref["kicks"] >= 2 and ref["steps"] > 0


def test_assist_ab_width_20_regions(kernels, tmp_path, capsys):
    assert assist_ab.main([kernels[0], "--time", "1", "--batch", "4",
                           "--rmax", "20", "--variants", "full", "--out",
                           str(tmp_path / "ab.json"), *CPU]) == 0
    (row,) = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
              if ln.startswith("{")]
    assert row["assist"]["regions"] > 0   # width-20 regions were solved


def test_canonical_writes_a_valid_cover_and_the_csv_line(tmp_path, capsys,
                                                         monkeypatch):
    results = []

    def solve_and_keep(*args, **kwargs):
        results.append(canonical_solve(*args, **kwargs))
        return results[-1]

    canonical_solve = canonical.solve
    monkeypatch.setattr(canonical, "solve", solve_and_keep)
    out = str(tmp_path / "c.json")
    assert canonical.main(["road60", "--time", "1", "--tag", "t", "--out",
                           out, *CPU]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    name, written, best, t_best = lines[-2].split(",")
    rec = json.loads(lines[-1])
    with open(out) as f:
        assert json.load(f) == rec
    assert name == "road60" and int(written) == rec["written"]
    assert int(best) == rec["best"] <= rec["written"]
    assert float(t_best) == rec["t_best"] and "relay_probe" not in rec
    assert rec["device_assist"] is False and rec["ls_steps"] >= 0
    (res,) = results
    g = build_road_graph(60)
    assert is_vertex_cover(g, res.solution)
    assert cover_cost(g, res.solution) == rec["written"]


@pytest.mark.parametrize("scorer", ["snapshot", "sticky"])
def test_canonical_equals_jax(scorer, tmp_path, monkeypatch):
    """Phase 1 alone (--time 0, no assist) on road60 beside the JAX tool:
    the port's default sticky scorer writes the JAX tool's cover (1,225,582).
    "sticky" runs it as it is on the CPU, where both scorers peel every round
    per snapshot; "snapshot" marks it as on a card, where road60's live
    edges, under the 4M threshold, route every round per snapshot."""
    argv = ["road60", "--time", "0", "--no-device-assist"]
    ref, ours = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    jax_canonical.main([*argv, "--no-probe", "--out", ref])
    if scorer == "snapshot":
        init = StickyGnnScorer.__init__

        def on_a_card(self, *args, **kw):
            init(self, *args, **kw)
            self._accelerated = True

        monkeypatch.setattr(StickyGnnScorer, "__init__", on_a_card)
    assert canonical.main([*argv, "--out", ours, *CPU]) == 0
    with open(ref) as f:
        b = json.load(f)
    with open(ours) as f:
        a = json.load(f)
    assert set(a) == set(b) - {"relay_probe"}
    assert a["best"] == a["written"] and b["best"] == b["written"]
    assert a["written"] == b["written"] == 1_225_582
    assert a["scorer"]["legacy_rounds"] == a["scorer"]["rounds"] > 0


@pytest.mark.parametrize("side", [60, 240])
def test_reduce_scale_equals_jax(side, tmp_path, capsys):
    """side 60 is under the prepass's 50,000-node floor (both tools skip
    it); side 240 runs it."""
    ours, ref = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    assert reduce_scale.main(["--side", str(side), "--out", ours, *CPU]) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jax_reduce_scale.main(["--side", str(side), "--out", ref])
    with open(ours) as f:
        a = json.load(f)
    with open(ref) as f:
        b = json.load(f)
    for side_ in ("host", "device"):
        for k in ("n", "e", "kernel", "cost"):
            assert a[side_][k] == b[side_][k], (side_, k)
    assert a["device"]["prepass"] == b["device"]["prepass"]
    assert a["device"]["active_after_prepass"] == b["device"][
        "active_after_prepass"]
    assert set(b["device"]) <= set(a["device"])
    assert last["winner"] in ("host", "device")
    assert (a["device"]["prepass"]["rounds"] > 0) == (side * side >= 50_000)


@pytest.mark.parametrize("tool,argv", [
    ("dump_kernel", ["road20"]), ("assist_ab", ["missing.npz"]),
    ("canonical", ["road20"]), ("sharded_solve", ["road20"]),
    ("er_slice_bench", ["--n", "100"]), ("scale_bench", ["--n", "100"]),
    ("scaling_weak", ["--side", "10"]), ("reduce_scale", ["--side", "10"]),
    ("precision_study", ["--side", "10"]), ("smallsolve_bench", ["--batch", "2"]),
    ("train_quality", ["--epochs", "0"])])
def test_tools_default_to_the_card_and_raise_without_one(tool, argv,
                                                         monkeypatch):
    """No fallback: with the default --device cuda and no card, every tool
    raises before it does any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"gnn_mwvc_tpu_torch.tools.{tool}")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(argv)
