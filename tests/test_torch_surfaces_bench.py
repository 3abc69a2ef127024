"""The port's last surfaces against the JAX package's: the bench line
(``bench.py``), ``entry()`` (``__graft_entry__.py``) and the kernel-dump /
local-search tools (``tools/kernel_dump.py``, ``tools/ls_run.py``)."""

import json
import os
import stat

import numpy as np
import pytest

import __graft_entry__ as jax_graft
import tools.kernel_dump as jax_kernel_dump
import tools.ls_run as jax_ls_run
from gnn_mwvc_tpu_torch import bench, entry
from gnn_mwvc_tpu_torch.graph import build_road_graph
from gnn_mwvc_tpu_torch.tools import kernel_dump, ls_run

KEYS = ("weights", "eu", "ev", "s0", "initial_cost", "cost_gnn")


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    """road40's kernel dumped by both tools (the port's on the CPU)."""
    tmp = tmp_path_factory.mktemp("kern")
    ours, ref = str(tmp / "port"), str(tmp / "jax")
    assert kernel_dump.main(["--instance", "road40", "--out", ours,
                             "--device", "cpu"]) == 0
    jax_kernel_dump.main(["--instance", "road40", "--out", ref])
    return ours, ref


def test_kernel_dump_writes_the_jax_files(dumps):
    ours, ref = dumps
    with open(ours + ".kern", "rb") as a, open(ref + ".kern", "rb") as b:
        data = a.read()
        assert data == b.read()
    assert data.startswith(b"MWVCKRN1")
    za, zb = np.load(ours + ".npz"), np.load(ref + ".npz")
    assert sorted(za.files) == sorted(zb.files) == sorted(KEYS + ("t_phase1",))
    for k in KEYS:
        assert za[k].dtype == zb[k].dtype
        np.testing.assert_array_equal(za[k], zb[k])


def test_kernel_files_load_in_either_package(dumps, tmp_path):
    ours, ref = dumps
    for path in (ours + ".kern", ref + ".kern"):
        a, b = kernel_dump.read_kernel(path), jax_kernel_dump.read_kernel(path)
        for x, y in zip(a[:4], b[:4]):
            np.testing.assert_array_equal(x, y)
        assert a[4] == b[4] > 0
    w, eu, ev, s0, c0 = kernel_dump.read_kernel(ours + ".kern")
    again = str(tmp_path / "again.kern")
    kernel_dump.write_kernel(again, w, eu, ev, s0, c0)
    with open(again, "rb") as f1, open(ours + ".kern", "rb") as f2:
        assert f1.read() == f2.read()
    bad = tmp_path / "bad.kern"
    bad.write_bytes(b"NOTAKERN" + bytes(16))
    with pytest.raises(ValueError, match="MWVCKRN1"):
        kernel_dump.read_kernel(str(bad))
    assert kernel_dump.build_instance("er2000_d6").n == 2000
    with pytest.raises(SystemExit):
        kernel_dump.build_instance("grid40")


def _step_lines(text):
    """The CSV lines without their clock fields (seconds, steps/s)."""
    rows = []
    for ln in text.strip().splitlines():
        parts = ln.split(",")
        if parts[0] == "final":
            parts = parts[:-1]
        rows.append(tuple(parts[:2] + parts[3:]))
    return rows


@pytest.mark.parametrize("variant", ls_run.VARIANTS)
def test_ls_run_steps_as_the_jax_tool(dumps, variant, capsys):
    """With a step cap both searches are the same, event by event: the
    same improvements, diversifications and final best cost."""
    path = dumps[1] + ".kern"
    args = [path, "--steps", "400000", "--stall", "2", "--variant", variant]
    assert ls_run.main(args) == 0
    ours = capsys.readouterr().out
    jax_ls_run.main(args)
    ref = capsys.readouterr().out
    assert _step_lines(ours) == _step_lines(ref)
    final = ours.strip().splitlines()[-1].split(",")
    assert final[0] == "final" and int(final[1]) >= 400000
    if variant != "plain":
        assert any(ln.startswith("div,") for ln in ours.splitlines())


def test_bench_prints_one_line_with_the_jax_keys(monkeypatch, tmp_path,
                                                 capsys):
    monkeypatch.setenv("BENCH_SIDE", "40")
    monkeypatch.setenv("BENCH_ITERS", "2")
    monkeypatch.setenv("BENCH_BATCHES", "2")
    monkeypatch.setattr(bench, "ORACLE_DIR", str(tmp_path))
    assert bench.main(["--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    assert len(lines) == 1
    assert "vs_baseline: the recorded reference rate" in err
    rec = json.loads(lines[0])
    assert list(rec) == ["metric", "value", "unit", "vs_baseline"]
    assert rec["metric"] == "gnn_score_edges_per_s"
    assert rec["unit"] == "edges/s" and rec["value"] > 0
    assert rec["vs_baseline"] == round(rec["value"]
                                       / bench.REFERENCE_EDGES_PER_S, 3)


def test_bench_measures_the_reference_with_the_oracle(monkeypatch, tmp_path):
    g = build_road_graph(10)
    monkeypatch.setattr(bench, "ORACLE_DIR", str(tmp_path))
    assert bench.measure_reference(g) == bench.REFERENCE_EDGES_PER_S
    oracle = tmp_path / "bench_predict"
    oracle.write_text("#!/bin/sh\ntest -s \"$1\" && test \"$2\" = 3 && "
                      "echo 0.5 1000\n")
    oracle.chmod(oracle.stat().st_mode | stat.S_IXUSR)
    assert bench.measure_reference(g) == 2000.0
    assert os.path.exists(tmp_path / f"bench_road_{g.n}.metis")
    oracle.write_text("#!/bin/sh\nexit 1\n")
    assert bench.measure_reference(g) == bench.REFERENCE_EDGES_PER_S


def test_entry_is_the_jax_entry():
    fn, args = entry.entry(device="cpu")
    model, dg, ws = args
    assert dg.n == 4096 and len(model.kinds) == 21
    out = fn(*args).numpy()
    jfn, jargs = jax_graft.entry()
    ref = np.asarray(jfn(*jargs))[:dg.n]
    assert ws == float(jargs[2])
    assert out.shape == (4096,) and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=0)


def test_entry_main_and_multichip(capsys):
    assert entry.main(["--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert text.startswith("entry ok:")
    assert len(text.split(":", 1)[1].strip(" []\n").split()) == 4
    assert entry.main(["multichip", "2", "--device", "cpu"]) == 0
    assert "dryrun_multichip(2)" in capsys.readouterr().out
