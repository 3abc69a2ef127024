"""The port's multi-device tools against the JAX package's, on the CPU:
``sharded_solve``, ``er_slice_bench``, ``scale_bench`` and ``scaling_weak``
(``gnn_mwvc_tpu_torch/tools/``), their P shards on the host.  The JAX tools
run as the oracle: in this process where they leave the JAX backends alone,
in a subprocess (``tests/conftest.py``'s virtual CPU devices, P of them for
``sharded_solve``'s mesh) where they reset them or need another count.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import tools.er_slice_bench as jax_er_slice_bench
from gnn_mwvc_tpu.graph import DeviceGraph as JaxDeviceGraph
from gnn_mwvc_tpu.models import load_pretrained
from gnn_mwvc_tpu.models.gnn import score_graph as jax_score_graph
from gnn_mwvc_tpu_torch.graph import DeviceGraph
from gnn_mwvc_tpu_torch.models import pretrained_model
from gnn_mwvc_tpu_torch.tools import (er_slice_bench, scale_bench,
                                      scaling_weak, sharded_solve)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]
TOL = 1e-5    # sharded against one device
GATE = 2e-5   # the port's forward against the JAX package's


def _jax_subprocess(code, env=None):
    out = subprocess.run(
        [sys.executable, "-c", "import tests.conftest\n" + code], cwd=REPO,
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=REPO, **(env or {})))
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


@pytest.mark.parametrize("parts", [2, 4])
def test_sharded_solve_equals_jax(parts, tmp_path, capsys):
    ours, ref = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    assert sharded_solve.main(["road60", "--parts", str(parts), "--out", ours,
                               *CPU]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    # the JAX tool's mesh takes every device: P of them in its process
    _jax_subprocess(
        "import sys, tools.sharded_solve as t\n"
        f"sys.exit(t.main(['road60', '--parts', '{parts}', '--out', {ref!r}]))",
        env={"XLA_FLAGS": f"--xla_force_host_platform_device_count={parts}"})
    with open(ours) as f:
        assert json.load(f) == rec
    with open(ref) as f:
        want = json.load(f)
    assert rec["identical_covers"] is True
    assert rec["cost_mesh"] == rec["cost_single"] == want["cost_single"]
    assert set(want) - {"mesh_scorer"} <= set(rec)
    assert rec["h_max"] > 0 and rec["halo_bytes_per_shard_per_layer"] == (
        parts * rec["h_max"] * 16 * 4)
    assert rec["mesh_scorer"]["parts"] == parts


def test_er_slice_bench_rows_and_scores_equal_jax(tmp_path, capsys):
    ours, ref = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    argv = ["--n", "2000", "--deg", "16", "--parts", "1,4", "--iters", "1",
            "--batches", "1", "--out"]
    assert er_slice_bench.main([*argv, ours, *CPU]) == 0
    jax_er_slice_bench.main([*argv, ref])
    with open(ours) as f:
        a = json.load(f)
    with open(ref) as f:
        b = json.load(f)
    assert len(a["rows"]) == len(b["rows"]) == 2
    for r, w in zip(a["rows"], b["rows"]):
        assert set(w) <= set(r)
        for k in ("parts", "n_slice", "e_slice"):
            assert r[k] == w[k], k
        assert r["t_iter_ms"] > 0 and r["per_slice_edges_per_s"] > 0
    # the same slice graphs, and the same scores on them
    model = pretrained_model("cpu")
    for p in (1, 4):
        g = er_slice_bench.build_er(2000 // p, 16, seed=3 + p)
        gj = jax_er_slice_bench.build_er(2000 // p, 16, seed=3 + p)
        np.testing.assert_array_equal(g.weights, gj.weights)
        np.testing.assert_array_equal(g.edge_array(), gj.edge_array())
        dg = DeviceGraph.from_graph(g, "cpu")
        ws = float(g.weights.max())
        got = er_slice_bench.forward_scores(
            model, dg, ws, dg.weights.new_zeros(dg.n, 1))[:, 0].numpy()
        want = np.asarray(jax_score_graph(
            load_pretrained(), JaxDeviceGraph.from_graph(gj), ws))[:g.n]
        np.testing.assert_allclose(got, want, rtol=0, atol=GATE)


def test_scale_bench_equals_single_device_and_jax(capsys):
    argv = ["--n", "2000", "--deg", "12", "--parts", "1,2,4", "--iters", "1"]
    assert scale_bench.main([*argv, *CPU]) == 0
    rows = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = json.loads(_jax_subprocess(
        f"import tools.scale_bench as t\nt.main({argv!r})\n"
    ).strip().splitlines()[-1])
    assert [r["parts"] for r in rows] == [w["parts"] for w in want] == [1, 2, 4]
    for r, w in zip(rows, want):
        assert set(w) <= set(r)
        assert r["max_abs_err_vs_single"] <= TOL
        assert w["max_abs_err_vs_single"] <= TOL
        assert r["edges_per_s"] > 0 and r["t_partition_s"] >= 0
    assert rows[0]["h_max"] == 0 and rows[2]["halo_bytes_per_shard"] == (
        4 * rows[2]["h_max"] * 16 * 4)


def test_scaling_weak_equals_single_device_and_jax(tmp_path, capsys):
    ours, ref = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    assert scaling_weak.main(["--side", "40", "--er-n", "2000", "--parts",
                              "1,2,4", "--out", ours, *CPU]) == 0
    _jax_subprocess("import tools.scaling_weak as t\nt.main()\n",
                    env={"SCALE_SIDE": "40", "SCALE_ER_N": "2000",
                         "SCALE_PARTS": "1,2,4", "SCALE_OUT": ref})
    with open(ours) as f:
        a = json.load(f)
    with open(ref) as f:
        b = json.load(f)
    assert sorted(a) == sorted(b) == ["er2k", "road40"]
    for name in a:
        assert set(b[name]) <= set(a[name])
        assert (a[name]["n"], a[name]["e_directed"]) == (
            b[name]["n"], b[name]["e_directed"])
        for r, w in zip(a[name]["configs"], b[name]["configs"]):
            assert set(w) <= set(r)
            assert r["parts"] == w["parts"]
            assert r["max_err_vs_single"] <= TOL
            assert w["max_err_vs_single"] <= TOL
            # the JAX partition splits its bucket-padded rows, so its
            # ranges and halos differ; the port's halo is its own h_max's
            assert (r["h_max"] > 0) == (r["parts"] > 1)
            assert r["halo_bytes_per_chip"] == r["parts"] * r["h_max"] * 64
