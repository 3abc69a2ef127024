"""The runner's boundaries: no JAX and no JAX package in what it loads, no
result without a card or without the program, and (on a card) a short
run of every cell whose result line holds what a traced run must give."""

import json
import os
import shutil
import subprocess
import sys
import types

import pytest

from perfbench.run import FORBIDDEN, ROOT, forbidden_modules, load_json

BENCH = load_json(os.path.join(ROOT, "BENCHMARK.json"))
CLI = [sys.executable, "-m", "perfbench.run", "--workload", "road1200.cover",
       "--seed", "3", "--seconds", "1", "--trace", "0"]

LOADS = """
import json, sys
sys.path.insert(0, {root!r})
from perfbench.run import FORBIDDEN, run_cell
import perfbench.readings, perfbench.reference.train
run_cell("road1200.cover", 5, 0.3, True, device="cpu", scale={{"side": 40}},
         control=True)
run_cell("road700.train", 5, 0.3, False, device="cpu", scale={{"side": 20}})
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    assert FORBIDDEN == ("jax", "jaxlib", "flax", "gnn_mwvc_tpu")
    for name in ("jax.numpy", "gnn_mwvc_tpu.graph", "flax"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    monkeypatch.setitem(sys.modules, "gnn_mwvc_tpu_torch_like",
                        types.ModuleType("x"))
    found = forbidden_modules()
    assert "jax.numpy" in found and "gnn_mwvc_tpu.graph" in found
    assert "gnn_mwvc_tpu_torch_like" not in found
    assert not any(m.split(".")[0] == "gnn_mwvc_tpu_torch" for m in found)


def test_nothing_the_harness_or_reference_loads_is_jax():
    out = subprocess.run([sys.executable, "-c", LOADS.format(root=ROOT)],
                         capture_output=True, text=True, timeout=600,
                         cwd=ROOT, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "gnn_mwvc_tpu_torch" in tops and "perfbench" in tops
    assert not tops & set(FORBIDDEN)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(CLI, capture_output=True, text=True, cwd=ROOT,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    """A directory with BENCHMARK.json and perfbench/ alone."""
    shutil.copytree(os.path.join(ROOT, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(CLI, capture_output=True, text=True, cwd=tmp_path,
                         timeout=300, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_short_run_on_the_card(cell):
    """Every cell, at a small size on the card, traced: correct, and the
    per-layer metrics and the device's busy seconds."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from perfbench.run import metrics_of, run_cell

    out = run_cell(cell, 2**31 + 101, 12.0, True,
                   scale={"side": 300})
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert out["device"]["busy_s"] > 0
    names = {m["name"] for m in metrics_of(BENCH, cell, True)}
    assert set(out["metrics"]) <= names and out["metrics"]
    for m in out["metrics"].values():
        if m["unit"] == "%":
            assert 0 < m["value"] <= 105
