"""The port stands on its own: it builds its native core from its own copy
of the sources, loads its own copy of the pretrained weights and solves in
a directory that holds no JAX package; the copies equal the JAX package's
files, but for the one repair in ``localsearch.hpp``, which an ASan build
of the port's core holds to.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from gnn_mwvc_tpu_torch.core import api
from gnn_mwvc_tpu_torch.graph import build_road_graph
from gnn_mwvc_tpu_torch.graphio import cover_cost, is_vertex_cover
from gnn_mwvc_tpu_torch.models import serialize
from gnn_mwvc_tpu_torch.solver.pipeline import solve

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "gnn_mwvc_tpu_torch")
JAX_PKG = os.path.join(REPO, "gnn_mwvc_tpu")
REPAIRED = ("localsearch.hpp",)

STANDALONE = """
import importlib.util, json, sys
from gnn_mwvc_tpu_torch.core import api
from gnn_mwvc_tpu_torch.graph import build_road_graph
from gnn_mwvc_tpu_torch.models import pretrained_model, serialize
from gnn_mwvc_tpu_torch.solver.pipeline import solve
res = solve(build_road_graph(60), pretrained_model("cpu"), time_limit=0,
            device="cpu")
print(json.dumps({
    "cost": int(res.cost), "solution": [int(v) for v in res.solution],
    "src_dir": api.SRC_DIR, "lib": api.LIB_PATH,
    "pretrained": serialize.PRETRAINED_PATH,
    "jax_package": importlib.util.find_spec("gnn_mwvc_tpu") is not None,
    "loaded": sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "gnn_mwvc_tpu"))}))
"""


def test_port_builds_loads_and_solves_without_the_jax_package(tmp_path):
    """A copy of ``gnn_mwvc_tpu_torch/`` (without its build directory),
    alone on the path, builds the core from its own sources and finds the
    same phase-1 cover of road60 as the package in the repository."""
    root = tmp_path.resolve()
    shutil.copytree(PORT, root / "gnn_mwvc_tpu_torch", ignore=shutil.
                    ignore_patterns("_build", "__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "MWVC_CORE_LIB"}
    out = subprocess.run(
        [sys.executable, "-c", STANDALONE], cwd=root,
        env=dict(env, PYTHONPATH=str(root)),
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    copy = str(root / "gnn_mwvc_tpu_torch")
    for key in ("src_dir", "lib", "pretrained"):
        assert rec[key].startswith(copy + os.sep), (key, rec[key])
    assert os.path.exists(rec["lib"])
    assert not rec["jax_package"] and rec["loaded"] == []

    g = build_road_graph(60)
    here = solve(g, time_limit=0, device="cpu")
    sol = np.array(rec["solution"])
    assert is_vertex_cover(g, sol)
    assert rec["cost"] == cover_cost(g, sol) == here.cost
    np.testing.assert_array_equal(sol, here.solution)


def test_patch_flipping_all_20_vertices_under_asan():
    """The wide-patch test against an ASan build of the port's copy of the
    core: the 20 flipped vertices fit the patch buffer, so the sanitizer
    reports nothing (built from the JAX package's copy, with its 16-entry
    buffer, it reports a stack-buffer-overflow in ``apply_region``)."""
    libasan = subprocess.run(["g++", "-print-file-name=libasan.so"],
                             capture_output=True, text=True).stdout.strip()
    if not os.path.isabs(libasan) or not os.path.exists(libasan):
        pytest.skip("g++ names no libasan.so")
    test = ("tests/test_torch_core_exact.py::"
            "test_patch_flipping_all_20_vertices_keeps_scores_exact")
    out = subprocess.run(
        ["bash", os.path.join(PORT, "core", "sanitize.sh"), "asan", test],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    text = out.stdout + out.stderr
    assert out.returncode == 0, text[-4000:]
    assert "AddressSanitizer" not in text
    assert "1 passed" in out.stdout


def test_weights_file_equals_the_jax_package_copy():
    assert serialize.PRETRAINED_PATH == os.path.join(
        PORT, "models", "weights", "gnn_vc_sea2022.txt")
    with open(serialize.PRETRAINED_PATH, "rb") as f:
        mine = f.read()
    with open(os.path.join(JAX_PKG, "models", "weights",
                           "gnn_vc_sea2022.txt"), "rb") as f:
        assert mine == f.read()


@pytest.mark.parametrize("name", api._SOURCES)
def test_core_sources_equal_the_jax_package_copy(name):
    """Every source the core is built from is the JAX package's, byte for
    byte, except ``localsearch.hpp``: its ``apply_region`` records up to 32
    flipped vertices where the JAX copy records 16."""
    assert api.SRC_DIR == os.path.join(PORT, "core", "src")
    assert sorted(os.listdir(api.SRC_DIR)) == sorted(api._SOURCES)
    with open(os.path.join(api.SRC_DIR, name)) as f:
        mine = f.read()
    with open(os.path.join(JAX_PKG, "core", "src", name)) as f:
        theirs = f.read()
    if name not in REPAIRED:
        assert mine == theirs
        return
    assert theirs.count("u32 changed[16];") == 1
    repaired = theirs.replace("u32 changed[16];", "u32 changed[32];")
    start = mine.index("    //\n    // This copy differs")
    end = mine.index("        u64 old_c = 0, new_c = 0;\n", start)
    guard = ("    int apply_region(u32 k, const u32 *ids, u32 new_mask) {\n"
             "        if (k > 32)\n            return 0;\n")
    assert mine[start:end].endswith(guard)
    plain_head = guard.replace("        if (k > 32)\n            return 0;\n",
                               "")
    assert mine[:start] + plain_head + mine[end:] == repaired
