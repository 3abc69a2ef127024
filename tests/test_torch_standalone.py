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
# The port's copy of the core differs from the JAX package's by two
# repairs: apply_region's buffer of flipped vertices (localsearch.hpp), and
# the independent-neighbourhood fold refused on a dependent neighbourhood
# (revgraph.hpp, solver.hpp, capi.cpp).  Per file, each entry is the JAX
# copy's text and the first and last lines of the port's text in its place.
REPAIRS = {
    "localsearch.hpp": [
        ("", "    //\n    // This copy differs", "before anything is written.\n"),
        ("", "        if (k > 32)\n", "            return 0;\n"),
        ("        u32 changed[16];\n", "        u32 changed[32];\n",
         "        u32 changed[32];\n"),
    ],
    "revgraph.hpp": [
        ("", "// A gadget's own list is the exception",
         "reads no order at all.\n"),
        ("    // largest id so sorted order is preserved.\n",
         "    // largest id so x's list stays sorted.",
         "walk order: it is not sorted.\n"),
        ("", "    // Lists in order, entry by entry", "a twin fold missed.\n"),
        ("    // pre-checks identical to the reference.\n",
         "    // pre-checks identical to the reference.  An entry",
         "a domination or isolated fold missed.\n"),
        ("", "    // The sorted merge of N(u) with each N(v).",
         "step past the common neighbour.\n"),
        ("", "\n    // Whether no two neighbours of u are adjacent",
         "                    return false;\n        }\n        return true;"
         "\n    }\n"),
    ],
    "solver.hpp": [
        ("", "    u64 dependent_folds = 0;", "by rule_independent_fold\n"),
        ("        if (g.has_independent_neighbors(u)) {\n",
         "        // This copy differs from the JAX package's here.",
         "        if (independent) {\n"),
        ("    // quirks (reference: mwvc_reductions.hpp:179-202).\n",
         "    // quirks (reference: mwvc_reductions.hpp:179-202).  Every",
         "can only make the rule miss.\n"),
        ("", "    parent.dependent_folds += child.dependent_folds;\n",
         "child.dependent_folds;\n"),
    ],
    "capi.cpp": [
        ("", "\n// Folds on a dependent neighbourhood",
         ": g.has_independent_neighbors(u);\n}\n"),
    ],
}

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
    byte, but for the two repairs of ``REPAIRS``: with each repair's text
    put back to the JAX copy's, the file is the JAX copy."""
    assert api.SRC_DIR == os.path.join(PORT, "core", "src")
    assert sorted(os.listdir(api.SRC_DIR)) == sorted(api._SOURCES)
    with open(os.path.join(api.SRC_DIR, name)) as f:
        mine = f.read()
    with open(os.path.join(JAX_PKG, "core", "src", name)) as f:
        theirs = f.read()
    for before, first, last in REPAIRS.get(name, ()):
        assert mine.count(first) == 1, first
        start = mine.index(first)
        end = mine.index(last, start) + len(last)
        mine = mine[:start] + before + mine[end:]
    assert mine == theirs
