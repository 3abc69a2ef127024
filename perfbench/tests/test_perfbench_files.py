"""BENCHMARK.json and the files it names: found by name, inside the
benchmark's limits, and a cell defined only by new files (in a temporary
checkout) runs without an edit to any file that is there."""

import json
import os
import re
import shutil

import pytest

from perfbench.run import ROOT, load_json, metrics_of, resolve_cell, run_cell

BENCH = load_json(os.path.join(ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "e2e": {"name", "unit", "better", "bound", "source"},
    "layer": {"name", "unit", "better", "source", "layer", "moves"},
}
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "projection",
               "head", "expansion", "experts_per_token", "width")


def line_ok(text, limit=200):
    return 1 <= len(text) <= limit and "\n" not in text and "\t" not in text


def test_top_level_and_command():
    assert set(BENCH) == KEYS["top"]
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(line_ok(w) for w in cmd)
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 s
    cells = 24
    total = ((2 + 14 * cells) * (BENCH["run_seconds"] + 60)
             + cells * 2 * 90 + 1200)
    assert total <= 43200


def test_names_units_and_lines():
    names = [c["name"] for c in BENCH["configs"]]
    names += [w["name"] for w in BENCH["workloads"]]
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names += [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in BENCH["configs"]:
        assert set(c) == KEYS["config"]
        assert line_ok(c["source"]) and line_ok(c["why"])
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k)
            assert not k.endswith(("_dim", "_rank"))
            assert not any(w in k for w in WIDTH_WORDS), k
    for w in BENCH["workloads"]:
        assert set(w) == KEYS["workload"]
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and line_ok(w["why"])
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == KEYS["e2e"]
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == KEYS["layer"]
        assert line_ok(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert [m["name"] for m in BENCH["end_to_end"]].count("setup_s") == 1
    assert len(BENCH["workloads"]) <= 24
    fours = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert fours <= max(1, len(BENCH["workloads"]) // 4)


def test_every_file_is_found_by_name():
    used = set()
    for w in BENCH["workloads"]:
        cell, config, traffic = resolve_cell(BENCH, w["name"])
        used.add(w["config"])
        assert config["name"] == w["config"]
        for key in ("entry", "limits"):
            assert key in traffic
        assert os.path.exists(os.path.join(ROOT, "perfbench", "entries",
                                           traffic["entry"] + ".py"))
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        assert load_json(os.path.join(ROOT, c["file"]))["source"]


def test_each_cell_reports_what_it_must():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        mine = [m["name"] for m in metrics_of(BENCH, w["name"], False)]
        assert "setup_s" in mine and len(mine) >= 2, w["name"]
        assert metrics_of(BENCH, w["name"], True), w["name"]
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", [cell]), (m["name"], cell)
    # metrics of one layer name it alike; a layer names one module
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all(line_ok(x) for x in layers)


def test_a_cell_defined_only_by_new_files_runs(tmp_path):
    """A later PR adds a configuration, a traffic mix and a metric by
    adding files and entries; no file that is there changes."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "perfbench"), root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: (root / "perfbench" / p).read_bytes()
              for p in map(str, _files(root / "perfbench"))}
    bench = json.loads(json.dumps(BENCH))
    (root / "perfbench" / "configs" / "road48.json").write_text(json.dumps({
        "name": "road48", "source": "test", "side": 48, "extra": 0.05,
        "instance_seed": 42}))
    traffic = load_json(os.path.join(ROOT, "perfbench", "traffic",
                                     "cover.json"))
    traffic["solve"]["reorder"] = False
    (root / "perfbench" / "traffic" / "cover-plain.json").write_text(
        json.dumps(traffic))
    (root / "perfbench" / "metrics" / "solves_done.py").write_text(
        "def read(ctx):\n    return len(ctx['counters']['solves'])\n")
    bench["configs"].append({"name": "road48", "source": "test",
                             "file": "perfbench/configs/road48.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "road48.cover-plain",
                               "config": "road48", "traffic": "cover-plain",
                               "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "cover_s":
            m["workloads"].append("road48.cover-plain")
    bench["end_to_end"].append({"name": "solves_done", "unit": "solves",
                                "better": "higher", "bound": 0.01,
                                "source": "host_clock",
                                "workloads": ["road48.cover-plain"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = run_cell("road48.cover-plain", 7, 0.5, False, device="cpu",
                   root=str(root))
    assert out["correct"]
    assert out["metrics"]["solves_done"]["value"] == out["attempted"] >= 1
    assert set(out["metrics"]) == {"cover_s", "setup_s", "solves_done"}
    for p, data in before.items():
        assert (root / "perfbench" / p).read_bytes() == data, p


def _files(top):
    return [p.relative_to(top) for p in top.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts]


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_traffic_says_why_and_has_limits(name):
    _cell, _config, traffic = resolve_cell(BENCH, name)
    assert line_ok(traffic["why"])
    assert all(v >= 0 for v in traffic["limits"].values())
