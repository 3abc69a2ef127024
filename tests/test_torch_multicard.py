"""The port's multi-device path placed on several cards, checked on the CPU:
the tools' shard placement (one shard per card with ``--device cuda``, as
the JAX tools take one device per shard), the timing that synchronises
every card of a mesh, and a ``parallel.dryrun dist`` rank whose shards sit
on devices of their own.  ``torch.cuda.device_count`` is monkeypatched
where a test needs a number of cards; nothing here launches on a card.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from test_torch_distributed import _gloo_world

import gnn_mwvc_tpu_torch.parallel.mesh as mesh_mod
import gnn_mwvc_tpu_torch.parallel.sharded as sharded_mod
from gnn_mwvc_tpu_torch.parallel import (make_mesh, mesh_seconds_per_call,
                                         place_mesh)
from gnn_mwvc_tpu_torch.tools import scale_bench, scaling_weak, sharded_solve

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cards(monkeypatch, n):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)


def _devices(mesh):
    return [str(d) for d in mesh.devices]


@pytest.mark.parametrize("parts", [1, 2, 4])
def test_tool_mesh_puts_one_shard_on_each_card(monkeypatch, parts):
    _cards(monkeypatch, 4)
    mesh = place_mesh(parts, "cuda")
    assert _devices(mesh) == [f"cuda:{i}" for i in range(parts)]
    assert mesh.group is None and mesh.parts == parts


@pytest.mark.parametrize("cards", [1, 4])
@pytest.mark.parametrize("device", ["cpu", "cuda:0"])
def test_tool_mesh_repeats_a_named_device(monkeypatch, cards, device):
    _cards(monkeypatch, cards)
    assert _devices(place_mesh(4, device)) == [device] * 4
    assert _devices(place_mesh(4, device, skip=True)) == [device] * 4


def test_tool_mesh_above_the_card_count_skips_or_raises(monkeypatch, capsys):
    _cards(monkeypatch, 1)
    assert _devices(place_mesh(1, "cuda")) == ["cuda:0"]
    assert place_mesh(2, "cuda", skip=True) is None
    assert capsys.readouterr().err == "skip parts=2: only 1 devices\n"
    with pytest.raises(RuntimeError, match="2 CUDA cards, found 1"):
        place_mesh(2, "cuda")


def _placed_on_cpu(monkeypatch, module):
    """Run ``module``'s tool on the host while it places shards on 2
    monkeypatched cards: its data stays on the CPU and every mesh it asks
    ``sharded_row`` for is recorded, then run on the CPU."""
    _cards(monkeypatch, 2)
    monkeypatch.setattr(module, "resolve_device", lambda d: torch.device("cpu"))
    asked, real = [], scale_bench.sharded_row

    def row(model, dg, ws, ref, mesh, iters):
        asked.append(_devices(mesh))
        return real(model, dg, ws, ref,
                    make_mesh(mesh.parts, devices=["cpu"] * mesh.parts), iters)

    monkeypatch.setattr(module, "sharded_row", row)
    return asked


def _jax_scale_bench(argv, devices):
    out = subprocess.run(
        [sys.executable, "-c", "import tests.conftest\n"
         f"import tools.scale_bench as t\nt.main({argv!r})\n"],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=REPO, XLA_FLAGS=
                 f"--xla_force_host_platform_device_count={devices}"))
    assert out.returncode == 0, out.stderr[-3000:]
    return out


def test_scale_bench_skips_the_parts_the_jax_tool_skips(monkeypatch, capsys):
    """2 cards, --parts 1,2,4: the port runs P = 1 on cuda:0 and P = 2 on
    cuda:0, cuda:1 and skips P = 4 with the JAX tool's line, as the JAX
    tool does on 2 devices."""
    asked = _placed_on_cpu(monkeypatch, scale_bench)
    argv = ["--n", "2000", "--deg", "12", "--parts", "1,2,4", "--iters", "1"]
    assert scale_bench.main([*argv, "--device", "cuda"]) == 0
    out = capsys.readouterr()
    rows = json.loads(out.out.strip().splitlines()[-1])
    assert asked == [["cuda:0"], ["cuda:0", "cuda:1"]]
    jax = _jax_scale_bench(argv, 2)
    want = json.loads(jax.stdout.strip().splitlines()[-1])
    assert [r["parts"] for r in rows] == [w["parts"] for w in want] == [1, 2]
    skip = "skip parts=4: only 2 devices"
    assert skip in out.err.splitlines() and skip in jax.stderr.splitlines()
    assert all(r["max_abs_err_vs_single"] <= 1e-5 for r in rows)


def test_scaling_weak_places_and_skips_as_scale_bench(monkeypatch, capsys,
                                                      tmp_path):
    asked = _placed_on_cpu(monkeypatch, scaling_weak)
    out = str(tmp_path / "weak.json")
    assert scaling_weak.main(["--side", "20", "--er-n", "1000", "--parts",
                              "1,2,4", "--out", out, "--device", "cuda"]) == 0
    assert capsys.readouterr().err.count("skip parts=4: only 2 devices") == 1
    # the same two meshes for each instance
    assert asked == [["cuda:0"], ["cuda:0", "cuda:1"]] * 2
    with open(out) as f:
        res = json.load(f)
    for name in ("road20", "er1k"):
        assert [c["parts"] for c in res[name]["configs"]] == [1, 2]
        assert all(c["max_err_vs_single"] <= 1e-5
                   for c in res[name]["configs"])


def test_sharded_solve_refuses_more_shards_than_cards(monkeypatch):
    """The JAX tool asserts its mesh fits the devices; the port raises,
    naming both counts, before it reads the graph."""
    _cards(monkeypatch, 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(RuntimeError, match="4 CUDA cards, found 2"):
        sharded_solve.main(["road60", "--parts", "4", "--device", "cuda"])


def test_mesh_timing_synchronises_every_card(monkeypatch):
    waited, calls = [], []
    monkeypatch.setattr(torch.cuda, "synchronize", waited.append)
    devices = [torch.device(d) for d in
               ("cuda:0", "cuda:1", "cuda:1", "cuda:2", "cuda:3", "cpu")]
    dt = mesh_seconds_per_call(lambda: calls.append(len(waited)), devices,
                               3)
    cards = [torch.device(f"cuda:{i}") for i in range(4)]
    assert dt >= 0 and waited == cards * 2
    # after the warm-up every card is waited for, and again after the 3rd
    assert calls == [0, 4, 4, 4]


@pytest.mark.parametrize("backend,waits", [("gloo", True), ("nccl", False)])
def test_collectives_wait_for_every_card_only_under_gloo(monkeypatch, backend,
                                                         waits):
    waited = []
    monkeypatch.setattr(torch.cuda, "synchronize", waited.append)
    monkeypatch.setattr(sharded_mod.dist, "get_backend", lambda g: backend)
    mesh = make_mesh(2, devices=["cuda:0", "cuda:1"])
    mesh = dataclasses.replace(mesh, group=object())
    sharded_mod._sync_for_collective(mesh, mesh.devices)
    assert waited == (list(mesh.devices) if waits else [])


def test_rank_devices(monkeypatch):
    """Rank 1 of 2, two shards each: ``--device`` names one device for both
    or one per shard; without it both are on ``cuda:<rank % cards>``."""
    _cards(monkeypatch, 4)
    monkeypatch.setattr(mesh_mod.dist, "get_world_size", lambda g: 2)
    monkeypatch.setattr(mesh_mod.dist, "get_rank", lambda g: 1)
    group = object()
    for device, want in ((None, ["cuda:1"] * 2), ("cuda:0", ["cuda:0"] * 2),
                         ("cuda:2,cuda:3", ["cuda:2", "cuda:3"])):
        mesh = place_mesh(4, device, group=group)
        assert _devices(mesh) == want and mesh.group is group
        assert mesh.shard_ids == (2, 3)
    with pytest.raises(ValueError, match="3 devices for 2 shards"):
        place_mesh(4, "cpu,cpu,cpu", group=group)


def test_gloo_ranks_with_a_device_per_shard(tmp_path):
    """2 gloo ranks x 2 shards, ``--device cpu,cpu`` (a device named per
    shard): the rows and loss of ``--device cpu`` for all of a rank's
    shards, as ``test_torch_distributed.py::
    test_gloo_ranks_of_several_shards`` runs it."""
    rows = {}
    results = {}
    for device in ("cpu,cpu", "cpu"):
        path = str(tmp_path / (device.replace(",", "_") + "{rank}.npy"))
        results[device] = _gloo_world("--shards-per-rank", "2", "--device",
                                      device, "--out", path)
        rows[device] = [np.load(path.format(rank=r)) for r in range(2)]
    for rank, r in enumerate(results["cpu,cpu"]):
        assert r["ok"] and r["devices"] == ["cpu", "cpu"]
        assert r["shard_ids"] == [2 * rank, 2 * rank + 1]
        assert r["loss"] == results["cpu"][rank]["loss"]
        np.testing.assert_array_equal(rows["cpu,cpu"][rank], rows["cpu"][rank])


def test_launch_counts_lose_no_update_across_threads(monkeypatch):
    """Autograd runs each card's K1 backward on a thread of its own, so
    ``_build.count`` adds each launch while it holds its lock."""
    from gnn_mwvc_tpu_torch.ops import _build

    seen = []

    class Lock:
        def __enter__(self):
            seen.append(("enter", _build.launches["stress"]))

        def __exit__(self, *exc):
            seen.append(("exit", _build.launches["stress"]))

    monkeypatch.setattr(_build, "_COUNT_LOCK", Lock())
    before = _build.launches["stress"]
    _build.count("stress")
    assert _build.launches.pop("stress") == before + 1
    assert seen == [("enter", before), ("exit", before + 1)]
