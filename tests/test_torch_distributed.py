"""Two processes form a gloo world on the CPU and run the port's sharded
forward and train step across it (``parallel.dryrun dist``): the halo
all-to-all crosses the process boundary.  Each rank holds its rows within
1e-5 of its own single-device forward; the train step's loss equals the
same step on a local mesh of as many shards.  With 2 shards per rank (the
JAX package's ``tests/dist_worker.py`` layout) the rows are also held
against the JAX ``score_graph``."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import bench
from gnn_mwvc_tpu.graph import DeviceGraph as JaxDeviceGraph
from gnn_mwvc_tpu.models import load_pretrained
from gnn_mwvc_tpu.models.gnn import score_graph as jax_score_graph
from gnn_mwvc_tpu_torch.graph import DeviceGraph, build_road_graph
from gnn_mwvc_tpu_torch.models import pretrained_model
from gnn_mwvc_tpu_torch.parallel import (make_mesh, make_sharded_train_step,
                                         partition_device_graph)
from gnn_mwvc_tpu_torch.parallel.dryrun import train_labels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDE = 40


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _gloo_world(*extra):
    """Two ``parallel.dryrun dist`` ranks on the CPU; their JSON records."""
    init = f"tcp://127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "gnn_mwvc_tpu_torch.parallel.dryrun", "dist",
         str(rank), "2", init, "--backend", "gloo", "--device", "cpu",
         "--road", str(SIDE), *[a.format(rank=rank) for a in extra]],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    results = []
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{err[-3000:]}"
        results.append(json.loads(out.strip().splitlines()[-1]))
    return results


def _local_loss(parts):
    g = build_road_graph(SIDE)
    mesh = make_mesh(parts, devices=["cpu"] * parts)
    sg = partition_device_graph(DeviceGraph.from_graph(g, "cpu"), parts,
                                devices=mesh)
    step, _opt = make_sharded_train_step(pretrained_model("cpu"), mesh)
    return step(sg, train_labels(sg), float(g.weights.max()))


def test_two_process_gloo_forward_and_train_step():
    results = _gloo_world()
    for rank, r in enumerate(results):
        assert r["rank"] == rank and r["world"] == 2 and r["ok"]
        assert r["max_abs_err"] <= 1e-5
    assert results[0]["loss"] == results[1]["loss"]
    np.testing.assert_allclose(results[0]["loss"], _local_loss(2), rtol=1e-6)


@pytest.mark.parametrize("k", [2])
def test_gloo_ranks_of_several_shards(k, tmp_path):
    """2 ranks x k shards: each rank runs shards rank*k .. rank*k + k - 1,
    its rows within 1e-5 of the single-device forward and of the JAX
    ``score_graph``; the loss equals a local mesh of 2k shards' to 1e-6."""
    rows = str(tmp_path / "rows{rank}.npy")
    results = _gloo_world("--shards-per-rank", str(k), "--out", rows)
    for rank, r in enumerate(results):
        assert r["shards_per_rank"] == k and r["ok"]
        assert r["shard_ids"] == list(range(rank * k, rank * k + k))
        assert r["max_abs_err"] <= 1e-5 and r["cuda_devices_used"] == []
    assert results[0]["loss"] == results[1]["loss"]
    np.testing.assert_allclose(results[0]["loss"], _local_loss(2 * k),
                               rtol=1e-6)

    gj = bench.build_road_graph(SIDE)
    ref = np.asarray(jax_score_graph(load_pretrained(),
                                     JaxDeviceGraph.from_graph(gj),
                                     float(gj.weights.max())))[:gj.n]
    got = np.concatenate([np.load(rows.format(rank=r)) for r in range(2)])
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
