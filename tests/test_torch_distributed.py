"""Two processes form a gloo world on the CPU and run the port's sharded
forward and train step across it (``parallel.dryrun dist``): the halo
all-to-all crosses the process boundary.  Each rank holds its rows within
1e-5 of its own single-device forward; the train step's loss equals the
same step on a local 2-shard mesh."""

import json
import os
import socket
import subprocess
import sys

import numpy as np

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


def test_two_process_gloo_forward_and_train_step():
    init = f"tcp://127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "gnn_mwvc_tpu_torch.parallel.dryrun", "dist",
         str(rank), "2", init, "--backend", "gloo", "--device", "cpu",
         "--road", str(SIDE)],
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
    for rank, r in enumerate(results):
        assert r["rank"] == rank and r["world"] == 2 and r["ok"]
        assert r["max_abs_err"] <= 1e-5
    assert results[0]["loss"] == results[1]["loss"]

    g = build_road_graph(SIDE)
    mesh = make_mesh(2, devices=["cpu"] * 2)
    sg = partition_device_graph(DeviceGraph.from_graph(g, "cpu"), 2,
                                devices=mesh)
    step, _opt = make_sharded_train_step(pretrained_model("cpu"), mesh)
    local = step(sg, train_labels(sg), float(g.weights.max()))
    np.testing.assert_allclose(results[0]["loss"], local, rtol=1e-6)
