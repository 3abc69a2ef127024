"""Dry runs of the multi-device path.

    python -m gnn_mwvc_tpu_torch.parallel.dryrun local N [--device cpu|cuda:0]
    python -m gnn_mwvc_tpu_torch.parallel.dryrun dist RANK WORLD INIT_METHOD \\
        [--backend gloo|nccl] [--device DEV[,DEV...]] [--road SIDE]
        [--shards-per-rank K] [--out ROWS.npy]

``local``: over a mesh of N shards in this process (one per CUDA card with
``--device cuda``, the default; all N on a device named otherwise), on a
512-node synthetic graph: one sharded train step (finite loss), one sharded
forward (finite scores), then ``solve(time_limit=0)`` with
``ShardedGnnScorer``, whose cover is validated.

``dist``: one rank of a ``torch.distributed`` world of WORLD ranks (start
one process per rank with the same INIT_METHOD, e.g.
``tcp://127.0.0.1:29512``), K shards each (``--shards-per-rank``, default
1; the JAX package's ``tests/dist_worker.py`` runs 2 ranks of 2), on a
road-like graph: the sharded forward, its rows held within 1e-5 of this
rank's rows of the single-device forward (``--out`` saves them, real nodes
only, in node order), then one train step.  ``--device`` names one device
for all K shards of the rank or a comma list of K, one per shard (rank r of
2 x 2 cards: ``cuda:2r,cuda:2r+1``; ``mesh.place_mesh``); without it
every shard is on ``cuda:<rank % cards>`` (no card raises).  The rank's
first device holds the single-device reference, the staging of the
exchange and NCCL's communicator (bound with ``torch.cuda.set_device``
before the first collective).  The last line is JSON with the rank's
error, loss, milliseconds per forward (host clock around a synchronise of
every card of the rank), kernel launches and the CUDA devices it allocated
on.  NCCL needs a card of its own per rank; gloo takes CPU or CUDA tensors
(CUDA ones cross through the host).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch
import torch.distributed as dist

from gnn_mwvc_tpu_torch.graph import DeviceGraph, Graph, build_road_graph
from gnn_mwvc_tpu_torch.graphio import cover_cost, is_vertex_cover
from gnn_mwvc_tpu_torch.models import pretrained_model, score_graph
from gnn_mwvc_tpu_torch.ops import _build
from gnn_mwvc_tpu_torch.parallel.mesh import (init_distributed, make_mesh,
                                              mesh_seconds_per_call,
                                              place_mesh, synchronize)
from gnn_mwvc_tpu_torch.parallel.sharded import (make_sharded_forward,
                                                 make_sharded_train_step,
                                                 partition_device_graph)

__all__ = ["dist_worker", "dryrun_multichip", "synthetic_graph",
           "train_labels"]

DIST_TOL = 1e-5
DIST_ITERS = 5   # timed forwards per rank


def synthetic_graph(n: int = 4096, avg_deg: int = 16, seed: int = 0) -> Graph:
    """Random graph from random vertex pairs, weights in [1, 1000]: the same
    graph for a seed as ``__graft_entry__._synthetic_graph``, which the JAX
    package's multi-device dry run scores."""
    rng = np.random.default_rng(seed)
    m = n * avg_deg // 2
    u = rng.integers(0, n, size=int(m * 1.2))
    v = rng.integers(0, n, size=int(m * 1.2))
    lo, hi = np.minimum(u, v), np.maximum(u, v)
    keep = lo != hi
    edges = np.unique(np.stack([lo[keep], hi[keep]], axis=1), axis=0)[:m]
    return Graph(rng.integers(1, 1001, size=n), edges)


def train_labels(sg, seed: int = 0) -> np.ndarray:
    """(parts, n_loc) 0/1 labels of the real nodes, from ``seed``."""
    y = np.zeros(sg.parts * sg.n_loc, np.float32)
    y[:sg.n] = np.random.default_rng(seed).random(sg.n) < 0.5
    return y.reshape(sg.parts, sg.n_loc)


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """The train step, forward and integrated solve over a local mesh of
    ``n_devices`` shards (``devices`` as ``make_mesh`` takes them)."""
    from gnn_mwvc_tpu_torch.solver.pipeline import solve
    from gnn_mwvc_tpu_torch.solver.sharded_score import ShardedGnnScorer

    mesh = make_mesh(n_devices, devices=devices)
    home = mesh.devices[0]
    g = synthetic_graph(n=512, avg_deg=8, seed=1)
    ws = float(g.weights.max())
    sg = partition_device_graph(DeviceGraph.from_graph(g, home), n_devices,
                                devices=mesh)

    step, _opt = make_sharded_train_step(pretrained_model(home), mesh)
    loss = step(sg, np.zeros((n_devices, sg.n_loc), np.float32), ws)
    if not np.isfinite(loss):
        raise RuntimeError(f"dry run: train step loss {loss}")
    scores = make_sharded_forward(pretrained_model(home), mesh)(sg, ws)
    if not all(bool(torch.isfinite(s).all()) for s in scores):
        raise RuntimeError("dry run: non-finite sharded scores")

    res = solve(g, time_limit=0.0, device=home, device_assist=False,
                scorer=ShardedGnnScorer(pretrained_model(home), mesh=mesh,
                                         min_nodes=0))
    if not is_vertex_cover(g, res.solution) or \
            cover_cost(g, res.solution) != res.cost:
        raise RuntimeError("dry run: the sharded solve's cover is invalid")
    print(f"dryrun_multichip({n_devices}): loss={loss:.6f} "
          f"solve_cost={res.cost} ok")
    return {"loss": loss, "solve_cost": res.cost}


def dist_worker(rank: int, world: int, init_method: str,
                backend: str = "gloo", device: str | None = None,
                road: int = 40, shards_per_rank: int = 1,
                out: str | None = None) -> dict:
    """One rank of a process-group world of ``shards_per_rank`` shards per
    rank: the sharded forward against this rank's rows of the
    single-device forward, its time, and one train step.  ``device``: this
    rank's, one for every shard or a comma list (``place_mesh``), default
    ``cuda:<rank % cards>`` (no card raises).  Raises if the forward
    differs by more than ``DIST_TOL``."""
    k = shards_per_rank
    init_distributed(backend, init_method, world, rank)
    try:
        mesh = place_mesh(world * k, device, group=dist.group.WORLD)
        device = mesh.devices[0]
        if device.type == "cuda":
            # NCCL's communicator and gloo's CUDA work use this card
            torch.cuda.set_device(device)
        g = build_road_graph(road)
        ws = float(g.weights.max())
        dg = DeviceGraph.from_graph(g, device)
        sg = partition_device_graph(dg, mesh.parts, devices=mesh)
        model = pretrained_model(device)
        single = score_graph(model, dg, ws)
        fwd = make_sharded_forward(model, mesh, x_is_node_weights=True)
        _build.launches.clear()
        outs = fwd(sg, ws)
        synchronize(mesh.devices)
        launches = dict(_build.launches)
        shard_ids = list(mesh.shard_ids)
        lo = shard_ids[0] * sg.n_loc
        n_rows = max(min(g.n - lo, k * sg.n_loc), 0)

        rows = torch.cat([o.to(device) for o in outs])[:n_rows]
        err = float((rows - single[lo:lo + n_rows]).abs().max()) \
            if n_rows else 0.0
        if out is not None:
            np.save(out, rows.cpu().numpy())
        ms = mesh_seconds_per_call(lambda: fwd(sg, ws), mesh.devices,
                                   DIST_ITERS) * 1e3
        step, _opt = make_sharded_train_step(pretrained_model(device), mesh)
        loss = step(sg, train_labels(sg), ws)
        synchronize(mesh.devices)
        cards = [f"cuda:{i}" for i in range(torch.cuda.device_count())
                 if torch.cuda.memory_allocated(i) > 0]
    finally:
        dist.destroy_process_group()
    result = {"rank": rank, "world": world, "backend": backend,
              "device": str(device),
              "devices": [str(d) for d in mesh.devices],
              "shards_per_rank": k, "shard_ids": shard_ids, "n": g.n,
              "n_loc": sg.n_loc, "h_max": sg.h_max,
              "halo_bytes_per_shard": sg.halo_bytes_per_chip(),
              "transport": f"all_to_all_single over {backend} on "
              f"{device.type} tensors staged on {device}, copies within "
              "the rank", "max_abs_err": err, "loss": loss,
              "forward_ms": ms, "launches": launches,
              "cuda_devices_used": cards, "ok": err <= DIST_TOL}
    if err > DIST_TOL:
        raise RuntimeError(f"rank {rank}: the sharded forward differs from "
                           f"the single-device one by {err}: {result}")
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(prog="gnn_mwvc_tpu_torch.parallel.dryrun")
    sub = ap.add_subparsers(dest="mode", required=True)
    loc = sub.add_parser("local", help="every shard in this process")
    loc.add_argument("shards", type=int)
    loc.add_argument("--device", default="cuda",
                     help="cuda: one shard per card; cpu, cuda:0, ...: all "
                          "shards on that device")
    dst = sub.add_parser("dist", help="one rank of a process group")
    dst.add_argument("rank", type=int)
    dst.add_argument("world", type=int)
    dst.add_argument("init_method")
    dst.add_argument("--backend", default="gloo", choices=["gloo", "nccl"])
    dst.add_argument("--device", default=None,
                     help="this rank's device for all its shards, or a comma "
                          "list of one per shard (default cuda:<rank %% "
                          "cards>)")
    dst.add_argument("--road", type=int, default=40,
                     help="side of the road-like graph (side^2 nodes)")
    dst.add_argument("--shards-per-rank", type=int, default=1)
    dst.add_argument("--out", default=None,
                     help="save this rank's forward rows (.npy)")
    args = ap.parse_args(argv)
    if args.mode == "local":
        dryrun_multichip(args.shards,
                         place_mesh(args.shards, args.device).devices)
    else:
        print(json.dumps(dist_worker(args.rank, args.world, args.init_method,
                                     args.backend, args.device, args.road,
                                     args.shards_per_rank, args.out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
