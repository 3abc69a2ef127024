"""Device meshes for the multi-device path, and process-group bring-up.

A ``Mesh`` lays the shards of one graph out over devices (the graph's nodes
split into contiguous ranges, ``parallel/sharded.py``).  Two transports move
the halo rows:

  * local (``group=None``): one process holds every shard, each on its own
    listed device, and the exchange copies rows between them (peer copies
    between cards).  One shard per CUDA card is the default; ``devices=
    ["cuda:0"] * 4`` or ``["cpu"] * 8`` put several shards on one device,
    the counterpart of the JAX package's virtual CPU devices;
  * process group (``group`` given): each rank holds k >= 1 shards, the
    same k on every rank, so the shard count is k times the group's size
    (the JAX package's global mesh of several devices per process,
    ``tests/dist_worker.py``: 2 processes x 2 devices, each shard on a
    device of its own).  Rank r holds shards r*k .. r*k + k - 1, on one
    card or on k; rows between two of them are copied in the process and
    rows between ranks cross in one ``torch.distributed`` collective per
    exchange, staged on the rank's first device (NCCL's communicator lives
    there: bind it with ``torch.cuda.set_device`` before the first
    collective).

The JAX mesh's "data" axis has no counterpart: nothing in the port runs
data parallelism over a mesh.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import torch
import torch.distributed as dist

__all__ = ["Mesh", "init_distributed", "make_mesh", "mesh_seconds_per_call",
           "place_mesh", "synchronize"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices``: the device of each shard this process holds, in shard
    order (in a process group, this rank's k)."""

    devices: tuple
    group: object = None

    @property
    def parts(self) -> int:
        """Shards of the graph, over all processes."""
        if self.group is not None:
            return dist.get_world_size(self.group) * len(self.devices)
        return len(self.devices)

    @property
    def shard_ids(self) -> tuple:
        """The shards this process runs."""
        k = len(self.devices)
        first = dist.get_rank(self.group) * k if self.group is not None else 0
        return tuple(range(first, first + k))


def make_mesh(n_graph: int | None = None, devices=None, group=None) -> Mesh:
    """A mesh of ``n_graph`` shards.

    Without ``devices`` every CUDA card is one shard, ``cuda:0`` first; more
    shards than cards raises, naming both counts (there is no CPU fallback).
    With ``group`` (a process group, or ``dist.group.WORLD``) every rank
    holds k shards: ``devices`` names this rank's k devices, in shard
    order; without it k is ``n_graph / world`` (default 1), all on
    ``cuda:<rank % cards>`` (no card raises).
    """
    if group is not None:
        world, rank = dist.get_world_size(group), dist.get_rank(group)
        if devices is None:
            k = 1 if n_graph is None else n_graph // world
            cards = torch.cuda.device_count()
            if cards == 0:
                raise RuntimeError("a process-group mesh without devices= "
                                   "needs a CUDA card, found 0")
            devices = [f"cuda:{rank % cards}"] * max(k, 1)
        if not devices or (n_graph is not None
                           and n_graph != world * len(devices)):
            raise ValueError(f"{world} ranks of {len(devices)} shards cannot "
                             f"hold {n_graph} shards")
        return Mesh(tuple(torch.device(d) for d in devices), group=group)
    if devices is None:
        cards = torch.cuda.device_count()
        want = n_graph if n_graph is not None else max(cards, 1)
        if want > cards:
            raise RuntimeError(f"a mesh of {want} shards needs {want} CUDA "
                               f"cards, found {cards}")
        devices = [f"cuda:{i}" for i in range(want)]
    devices = tuple(torch.device(d) for d in devices)
    if not devices or (n_graph is not None and n_graph != len(devices)):
        raise ValueError(f"{len(devices)} devices cannot hold {n_graph} "
                         "shards")
    return Mesh(devices)


def place_mesh(parts: int, device: str | None = None, group=None,
               skip: bool = False) -> Mesh | None:
    """The mesh of ``parts`` shards that a ``--device`` option names, placed
    as the JAX tools place theirs, one device per shard:

      * ``cuda`` (no index): shard i on ``cuda:i``;
      * ``cpu`` or ``cuda:K``: all shards on that device (the partition and
        the exchange's overhead, not a speed-up);
      * in a process group (``group``), this rank's shards: one device for
        all of them or a comma list of one per shard (rank r of 2 x 2
        cards: ``cuda:2r,cuda:2r+1``); None is ``make_mesh``'s default.

    More shards than cards raises, naming both counts, unless ``skip``:
    then one line on stderr says so and the result is None (the JAX
    ``tools/scale_bench.py`` skips such a P)."""
    if group is not None:
        devices = None
        if device is not None:
            k = parts // dist.get_world_size(group)
            devices = device.split(",")
            if len(devices) == 1:
                devices = devices * k
            elif len(devices) != k:
                raise ValueError(f"--device names {len(devices)} devices for "
                                 f"{k} shards per rank")
        return make_mesh(parts, devices=devices, group=group)
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and dev.index is None:
        cards = torch.cuda.device_count()
        if skip and parts > cards:
            print(f"skip parts={parts}: only {cards} devices", file=sys.stderr)
            return None
        return make_mesh(parts)
    return make_mesh(parts, devices=[dev] * parts)


def synchronize(devices) -> None:
    """Wait for the queued work of every CUDA device among ``devices`` (a
    device or an iterable of them), each once."""
    if isinstance(devices, (str, torch.device)):
        devices = [devices]
    for d in dict.fromkeys(torch.device(d) for d in devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def mesh_seconds_per_call(fn, devices, iters: int) -> float:
    """Mean seconds per call of ``iters`` back-to-back calls after one
    warm-up, by the host clock from a ``synchronize`` of every CUDA device
    in ``devices`` to another after the last call: a CUDA event on one card
    does not wait for kernels on the others.  Every sharded time is taken
    this way, and so is the single-device time it is set beside."""
    fn()
    synchronize(devices)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    synchronize(devices)
    return (time.perf_counter() - t0) / iters


def init_distributed(backend: str | None = None,
                     init_method: str | None = None,
                     world_size: int | None = None,
                     rank: int | None = None) -> None:
    """Join a process group (no-op unless ``backend`` is given): ``backend``
    is "nccl" (one card per rank) or "gloo", never chosen for the caller;
    ``init_method`` e.g. ``tcp://localhost:29500``."""
    if backend is not None:
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world_size, rank=rank)
