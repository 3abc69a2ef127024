"""Device meshes for the multi-device path, and process-group bring-up.

A ``Mesh`` lays the shards of one graph out over devices (the graph's nodes
split into contiguous ranges, ``parallel/sharded.py``).  Two transports move
the halo rows:

  * local (``group=None``): one process holds every shard, each on its own
    listed device, and the exchange copies rows between them.  One shard per
    CUDA card is the default; ``devices=["cuda:0"] * 4`` or ``["cpu"] * 8``
    put several shards on one device, the counterpart of the JAX package's
    virtual CPU devices;
  * process group (``group`` given): each rank holds k >= 1 shards, the
    same k on every rank, so the shard count is k times the group's size
    (the JAX package's global mesh of several devices per process,
    ``tests/dist_worker.py``: 2 processes x 2 devices).  Rank r holds shards
    r*k .. r*k + k - 1; rows between two of them are copied in the process
    and rows between ranks cross in one ``torch.distributed`` collective per
    exchange.

The JAX mesh's "data" axis has no counterpart: nothing in the port runs
data parallelism over a mesh.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

__all__ = ["Mesh", "init_distributed", "make_mesh"]


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
