"""Edge-partitioned message passing over a mesh of devices.

The nodes of one graph are split into P contiguous ranges of ``n_loc`` rows,
one per shard; every directed edge belongs to the shard that owns its
destination row.  A graph layer is

  1. the exchange: each shard packs the rows its peers reference (per-peer
     boundary sets built at partition time) and one all-to-all swaps them,
     so a shard receives a halo of ``P * h_max`` rows, proportional to the
     cut and not to the graph;
  2. kernel K1 on the shard's block: its ``n_loc`` rows summed over the
     source space ``[local rows | halo]``, each row's sources in the graph's
     CSR order.  Every shard row sums the same values in the same order as
     the single-device K1, so a shard's aggregate is bitwise equal to its
     rows of the whole graph's;
  3. the stat columns (D, W/ws, NW/ws), which are per node and local.

Linear and activation layers are per row.  ``halo=False`` replaces the
exchange by a gather of every shard's rows (the JAX package's differential
test mode).  The exchange is an ``autograd.Function`` whose backward is the
reverse exchange, and K1's backward runs on each block's transposed CSR,
so the train step differentiates through the whole walk.

Port of the JAX package's ``parallel/sharded.py``, without what exists for
XLA's static shapes or the TPU: shape templates and headroom, padded edge
slots and sentinel rows, and the windowed-MXU plans (K1 replaces both TPU
aggregation plans, as on one device).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from gnn_mwvc_tpu_torch.graph import DeviceGraph
from gnn_mwvc_tpu_torch.models.gnn import (MWVCModel, graph_layer,
                                           matmul_precision)
from gnn_mwvc_tpu_torch.ops.aggregate import csr_aggregate, csr_transpose
from gnn_mwvc_tpu_torch.parallel.mesh import Mesh, synchronize

__all__ = [
    "Shard",
    "ShardedGraph",
    "gather_scores",
    "make_sharded_forward",
    "make_sharded_train_step",
    "make_sticky_sharded_forward",
    "partition_device_graph",
]


@dataclasses.dataclass
class Shard:
    """One shard's arrays, all on ``device``.

    Row i is node ``index * n_loc + i`` of the graph; rows past its last
    node are padding (``node_mask`` False, no edges).  ``indptr`` and
    ``indices``: the int32 CSR of the shard's rows over ``n_src`` source
    rows, ``[local rows | received rows]``.  ``send_idx``: the local rows
    packed for the exchange, slot ``q * block + j`` holding the j-th row
    peer q needs; None when there is one shard and nothing to exchange.
    """

    index: int
    device: torch.device
    weights: torch.Tensor    # (n_loc,) f32
    degrees: torch.Tensor    # (n_loc,) f32
    nw: torch.Tensor         # (n_loc,) f32
    node_mask: torch.Tensor  # (n_loc,) bool
    indptr: torch.Tensor
    indices: torch.Tensor
    n_src: int
    send_idx: torch.Tensor | None
    _transposed: tuple | None = None

    def transposed(self) -> tuple:
        """The block's transposed CSR (K1's gradient), built at first use."""
        if self._transposed is None:
            self._transposed = csr_transpose(self.indptr, self.indices,
                                             self.n_src)
        return self._transposed


@dataclasses.dataclass
class ShardedGraph:
    """A graph split over ``parts`` shards; ``shards`` holds the ones this
    process runs (all of them on a local mesh, its rank's in a process
    group)."""

    n: int        # real nodes
    n_loc: int    # rows per shard
    parts: int
    h_max: int    # rows per peer in the halo exchange; 0 without one
    shards: list

    @property
    def halo(self) -> bool:
        return self.h_max > 0

    def halo_bytes_per_chip(self, width: int = 16) -> int:
        """Bytes one shard sends per graph layer (f32 features)."""
        if self.halo:
            return int(self.parts * self.h_max * width * 4)
        return int((self.parts - 1) * self.n_loc * width * 4)


class _Stats(NamedTuple):
    """The per-node columns ``graph_layer`` reads, for one shard."""

    degrees: torch.Tensor
    weights: torch.Tensor
    nw: torch.Tensor


def _local_sources(indptr, indices, n, parts, n_loc, halo):
    """Each edge's source in its shard's source space, the exchange's send
    slots (parts, parts * block) and the halo block size."""
    if parts == 1:
        return indices, None, 0
    if not halo:
        # every shard sends all its rows to every peer: the received buffer
        # is the whole graph, node v at row n_loc + v
        send = np.tile(np.arange(n_loc, dtype=np.int64), (parts, parts))
        return n_loc + indices, send, 0
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    dst, src = rows // n_loc, indices // n_loc
    bnd = dst != src
    # one sorted-unique over (dst shard, src shard, node) gives every
    # (p, q) boundary set in block order; a node's rank in its block is its
    # slot j
    space = np.int64(parts) * n_loc
    key = (dst[bnd] * parts + src[bnd]) * space + indices[bnd]
    uniq, inv = np.unique(key, return_inverse=True)
    pq, node = uniq // space, uniq % space
    blocks, starts, counts = np.unique(pq, return_index=True,
                                       return_counts=True)
    h_max = max(int(counts.max()) if len(counts) else 0, 1)
    j = np.arange(len(uniq), dtype=np.int64) - starts[np.searchsorted(blocks,
                                                                      pq)]
    p, q = pq // parts, pq % parts
    send = np.zeros((parts, parts * h_max), dtype=np.int64)
    send[q, p * h_max + j] = node - q * n_loc
    local = indices - dst * n_loc
    local[bnd] = n_loc + src[bnd] * h_max + j[inv]
    return local, send, h_max


def _check_block(p, ptr, idx, n_src):
    """A shard's block CSR on the host, before upload: K1 reads x through it
    unchecked on the card (``csr_aggregate`` checks only CPU tensors)."""
    if (ptr[0] != 0 or (np.diff(ptr) < 0).any() or ptr[-1] != len(idx)
            or (len(idx) and (idx.min() < 0 or idx.max() >= n_src))):
        raise ValueError(f"shard {p}: the block CSR is corrupt (indptr "
                         f"{ptr[0]}..{ptr[-1]} over {len(idx)} indices in "
                         f"0..{n_src})")


def partition_device_graph(dg: DeviceGraph, parts: int, halo: bool = True,
                           devices: Mesh | None = None) -> ShardedGraph:
    """Split a ``DeviceGraph`` into ``parts`` contiguous node ranges.

    devices: a ``Mesh`` of ``parts`` shards, whose devices take the shards
    (in a process group only this rank's is built), or None for every shard
    on the graph's own device.  halo=False gathers every shard's rows
    instead of exchanging the boundary (the differential-test mode).
    """
    n = dg.n
    indptr, indices = (t.cpu().numpy().astype(np.int64)
                       for t in (dg.indptr, dg.indices))
    w, deg, nw = (t.cpu().numpy() for t in (dg.weights, dg.degrees, dg.nw))
    if devices is None:
        ids, devs = range(parts), [dg.indptr.device] * parts
    elif devices.parts != parts:
        raise ValueError(f"the mesh has {devices.parts} shards, not {parts}")
    else:
        ids, devs = devices.shard_ids, devices.devices
    n_loc = max(-(-n // parts), 1)
    halo = halo and parts > 1
    local, send, h_max = _local_sources(indptr, indices, n, parts, n_loc, halo)
    n_src = n_loc + (send.shape[1] if send is not None else 0)
    if n_src >= 2**31:
        raise ValueError(f"{n_src} source rows overflow int32")

    def put(a, dtype, dev):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

    shards = []
    for p, dev in zip(ids, devs):
        lo, hi = min(p * n_loc, n), min((p + 1) * n_loc, n)
        e_lo, e_hi = indptr[lo], indptr[hi]
        ptr = np.full(n_loc + 1, e_hi - e_lo, dtype=np.int64)
        ptr[:hi - lo + 1] = indptr[lo:hi + 1] - e_lo
        _check_block(p, ptr, local[e_lo:e_hi], n_src)

        def rows(a):
            out = np.zeros(n_loc, np.float32)
            out[:hi - lo] = a[lo:hi]
            return out

        shards.append(Shard(
            index=p, device=dev, weights=put(rows(w), np.float32, dev),
            degrees=put(rows(deg), np.float32, dev),
            nw=put(rows(nw), np.float32, dev),
            node_mask=put(np.arange(n_loc) < hi - lo, bool, dev),
            indptr=put(ptr, np.int32, dev),
            indices=put(local[e_lo:e_hi], np.int32, dev), n_src=n_src,
            send_idx=None if send is None else put(send[p], np.int64, dev)))
    return ShardedGraph(n=n, n_loc=n_loc, parts=parts, h_max=h_max,
                        shards=shards)


def _sync_for_collective(mesh: Mesh, devices) -> None:
    """Before a collective reads tensors of ``devices``: gloo stages CUDA
    tensors through the host, so wait for their queued kernels; NCCL runs
    after the devices' current streams and needs no wait."""
    if dist.get_backend(mesh.group) != "nccl":
        synchronize(devices)


def _swap(blocks: list, mesh: Mesh) -> list:
    """All-to-all of equal blocks: ``blocks[i]`` is the i-th local shard's
    buffer of P blocks, block q bound for shard q; returns each local
    shard's received buffer, block q from shard q.

    Between shards of one process: block copies with ``Tensor.to``.  Between
    two cards torch runs the copy on the source's current stream after a
    two-way event barrier with the destination's current stream, and makes
    the destination's stream wait for the copy, so the received rows are in
    order before the next kernel on either card.  Between ranks of a process
    group: one ``all_to_all_single`` with per-rank split sizes, rank r's
    part holding, for each local shard i and each of r's shards j, the
    block from i to j.  The send buffer is staged on the rank's first
    device (where NCCL's communicator lives) and what arrives is copied to
    each shard's device (gloo stages CUDA tensors through the host).
    """
    parts, devs = mesh.parts, mesh.devices
    b = blocks[0].shape[0] // parts
    k = len(devs)
    first = mesh.shard_ids[0]

    def block(i, q):   # local shard i's block bound for shard q
        return blocks[i][q * b:(q + 1) * b]

    if parts == k:   # every shard in this process
        return [torch.cat([block(q, p).to(devs[p], non_blocking=True)
                           for q in range(parts)]) for p in range(k)]
    world, rank, home = parts // k, first // k, devs[0]
    peers = [r for r in range(world) if r != rank]
    send = torch.cat([block(i, r * k + j).to(home) for r in peers
                      for i in range(k) for j in range(k)])
    recv = torch.empty_like(send)
    splits = [0 if r == rank else k * k * b for r in range(world)]
    _sync_for_collective(mesh, devs)
    dist.all_to_all_single(recv, send, splits, splits, group=mesh.group)
    got = recv.view(len(peers), k, k, b, -1)   # (peer, its shard, ours)

    def received(j, q):
        if q // k == rank:
            return block(q - first, first + j).to(devs[j], non_blocking=True)
        return got[peers.index(q // k), q % k, j].to(devs[j])

    return [torch.cat([received(j, q) for q in range(parts)])
            for j in range(k)]


class _HaloExchange(torch.autograd.Function):
    """Pack each local shard's ``send_idx`` rows and swap them; the
    backward swaps the gradients back and adds them onto the packed rows."""

    @staticmethod
    def forward(ctx, sg, mesh, *hs):
        ctx.sg, ctx.mesh = sg, mesh
        return tuple(_swap([h.index_select(0, sh.send_idx)
                            for h, sh in zip(hs, sg.shards)], mesh))

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        sg = ctx.sg
        back = _swap([g.contiguous() for g in grads], ctx.mesh)
        return (None, None, *(
            b.new_zeros(sg.n_loc, b.shape[1]).index_add_(0, sh.send_idx, b)
            for b, sh in zip(back, sg.shards)))


def _aggregate(hs: list, sg: ShardedGraph, mesh: Mesh,
               masks: list | None = None) -> list:
    """One graph layer's neighbour sums for every local shard: the exchange,
    then K1 on each shard's ``[local | halo]`` block.  With ``masks`` the
    rows must already be zeroed by them (the sender zeroes what it sends),
    so the source mask is each shard's own over its rows and ones over the
    halo."""
    if sg.shards[0].send_idx is None:
        exts = hs
    else:
        halos = _HaloExchange.apply(sg, mesh, *hs)
        exts = [torch.cat([h, r]) for h, r in zip(hs, halos)]
    aggs = []
    for i, (x, sh) in enumerate(zip(exts, sg.shards)):
        m = None
        if masks is not None:
            m = torch.cat([masks[i], masks[i].new_ones(x.shape[0] - sg.n_loc)])
        grad = torch.is_grad_enabled() and x.requires_grad
        aggs.append(csr_aggregate(x, sh.indptr, sh.indices, m, block=True,
                                  transposed=sh.transposed() if grad
                                  else None))
    return aggs


def _weights_on(model: MWVCModel, devices) -> dict:
    """Every linear's weight and bias, in order, on each of ``devices``:
    the parameters themselves on their own device, and on each other card
    one copy per forward of all of them packed into one buffer, whose
    backward carries the gradients home (a copy per layer and shard costs
    the host 18 peer copies per card and forward)."""
    params = [t for lin in model.linears for t in (lin.weight, lin.bias)]
    home = params[0].device
    out = {home: params}
    others = [d for d in dict.fromkeys(devices) if d != home]
    if others:
        flat = torch.cat([p.reshape(-1) for p in params])
        for d in others:
            parts = flat.to(d).split([p.numel() for p in params])
            out[d] = [q.view_as(p) for q, p in zip(parts, params)]
    return out


def _layer_stack(model: MWVCModel, xs: list, sg: ShardedGraph, mesh: Mesh,
                 ws: float, compat: bool = True, masks: list | None = None,
                 x_is_node_weights: bool = False,
                 stats: list | None = None) -> list:
    """``MWVCModel.forward`` over every local shard in lockstep (each graph
    layer exchanges across all of them).

    masks: per-shard (n_loc,) 0/1 float, the masked mode (the partition is a
    superset of the live graph): rows are zeroed by the mask before every
    aggregation.  x_is_node_weights: the first graph layer's sum is NW/ws,
    with no exchange.  stats: per-shard (degrees, weights, nw); default the
    partition's.
    """
    stats = stats if stats is not None else sg.shards
    hs = list(xs)
    first_graph = True
    weights = _weights_on(model, [h.device for h in hs])
    linear = 0
    for kind in model.kinds:
        if kind == "linear":
            hs = [F.linear(h, *weights[h.device][2 * linear:2 * linear + 2])
                  for h in hs]
            linear += 1
        elif kind == "relu":
            hs = [torch.relu(h) for h in hs]
        elif kind == "sigmoid":
            hs = [torch.sigmoid(h) for h in hs]
        elif kind == "graph":
            if first_graph and x_is_node_weights:
                aggs = [(st.nw / ws).reshape(-1, 1).to(h.dtype)
                        for st, h in zip(stats, hs)]
            else:
                if masks is not None:
                    hs = [h * m[:, None] for h, m in zip(hs, masks)]
                aggs = _aggregate(hs, sg, mesh, masks)
            hs = [graph_layer(h, a, st, ws, compat)
                  for h, a, st in zip(hs, aggs, stats)]
            first_graph = False
        else:
            raise ValueError(f"unknown layer kind {kind!r}")
    return hs


def _model_on_mesh(model: MWVCModel, mesh: Mesh) -> MWVCModel:
    """The model on the mesh's first device (its parameters move to each
    shard's device inside the walk)."""
    return model.to(mesh.devices[0])


def make_sharded_forward(model: MWVCModel, mesh: Mesh, compat: bool = True,
                         masked: bool = False,
                         x_is_node_weights: bool = False,
                         precision: str = "highest"):
    """``forward(sg, ws) -> [scores (n_loc,) of each local shard]``.

    masked: the input and every aggregation are gated by the partition's
    node mask.  x_is_node_weights: the first graph layer reads NW/ws (as
    ``score_graph`` does), so a forward does two exchanges.  precision: the
    linear layers' products, as ``MWVCModel.forward`` takes it.
    """
    model = _model_on_mesh(model, mesh)

    @torch.no_grad()
    def forward(sg: ShardedGraph, ws: float) -> list:
        xs = [(sh.weights / ws).reshape(-1, 1) for sh in sg.shards]
        masks = None
        if masked:
            masks = [sh.node_mask.float() for sh in sg.shards]
            xs = [x * m[:, None] for x, m in zip(xs, masks)]
        with matmul_precision(precision):
            hs = _layer_stack(model, xs, sg, mesh, ws, compat, masks,
                              x_is_node_weights)
        return [h[:, 0] for h in hs]

    return forward


def make_sticky_sharded_forward(model: MWVCModel, mesh: Mesh,
                                compat: bool = True,
                                precision: str = "highest"):
    """The mesh counterpart of the sticky scorer's round:
    ``forward(sg, bufs, ws) -> [scores (n_loc,) of each local shard]``.

    bufs: each local shard's (4, n_loc) tensor on its device, rows W, NW,
    D, active; the masked forward's first graph layer reads NW/ws.
    precision: as ``MWVCModel.forward``.
    """
    model = _model_on_mesh(model, mesh)

    @torch.no_grad()
    def forward(sg: ShardedGraph, bufs: list, ws: float) -> list:
        masks = [b[3] for b in bufs]
        xs = [(b[0] / ws * b[3]).reshape(-1, 1) for b in bufs]
        stats = [_Stats(degrees=b[2], weights=b[0], nw=b[1]) for b in bufs]
        with matmul_precision(precision):
            hs = _layer_stack(model, xs, sg, mesh, ws, compat, masks,
                              x_is_node_weights=True, stats=stats)
        return [h[:, 0] for h in hs]

    return forward


def make_sharded_train_step(model: MWVCModel, mesh: Mesh, lr: float = 0.01,
                            momentum: float = 0.9, compat: bool = True):
    """Full-batch MSE over the real rows and one SGD(momentum) step:
    returns ``(step, optimizer)``, ``step(sg, y, ws) -> loss`` (the loss
    before the step), ``y[shard]`` the (n_loc,) labels of a shard.

    The loss is the global SSE over the global row count.  On a local mesh
    autograd flows through the exchange's copies; in a process group each
    rank differentiates the SSE of its k shards over the global count (the
    exchange's backward carries the peers' gradients) and the parameter
    gradients are summed over the ranks before the step.  The products run
    in fp32 (``matmul_precision("highest")``).  ``torch.optim.SGD`` keeps
    ``buf = momentum * buf + grad; p -= lr * buf``, the trace form of the
    JAX package's ``optax.sgd``.
    """
    model = _model_on_mesh(model, mesh)
    opt = torch.optim.SGD(model.parameters(), lr=lr, momentum=momentum)
    params = list(model.parameters())
    home = params[0].device

    def _loss_and_grads(sg: ShardedGraph, y, ws: float) -> torch.Tensor:
        xs = [(sh.weights / ws).reshape(-1, 1) for sh in sg.shards]
        outs = _layer_stack(model, xs, sg, mesh, ws, compat)
        sse, cnt = [], []
        for sid, sh, out in zip(mesh.shard_ids, sg.shards, outs):
            yp = torch.as_tensor(y[sid], dtype=torch.float32).to(sh.device)
            err = torch.where(sh.node_mask, out[:, 0] - yp, 0.0)
            sse.append((err * err).sum().to(home))
            cnt.append(sh.node_mask.sum().float().to(home))
        if mesh.group is None:
            loss = sum(sse) / sum(cnt).clamp(min=1.0)
            loss.backward()
            return loss
        total = sum(cnt).detach()
        _sync_for_collective(mesh, [home])
        dist.all_reduce(total, group=mesh.group)
        local = sum(sse)
        (local / total.clamp(min=1.0)).backward()
        _sync_for_collective(mesh, mesh.devices)
        for p in params:
            dist.all_reduce(p.grad, group=mesh.group)
        loss = local.detach().clone()
        dist.all_reduce(loss, group=mesh.group)
        return loss / total.clamp(min=1.0)

    def step(sg: ShardedGraph, y, ws: float) -> float:
        opt.zero_grad(set_to_none=True)
        with matmul_precision("highest"):
            loss = _loss_and_grads(sg, y, ws)
        opt.step()
        return float(loss.detach())

    return step, opt


def gather_scores(sg: ShardedGraph, outs: list) -> np.ndarray:
    """The (n,) scores of a local mesh's forward, in node order."""
    if len(outs) != sg.parts:
        raise ValueError("gather_scores needs every shard's output")
    return torch.cat([o.cpu() for o in outs])[:sg.n].numpy()
