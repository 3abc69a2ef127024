"""Sticky scoring: re-score the shrinking kernel over a static device CSR.

The core never relabels node ids, so the device CSR is built once per
instance from the first snapshot, and each peel round only refreshes the
per-node arrays (W, NW, D, active) that changed:

  * ``core.sticky_deltas`` compares the live state with the scorer's host
    copies (updated in place) and emits the changed rows, up to ``k_slots``
    of them; more changes than that trigger a full upload;
  * the deltas are written into one persistent (4, n) device tensor with
    ``index_copy_``;
  * the masked forward runs (``MWVCModel.forward`` with ``source_mask``):
    removed nodes contribute nothing to any aggregation, so every live row
    aggregates exactly over its live neighbourhood.

The exception is ``fold_neighborhood``, which creates gadget nodes with edges
the static CSR does not have.  Gadget nodes get a neutral 0.5 (least
confident, decided last), and the CSR is rebuilt once gadgets exceed 2% of
the nodes it was built with.

Small rounds go per snapshot, as the JAX package's scorer routes them: once
the live kernel holds fewer than ``min_live_edges`` directed edges (the JAX
``tpu_min_edges``, 4,000,000), and on every round when the scorer's device
is the CPU (the JAX scorer's "no accelerator" case), a round drops the
sticky state and scores ``core.snapshot()`` with ``GnnScorer``; its scores
are those of a fresh forward, and fold gadgets get real scores.  On a card
that round runs on the card (K1).  On the CPU it runs the threaded C++
forward (``GnnScorer(native=True)``), as the JAX scorer's rounds do, so the
scores are the JAX package's bit for bit.  ``force_sticky=True`` keeps
every round sticky.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from gnn_mwvc_tpu_torch.graph import DeviceGraph
from gnn_mwvc_tpu_torch.models import MWVCModel, pretrained_model
from gnn_mwvc_tpu_torch.solver.pipeline import GnnScorer
from gnn_mwvc_tpu_torch.utils.metrics import span

__all__ = ["StickyGnnScorer"]


class StickyGnnScorer:
    """The ``score_core`` protocol of ``gnn_peel``:
    ``score_core(core, weight_scale) -> (ids, prob, w, deg)`` over the
    currently active nodes, gadget nodes included with prob 0.5.

    min_live_edges: below this many live directed edges
    (``core.live_edges()``) a round is scored per snapshot; the JAX
    scorer's ``tpu_min_edges``.  force_sticky: never route per snapshot.
    precision: the sticky forward's ``MWVCModel.forward`` precision.
    ``stats["rounds"]`` counts the sticky rounds and
    ``stats["legacy_rounds"]`` the per-snapshot ones, as in JAX.
    """

    # per-snapshot rounds on the CPU through the C++ forward (JAX
    # ``static_score.py:345-349``)
    native_snapshots = True

    def __init__(self, model: MWVCModel | None = None, device="cuda",
                 compat: bool = True, rebuild_gadget_frac: float = 0.02,
                 min_live_edges: int = 4_000_000, force_sticky: bool = False,
                 precision: str = "highest"):
        self.device = torch.device(device)
        self.model = (model if model is not None
                      else pretrained_model()).to(self.device)
        self.compat = compat
        self.rebuild_gadget_frac = rebuild_gadget_frac
        self.min_live_edges = min_live_edges
        self.force_sticky = force_sticky
        self.precision = precision
        self._accelerated = self.device.type != "cpu"
        self._snapshot_scorer = None
        self._state = None  # (dg, snapshot ids, built node-id size, built n)
        self._live = None   # (4, n) device tensor: rows W, NW, D, active
        self._prev = None   # host copies of the raw live state (core-owned)
        self.stats = {"rebuilds": 0, "rounds": 0, "legacy_rounds": 0,
                      "full_uploads": 0, "deltas": 0, "seconds_prep": 0.0,
                      "seconds_device": 0.0, "seconds_legacy": 0.0}

    def _rebuild(self, core):
        snap = core.snapshot()
        dg = DeviceGraph.build(snap.weights, snap.indptr, snap.indices,
                               self.device, nw=snap.nw)
        self._state = (dg, snap.ids, core.n_nodes, snap.n)
        self._live = None
        self._prev = None
        self.stats["rebuilds"] += 1

    def _needs_rebuild(self, core) -> bool:
        if self._state is None:
            return True
        _dg, _ids, built_size, built_active = self._state
        gadgets = core.n_nodes - built_size
        return gadgets > self.rebuild_gadget_frac * max(built_active, 1)

    def _refresh(self, core):
        """Bring the device copy of the live per-node state up to date."""
        _dg, ids, _bs, _ba = self._state
        k = len(ids)
        # per-round label churn is ~k/20 (the relabel trigger); k/16 slots
        # leave headroom while keeping the upload small
        k_slots = max(4096, k // 16)
        if self._prev is None:
            self._prev = (np.zeros(k, np.uint64), np.zeros(k, np.uint64),
                          np.zeros(k, np.uint32), np.zeros(k, np.uint8))
        idx = np.empty(k_slots, np.int32)
        vals = np.empty((4, k_slots), np.float32)
        vm = np.empty(k_slots, np.uint8)
        cnt = core.sticky_deltas(ids, *self._prev, idx, vals[0], vals[1],
                                 vals[2], vm)
        if self._live is None or cnt > k_slots:
            w_r, nw_r, deg_r, act8 = self._prev
            full = np.stack([w_r.astype(np.float32), nw_r.astype(np.float32),
                             deg_r.astype(np.float32),
                             act8.astype(np.float32)])
            self._live = torch.from_numpy(full).to(self.device)
            self.stats["full_uploads"] += 1
        elif cnt:
            vals[3] = vm
            self._live.index_copy_(
                1, torch.from_numpy(idx[:cnt]).to(self.device).long(),
                torch.from_numpy(vals[:, :cnt]).to(self.device))
            self.stats["deltas"] += cnt

    def _forward(self, weight_scale: float) -> np.ndarray:
        """The masked forward over the live state: (built n,) scores."""
        dg = self._state[0]
        live = self._live
        mask = live[3]
        dg_live = dataclasses.replace(dg, weights=live[0], nw=live[1],
                                      degrees=live[2])
        x = (live[0] / weight_scale * mask).reshape(-1, 1)
        out = self.model(x, dg_live, weight_scale, compat=self.compat,
                         precision=self.precision, x_is_node_weights=True,
                         source_mask=mask)
        return out[:, 0].cpu().numpy()

    def _per_snapshot(self, core) -> bool:
        """Whether this round leaves the sticky path (JAX
        ``static_score.py:365-369``)."""
        return not self.force_sticky and (
            not self._accelerated
            or core.live_edges() < self.min_live_edges)

    def _score_snapshot(self, core, weight_scale: float):
        """One forward over the compacted snapshot: on the scorer's card,
        or on the host; the sticky state is dropped (rebuilt if a later
        round is sticky again).  ``GnnScorer``'s spans time it."""
        self._state = self._live = self._prev = None
        if self._snapshot_scorer is None:
            self._snapshot_scorer = GnnScorer(
                self.model, self.device, self.compat,
                native=self.native_snapshots)
        inner = self._snapshot_scorer
        before = inner.seconds
        snap = inner.snapshot(core)
        prob = inner(snap, weight_scale)
        self.stats["legacy_rounds"] += 1
        self.stats["seconds_legacy"] += inner.seconds - before
        return snap.ids, prob, snap.weights, snap.deg

    @torch.no_grad()
    def score_core(self, core, weight_scale: float):
        """Spans: ``score.refresh`` (a rebuild where due, then the live
        state's upload) and ``score.forward`` (the masked forward and its
        copy back); a per-snapshot round has ``GnnScorer``'s."""
        if self._per_snapshot(core):
            return self._score_snapshot(core, weight_scale)
        with span("score.refresh", launches=True) as refresh:
            if self._needs_rebuild(core):
                self._rebuild(core)
            self._refresh(core)
        with span("score.forward", launches=True) as fwd:
            prob = self._forward(weight_scale)
        t0 = time.perf_counter()
        _dg, ids, built_size, _ba = self._state
        w_r, _nw_r, deg_r, act8 = self._prev
        rows = np.nonzero(act8)[0]
        out_ids = ids[rows]
        out_prob = prob[rows]
        out_w = w_r[rows]
        out_deg = deg_r[rows]
        # gadget nodes created by folds after the build: neutral scores
        # (min(p, 1-p) = 0.5 sorts least confident -> decided last)
        if core.n_nodes > built_size:
            act_g, w_g, deg_g = core.node_range(built_size, core.n_nodes)
            rows_g = np.nonzero(act_g)[0]
            if len(rows_g):
                out_ids = np.concatenate(
                    [out_ids, (built_size + rows_g).astype(np.uint32)])
                out_prob = np.concatenate(
                    [out_prob, np.full(len(rows_g), 0.5, np.float32)])
                out_w = np.concatenate([out_w, w_g[rows_g]])
                out_deg = np.concatenate([out_deg, deg_g[rows_g]])
        self.stats["rounds"] += 1
        self.stats["seconds_prep"] += refresh.seconds + (
            time.perf_counter() - t0)
        self.stats["seconds_device"] += fwd.seconds
        return out_ids, out_prob, out_w, out_deg
