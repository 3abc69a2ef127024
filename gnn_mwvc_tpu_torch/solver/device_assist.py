"""Device-assisted phase 2: the GPU exact-solves regions while the host
searches.

Between local-search batches the host extracts disjoint boundary-conditioned
sub-instances of up to ``rmax`` (<= 20) vertices around centres sampled by
model misfit (``CoreLocalSearch.extract_regions``: intra-region edges must be
covered; a region vertex with an outside non-cover neighbour is forced in
through a self-loop bit).  Kernel K4 (``ops/smallsolve_mitm.py``) solves a
batch exactly, and strictly improving assignments are re-validated against
the live cover and patched back, the whole batch in one native call
(``apply_regions`` + ``commit_patches`` of the port's copy of the core;
``core/src/localsearch.hpp``'s ``apply_region`` takes a patch that flips any
number of a region's up to 20 vertices).

On CUDA one batch is in flight at a time, all on a dedicated stream: upload
from pinned host buffers, K4, copy back into pinned buffers, record an event.
``tick()`` polls the event and never blocks, so the search (a ctypes call
that releases the GIL) runs while the GPU works.  On the CPU the batch is
solved synchronously inside ``tick()`` by K4's plain version.  A failure
raises; nothing falls back to another path.

Each ``tick()`` is the span ``assist`` (``stats["t_host_s"]`` sums its
seconds) with four children: ``assist.sample`` (centre sampling and, every
``pool_mult`` batches, the pool's refill), ``assist.extract``
(``extract_regions`` and the padding), ``assist.apply`` (one
``apply_regions`` call and ``commit_patches``) and
``assist.dispatch`` (the poll of the batch in flight and the next batch's
start; on the CPU the whole solve, ``stats["t_device_s"]`` there).
``assist`` and ``assist.dispatch`` may launch device work and open no
profiler range.
"""

from __future__ import annotations

import numpy as np
import torch

from gnn_mwvc_tpu_torch.ops.smallsolve_mitm import small_mwvc_mitm
from gnn_mwvc_tpu_torch.utils.metrics import span

__all__ = ["DeviceAssist"]


class DeviceAssist:
    def __init__(self, prob: np.ndarray, device="cuda", batch: int = 1024,
                 rmax: int = 20, seed: int = 1, misfit_frac: float = 0.75,
                 pool_mult: int = 16):
        """prob: model scores aligned with the local-search vertex ids (0.5 =
        neutral).  batch: regions per K4 launch.  rmax: region size cap
        (width 16 when <= 16, else 20).  misfit_frac: share of centres
        sampled by misfit, the rest uniform over the cover.  pool_mult:
        centres are sampled pool_mult * batch at a time (one O(n) pass) and
        consumed batch by batch."""
        self.prob = np.asarray(prob, np.float32)
        self.device = torch.device(device)
        self.batch = int(batch)
        self.rmax = int(rmax)
        self.width = 16 if self.rmax <= 16 else 20
        self.misfit_frac = float(misfit_frac)
        self.pool_mult = int(pool_mult)
        self._rng = np.random.default_rng(seed)
        self._pool = None
        self._pool_pos = 0
        self._pending = None  # (ids, ks) of the batch in flight
        self._result = None   # (best_cost, best_set) host arrays once ready
        # wide_patches: the applied patches that flip more than 16
        # vertices, which a 16-entry buffer of flipped vertices (the JAX
        # package's copy of the core) could not hold
        self.stats = {"batches": 0, "regions": 0, "patches": 0, "gain": 0,
                      "commits": 0, "wide_patches": 0, "t_host_s": 0.0,
                      "t_device_s": 0.0}
        if self.device.type == "cuda":
            shape = (self.batch, self.width)
            self._stream = torch.cuda.Stream(self.device)
            self._h_adj = torch.empty(shape, dtype=torch.int32).pin_memory()
            self._h_w = torch.empty(shape, dtype=torch.int32).pin_memory()
            self._h_cost = torch.empty(self.batch, dtype=torch.int32).pin_memory()
            self._h_set = torch.empty(self.batch, dtype=torch.int32).pin_memory()
            self._ev_start = torch.cuda.Event(enable_timing=True)
            self._ev_done = torch.cuda.Event(enable_timing=True)

    # -- centre sampling ---------------------------------------------------
    def _refill_pool(self, ls):
        """Gumbel top-k over misfit (1 - p on cover vertices) is sampling
        without replacement proportional to misfit; the rest of the pool is
        uniform over the cover.  Misfit drifts slowly (the scores are fixed,
        only the cover moves) and apply_region re-validates against the live
        cover, so a slightly stale pool is fine."""
        cur = ls.current().astype(bool)
        n = len(cur)
        want = self.batch * self.pool_mult
        p = self.prob[:n] if len(self.prob) >= n else np.full(n, 0.5,
                                                             np.float32)
        misfit = np.where(cur, 1.0 - p, 0.0).astype(np.float64)
        b_mis = int(want * self.misfit_frac)
        picks = []
        if misfit.sum() > 0 and b_mis > 0:
            g = self._rng.gumbel(size=n)
            key = np.where(misfit > 0, np.log(misfit + 1e-12) + g, -np.inf)
            k = min(b_mis, n - 1)
            picks.append(np.argpartition(-key, k)[:k])
        cover_ids = np.nonzero(cur)[0]
        b_uni = want - (len(picks[0]) if picks else 0)
        if len(cover_ids) and b_uni > 0:
            picks.append(self._rng.choice(
                cover_ids, size=min(b_uni, len(cover_ids)), replace=True))
        if not picks:
            self._pool = np.zeros(0, np.uint32)
        else:
            pool = np.concatenate(picks).astype(np.uint32)
            self._rng.shuffle(pool)
            self._pool = pool
        self._pool_pos = 0

    def _sample_centers(self, ls) -> np.ndarray:
        if self._pool is None or self._pool_pos + self.batch > len(self._pool):
            self._refill_pool(ls)
        c = self._pool[self._pool_pos:self._pool_pos + self.batch]
        self._pool_pos += self.batch
        return c

    # -- batch lifecycle ---------------------------------------------------
    def _dispatch(self, adj: np.ndarray, w: np.ndarray):
        """Start solving one (batch, width) region batch."""
        if self.device.type != "cuda":
            bc, bs = small_mwvc_mitm(torch.from_numpy(adj),
                                     torch.from_numpy(w))
            self._result = (bc.numpy(), bs.numpy())
            return
        self._h_adj.numpy()[:] = adj
        self._h_w.numpy()[:] = w
        with torch.cuda.stream(self._stream):
            self._ev_start.record()
            d_adj = self._h_adj.to(self.device, non_blocking=True)
            d_w = self._h_w.to(self.device, non_blocking=True)
            bc, bs = small_mwvc_mitm(d_adj, d_w)
            self._h_cost.copy_(bc, non_blocking=True)
            self._h_set.copy_(bs, non_blocking=True)
            self._ev_done.record()

    def _ready(self) -> bool:
        if self.device.type != "cuda":
            return True
        if not self._ev_done.query():
            return False
        self.stats["t_device_s"] += self._ev_start.elapsed_time(
            self._ev_done) / 1e3
        self._result = (self._h_cost.numpy(), self._h_set.numpy())
        return True

    def tick(self, ls) -> int:
        """Collect a finished batch (patching its improvements into ``ls``)
        and dispatch the next; returns the patches applied now.  Never
        waits for the device."""
        with span("assist", launches=True) as sp:
            applied = self._tick(ls)
        self.stats["t_host_s"] += sp.seconds
        return applied

    def _tick(self, ls) -> int:
        applied = 0
        if self._pending is not None:
            with span("assist.dispatch", launches=True):
                ready = self._ready()
            if not ready:
                return 0
            ids, ks = self._pending
            self._pending = None
            _bc, bs = self._result
            with span("assist.apply"):
                cost_before = ls.cost
                applied, wide = ls.apply_regions(ids, ks, bs)
                self.stats["wide_patches"] += wide
                if applied:
                    ls.commit_patches()
                    self.stats["commits"] += 1
                    self.stats["gain"] += cost_before - ls.cost
            self.stats["patches"] += applied
            self.stats["batches"] += 1

        with span("assist.sample"):
            centers = self._sample_centers(ls)
        if len(centers):
            with span("assist.extract"):
                ids, adj, w, ks = ls.extract_regions(centers, rmax=self.rmax)
                if len(centers) < self.batch:  # one batch shape throughout
                    pad = self.batch - len(centers)
                    adj = np.pad(adj, ((0, pad), (0, 0)))
                    w = np.pad(w, ((0, pad), (0, 0)))
                    ids = np.pad(ids, ((0, pad), (0, 0)))
                    ks = np.pad(ks, (0, pad))
                self.stats["regions"] += int((ks > 0).sum())
            with span("assist.dispatch", launches=True) as sp:
                self._dispatch(adj, w)
            if self.device.type != "cuda":  # solved in place, on the host
                self.stats["t_device_s"] += sp.seconds
            self._pending = (ids, ks)
        return applied

    def stop(self):
        """Wait for a batch still in flight (its results are dropped)."""
        if self.device.type == "cuda" and self._pending is not None:
            self._ev_done.synchronize()
        self._pending = None
