"""ctypes bindings for the native MWVC host core.

The reversible graph, the reduction rules, branch-and-reduce, local search
and unfold are C++ host code that this package shares with the JAX package
and does not port: g++ compiles ``gnn_mwvc_tpu/core/src/capi.cpp`` (with the
headers beside it) into ``gnn_mwvc_tpu_torch/_build/libmwvc_core.so`` at
first use.  The sources are only read; no Python of the JAX package runs and
nothing is written next to them.  These bindings cover what the port calls:
the kernelisation engine (``CoreSolver``), the phase-2 local search
(``CoreLocalSearch``) and two orderings.
"""

from __future__ import annotations

import ctypes as ct
import os
import subprocess
import threading

import numpy as np

__all__ = ["CoreSolver", "CoreLocalSearch", "Snapshot",
           "confidence_order_native", "cluster_order"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(os.path.dirname(_PKG), "gnn_mwvc_tpu", "core", "src")
LIB_PATH = os.path.join(_PKG, "_build", "libmwvc_core.so")
_SOURCES = ("capi.cpp", "revgraph.hpp", "solver.hpp", "localsearch.hpp",
            "heuristics.hpp", "baselines.hpp", "cpuforward.hpp")
_GXX_FLAGS = ["-std=c++17", "-O3", "-march=native", "-DNDEBUG", "-fPIC",
              "-shared"]
_LOCK = threading.Lock()
_lib = None

u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")

_c = ct.c_void_p
_SIGNATURES = {
    "mwvc_create": ([ct.c_uint32, u32p, ct.c_uint64, u32p, u32p,
                     ct.c_uint32], _c),
    "mwvc_destroy": ([_c], None),
    "mwvc_reduce": ([_c, ct.c_int], None),
    "mwvc_n_nodes": ([_c], ct.c_uint32),
    "mwvc_n_org": ([_c], ct.c_uint32),
    "mwvc_active_count": ([_c], ct.c_uint32),
    "mwvc_cost": ([_c], ct.c_uint64),
    "mwvc_timestamp": ([_c], ct.c_uint64),
    "mwvc_label_count": ([_c], ct.c_uint64),
    "mwvc_reset_label_count": ([_c], None),
    "mwvc_counters": ([_c, u64p], None),
    "mwvc_decided": ([_c, ct.c_uint32], ct.c_int),
    "mwvc_snapshot_edges": ([_c], ct.c_uint64),
    "mwvc_snapshot": ([_c, u32p, u32p, u64p, u32p, u64p, u32p], ct.c_uint32),
    "mwvc_solve_small_components": ([_c, ct.c_uint32], ct.c_uint32),
    "mwvc_cluster_order": ([ct.c_uint32, u64p, u32p, ct.c_uint32, u32p],
                           None),
    "mwvc_confidence_order": ([ct.c_uint32, f32p, u64p, u32p, ct.c_double,
                               u32p], None),
    "mwvc_peel": ([_c, u32p, f32p, ct.c_uint64, ct.c_int, ct.c_uint32],
                  ct.c_uint64),
    "mwvc_unfold": ([_c, ct.c_uint64], None),
    "mwvc_get_solution": ([_c, i8p], None),
    "mwvc_apply_cover": ([_c, u32p, u8p, ct.c_uint32], None),
    "mwvc_sticky_deltas": ([_c, ct.c_uint32, u32p, u64p, u64p, u32p, u8p,
                            i32p, f32p, f32p, f32p, u8p, ct.c_uint32],
                           ct.c_uint32),
    "mwvc_node_range": ([_c, ct.c_uint32, ct.c_uint32, u8p, u64p, u32p],
                        None),
    "mwvc_ls_create": ([ct.c_uint32, u32p, ct.c_uint32, u32p, u32p, u8p], _c),
    "mwvc_ls_destroy": ([_c], None),
    "mwvc_ls_search": ([_c, ct.c_uint32, ct.c_double], ct.c_int),
    "mwvc_ls_cost": ([_c], ct.c_uint64),
    "mwvc_ls_best_cost": ([_c], ct.c_uint64),
    "mwvc_ls_best_seen": ([_c], ct.c_uint64),
    "mwvc_ls_steps": ([_c], ct.c_uint64),
    "mwvc_ls_forget": ([_c, ct.c_double], None),
    "mwvc_ls_restore_best": ([_c], None),
    "mwvc_ls_perturb": ([_c, ct.c_uint32, ct.c_uint64], None),
    "mwvc_ls_perturb_guided": ([_c, ct.c_uint32, ct.c_uint64, f32p,
                                ct.c_uint32], None),
    "mwvc_ls_get_best": ([_c, u8p], None),
    "mwvc_ls_get_current": ([_c, u8p], None),
    "mwvc_ls_extract_regions": ([_c, u32p, ct.c_uint32, ct.c_uint32,
                                 ct.c_uint32, u32p, i32p, i32p, u8p],
                                ct.c_uint32),
    "mwvc_ls_apply_region": ([_c, ct.c_uint32, u32p, ct.c_uint32], ct.c_int),
    "mwvc_ls_commit_patches": ([_c], ct.c_int),
}


def build() -> str:
    """Compile the core into LIB_PATH unless it is newer than its sources.
    Built to a temporary file and renamed, so a process that already mapped
    the old library keeps a valid file."""
    srcs = [os.path.join(SRC_DIR, s) for s in _SOURCES]
    if os.path.exists(LIB_PATH):
        lib_mtime = os.path.getmtime(LIB_PATH)
        if all(os.path.getmtime(p) <= lib_mtime for p in srcs):
            return LIB_PATH
    os.makedirs(os.path.dirname(LIB_PATH), exist_ok=True)
    tmp = LIB_PATH + f".tmp.{os.getpid()}"
    out = subprocess.run(["g++", *_GXX_FLAGS, "-o", tmp, srcs[0]],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"g++ failed ({out.returncode}):\n"
                           f"{(out.stdout + out.stderr)[-4000:]}")
    os.replace(tmp, LIB_PATH)
    return LIB_PATH


def _load():
    global _lib
    with _LOCK:
        if _lib is None:
            lib = ct.CDLL(build())
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
    return _lib


def _split_edges(edges):
    edges = np.asarray(edges, dtype=np.uint32).reshape(-1, 2)
    return (len(edges), np.ascontiguousarray(edges[:, 0]),
            np.ascontiguousarray(edges[:, 1]))


class Snapshot:
    """Compacted active-subgraph CSR (host arrays)."""

    __slots__ = ("ids", "weights", "nw", "deg", "indptr", "indices")

    def __init__(self, ids, weights, nw, deg, indptr, indices):
        self.ids = ids
        self.weights = weights
        self.nw = nw
        self.deg = deg
        self.indptr = indptr
        self.indices = indices

    @property
    def n(self):
        return len(self.ids)


class CoreSolver:
    """The kernelisation engine over one graph instance."""

    def __init__(self, weights, edges, num_rules=7):
        lib = _load()
        self._lib = lib
        weights = np.ascontiguousarray(weights, dtype=np.uint32)
        m, eu, ev = _split_edges(edges)
        self._h = lib.mwvc_create(len(weights), weights, m, eu, ev, num_rules)
        self.n_org = int(lib.mwvc_n_org(self._h))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.mwvc_destroy(self._h)
            self._h = None

    @property
    def n_nodes(self):
        """Current node-id space size (grows as folds append gadget nodes)."""
        return int(self._lib.mwvc_n_nodes(self._h))

    @property
    def active_count(self):
        return int(self._lib.mwvc_active_count(self._h))

    @property
    def cost(self):
        return int(self._lib.mwvc_cost(self._h))

    @property
    def timestamp(self):
        return int(self._lib.mwvc_timestamp(self._h))

    @property
    def label_count(self):
        return int(self._lib.mwvc_label_count(self._h))

    def reset_label_count(self):
        self._lib.mwvc_reset_label_count(self._h)

    @property
    def counters(self):
        out = np.zeros(8, dtype=np.uint64)
        self._lib.mwvc_counters(self._h, out)
        return out

    def decided(self, u):
        return int(self._lib.mwvc_decided(self._h, u))

    def reduce(self, critical=None):
        if critical is None:
            critical = self.active_count < 1000
        self._lib.mwvc_reduce(self._h, int(critical))

    def snapshot(self) -> Snapshot:
        n_act = self.active_count
        e = int(self._lib.mwvc_snapshot_edges(self._h))
        ids = np.empty(n_act, dtype=np.uint32)
        wts = np.empty(n_act, dtype=np.uint32)
        nw = np.empty(n_act, dtype=np.uint64)
        deg = np.empty(n_act, dtype=np.uint32)
        indptr = np.empty(n_act + 1, dtype=np.uint64)
        indices = np.empty(e, dtype=np.uint32)
        k = self._lib.mwvc_snapshot(self._h, ids, wts, nw, deg, indptr, indices)
        assert k == n_act
        if n_act == 0:
            indptr[0] = 0
        return Snapshot(ids, wts, nw, deg, indptr, indices)

    def sticky_deltas(self, ids, prev_w, prev_nw, prev_deg, prev_act,
                      out_idx, out_vw, out_vnw, out_vdeg, out_vm):
        """One-pass live-state delta refresh for sticky scoring: updates the
        raw prev arrays IN PLACE and emits up to len(out_idx) changed rows
        as f32 device deltas.  Returns the total changed count (more than
        len(out_idx) means the caller should upload the updated prev arrays
        in full)."""
        return int(self._lib.mwvc_sticky_deltas(
            self._h, len(ids), ids, prev_w, prev_nw, prev_deg, prev_act,
            out_idx, out_vw, out_vnw, out_vdeg, out_vm, len(out_idx)))

    def node_range(self, lo: int, hi: int):
        """Live (active, w, deg) over ids [lo, hi): the fold-gadget tail
        created after a sticky build; O(hi - lo)."""
        k = max(hi - lo, 0)
        act = np.empty(k, np.uint8)
        w = np.empty(k, np.uint64)
        deg = np.empty(k, np.uint32)
        if k:
            self._lib.mwvc_node_range(self._h, lo, hi, act, w, deg)
        return act, w, deg

    def solve_small_components(self, limit=75):
        return int(self._lib.mwvc_solve_small_components(self._h, limit))

    def peel(self, order, prob, relable_interval=-1, use_gnn=True,
             use_reductions=True):
        order = np.ascontiguousarray(order, dtype=np.uint32)
        prob = np.ascontiguousarray(prob, dtype=np.float32)
        flags = (1 if use_gnn else 0) | (2 if use_reductions else 0)
        return int(self._lib.mwvc_peel(self._h, order, prob, len(order),
                                       relable_interval, flags))

    def unfold(self, t=0):
        self._lib.mwvc_unfold(self._h, t)

    def solution(self):
        out = np.empty(self.n_org, dtype=np.int8)
        self._lib.mwvc_get_solution(self._h, out)
        return out

    def apply_cover(self, ids, vals):
        ids = np.ascontiguousarray(ids, dtype=np.uint32)
        vals = np.ascontiguousarray(vals, dtype=np.uint8)
        self._lib.mwvc_apply_cover(self._h, ids, vals, len(ids))


class CoreLocalSearch:
    """FastWVC-style anytime local search over a flat graph."""

    def __init__(self, weights, edges, initial):
        lib = _load()
        self._lib = lib
        weights = np.ascontiguousarray(weights, dtype=np.uint32)
        m, eu, ev = _split_edges(edges)
        s0 = np.ascontiguousarray(initial, dtype=np.uint8)
        self.n = len(weights)
        self._h = lib.mwvc_ls_create(self.n, weights, m, eu, ev, s0)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.mwvc_ls_destroy(self._h)
            self._h = None

    def search(self, iterations, time_budget):
        return bool(self._lib.mwvc_ls_search(self._h, iterations, time_budget))

    def forget(self, scale=0.3):
        """Decay the learned edge weights and rebuild the scores."""
        self._lib.mwvc_ls_forget(self._h, float(scale))

    def restore_best(self):
        """Jump back to the best cover so far, keeping the learned edge
        weights and ages."""
        self._lib.mwvc_ls_restore_best(self._h)

    def perturb(self, k, seed):
        """Remove k random cover vertices and repair greedily;
        deterministic per seed."""
        self._lib.mwvc_ls_perturb(self._h, int(k), int(seed))

    def perturb_guided(self, k, seed, bias):
        """As ``perturb``, with removal targets accepted with probability
        bias[u]; deterministic per seed."""
        bias = np.ascontiguousarray(bias, dtype=np.float32)
        self._lib.mwvc_ls_perturb_guided(self._h, int(k), int(seed), bias,
                                         len(bias))

    def current(self):
        out = np.empty(self.n, dtype=np.uint8)
        self._lib.mwvc_ls_get_current(self._h, out)
        return out

    def best(self):
        out = np.empty(self.n, dtype=np.uint8)
        self._lib.mwvc_ls_get_best(self._h, out)
        return out

    def extract_regions(self, centers, rmax=14):
        """Disjoint boundary-conditioned exact sub-instances (<= rmax <= 20
        vertices) around the given centres, packed for kernel K4.  Returns
        (ids (B, W) u32, adj (B, W) i32 bitmasks, w (B, W) i32, k (B,) u8)
        with W = 16 when rmax <= 16 else 20; rows with k == 0 are empty
        (claimed centre)."""
        centers = np.ascontiguousarray(centers, dtype=np.uint32)
        b = len(centers)
        width = 16 if rmax <= 16 else 20
        ids = np.zeros((b, width), np.uint32)
        adj = np.zeros((b, width), np.int32)
        w = np.zeros((b, width), np.int32)
        k = np.zeros(b, np.uint8)
        self._lib.mwvc_ls_extract_regions(
            self._h, centers, b, int(rmax), width, ids.reshape(-1),
            adj.reshape(-1), w.reshape(-1), k)
        return ids, adj, w, k

    def apply_region(self, k, ids, new_mask):
        """Validate and apply a device-proved region assignment; True if
        applied.  Call commit_patches() after a batch of patches."""
        ids = np.ascontiguousarray(ids, dtype=np.uint32)
        return bool(self._lib.mwvc_ls_apply_region(
            self._h, int(k), ids, int(new_mask)))

    def commit_patches(self):
        """Snapshot the best cover after a batch of patches; True if the
        best improved."""
        return bool(self._lib.mwvc_ls_commit_patches(self._h))

    @property
    def cost(self):
        return int(self._lib.mwvc_ls_cost(self._h))

    @property
    def best_cost(self):
        return int(self._lib.mwvc_ls_best_cost(self._h))

    @property
    def best_seen(self):
        return int(self._lib.mwvc_ls_best_seen(self._h))

    @property
    def steps(self):
        return int(self._lib.mwvc_ls_steps(self._h))


def confidence_order_native(prob, weights, deg, eps):
    """Native confidence sort (capi.cpp mwvc_confidence_order)."""
    lib = _load()
    prob = np.ascontiguousarray(prob, dtype=np.float32)
    weights = np.ascontiguousarray(weights, dtype=np.uint64)
    deg = np.ascontiguousarray(deg, dtype=np.uint32)
    out = np.empty(len(prob), dtype=np.uint32)
    lib.mwvc_confidence_order(len(prob), prob, weights, deg, float(eps), out)
    return out


def cluster_order(indptr, indices, cluster_size=128):
    """Window-locality vertex order: chained BFS balls of cluster_size."""
    lib = _load()
    n = len(indptr) - 1
    indptr = np.ascontiguousarray(indptr, dtype=np.uint64)
    indices = np.ascontiguousarray(indices, dtype=np.uint32)
    perm = np.empty(n, dtype=np.uint32)
    lib.mwvc_cluster_order(n, indptr, indices, cluster_size, perm)
    return perm
