"""ctypes bindings for the native MWVC host core.

The reversible graph, the reduction rules, branch-and-reduce, local search
and unfold are C++ host code.  The port owns its copy of it
(``gnn_mwvc_tpu_torch/core/src/``): the JAX package's sources, byte for
byte, apart from two repairs.  In ``localsearch.hpp``, ``apply_region``'s
buffer of flipped vertices holds all 32 a patch mask can name, where the
JAX copy holds 16.  In ``revgraph.hpp`` and ``solver.hpp``, the
independent-neighbourhood fold is made only when an order-free check agrees
that N(u) is independent (a fold gadget's adjacency list is not sorted, and
the JAX copy's sorted merge can pass a dependent N(u)); the refused folds
are counted (``CoreSolver.dependent_folds``).  In ``solver.hpp`` the two
meta rules first test exact weight bounds, and build and solve their small
instance only where the bounds leave the outcome open: every decision is
the JAX copy's (``CoreSolver.meta_counts`` counts the instances).  Two
entries are the port's alone: ``capi.cpp``'s ``mwvc_ls_apply_regions``
applies a whole region batch in one call
(``CoreLocalSearch.apply_regions``), and ``mwvc_meta_counts`` reads those
counts.  g++ compiles
``core/src/capi.cpp`` (with the headers beside it) into
``gnn_mwvc_tpu_torch/_build/libmwvc_core.so`` at first use;
``MWVC_CORE_LIB`` names a library to load instead, and then nothing is built
(``core/sanitize.sh`` passes a sanitizer build that way).  These bindings
cover what the port calls: the kernelisation engine (``CoreSolver``), the
phase-2 local search (``CoreLocalSearch``), two orderings, the CSR relabel
behind ``Graph.reorder`` (``relabel_csr``), the threaded CPU forward that
scores snapshots on the host (``cpu_forward_native``), and the
constructions and baseline solvers behind the approximation solver, the
ablation grid and ``mwvc-baseline-torch``.  Not bound: the windowed-MXU
plans (``pair_order``, ``blocked_pack``), which K1 replaced.
"""

from __future__ import annotations

import ctypes as ct
import os
import subprocess
import threading

import numpy as np

__all__ = ["CoreSolver", "CoreLocalSearch", "Snapshot",
           "bfs_order", "confidence_order_native", "cluster_order",
           "cpu_forward_native", "improve_cover", "relabel_csr",
           "approx_cover", "greedy_cover", "baseline_solve", "BASELINE_IDS"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "core", "src")
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
    "mwvc_is_active": ([_c, ct.c_uint32], ct.c_int),
    "mwvc_decided": ([_c, ct.c_uint32], ct.c_int),
    "mwvc_select_node": ([_c, ct.c_uint32], None),
    "mwvc_select_neighborhood": ([_c, ct.c_uint32], None),
    "mwvc_snapshot_edges": ([_c], ct.c_uint64),
    "mwvc_snapshot": ([_c, u32p, u32p, u64p, u32p, u64p, u32p], ct.c_uint32),
    "mwvc_solve_small_components": ([_c, ct.c_uint32], ct.c_uint32),
    "mwvc_bulk_begin": ([_c], None),
    "mwvc_bulk_r1": ([_c, u32p, ct.c_uint32], ct.c_uint32),
    "mwvc_bulk_twins": ([_c, u32p, ct.c_uint32], ct.c_uint32),
    "mwvc_bulk_r5": ([_c, u32p, ct.c_uint32], ct.c_uint32),
    "mwvc_labels_from_model": ([_c], ct.c_uint64),
    "mwvc_mistakes_from_model": ([_c], ct.c_uint64),
    "mwvc_dependent_folds": ([_c], ct.c_uint64),
    "mwvc_meta_counts": ([_c, u64p], None),
    "mwvc_neighbors_independent": ([_c, ct.c_uint32, ct.c_int], ct.c_int),
    "mwvc_bfs_order": ([ct.c_uint32, u64p, u32p, u32p], None),
    "mwvc_cluster_order": ([ct.c_uint32, u64p, u32p, ct.c_uint32, u32p],
                           None),
    "mwvc_relabel_csr": ([ct.c_uint32, u64p, u32p, u32p, u64p, u32p], None),
    "mwvc_cpu_forward": ([ct.c_uint32, u64p, u32p, u32p, u64p, u32p,
                          ct.c_float, ct.c_uint32, i8p, i32p, f32p, f32p,
                          ct.c_uint32], None),
    "mwvc_confidence_order": ([ct.c_uint32, f32p, u64p, u32p, ct.c_double,
                               u32p], None),
    "mwvc_peel": ([_c, u32p, f32p, ct.c_uint64, ct.c_int, ct.c_uint32],
                  ct.c_uint64),
    "mwvc_unfold": ([_c, ct.c_uint64], None),
    "mwvc_get_solution": ([_c, i8p], None),
    "mwvc_preview_solution": ([_c, i8p], None),
    "mwvc_apply_cover": ([_c, u32p, u8p, ct.c_uint32], None),
    "mwvc_sticky_deltas": ([_c, ct.c_uint32, u32p, u64p, u64p, u32p, u8p,
                            i32p, f32p, f32p, f32p, u8p, ct.c_uint32],
                           ct.c_uint32),
    "mwvc_node_arrays": ([_c, u8p, u64p, u64p, u32p], None),
    "mwvc_live_edges": ([_c], ct.c_uint64),
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
    "mwvc_ls_apply_regions": ([_c, ct.c_uint32, ct.c_uint32, u32p, u8p, i32p,
                               ct.POINTER(ct.c_uint32)], ct.c_uint32),
    "mwvc_ls_commit_patches": ([_c], ct.c_int),
    "mwvc_ls_get_dscores": ([_c, u32p], None),
    "mwvc_ls_rebuild_scores": ([_c], None),
    "mwvc_improve_cover": ([ct.c_uint32, u32p, ct.c_uint64, u32p, u32p, u8p],
                           ct.c_uint64),
    "mwvc_approx_construct": ([ct.c_uint32, u32p, ct.c_uint64, u32p, u32p,
                               u8p], ct.c_uint64),
    "mwvc_greedy_construct": ([ct.c_uint32, u32p, ct.c_uint64, u32p, u32p,
                               u8p], ct.c_uint64),
    "mwvc_baseline_solve": ([ct.c_int, ct.c_uint32, u32p, ct.c_uint64, u32p,
                             u32p, ct.c_uint32, ct.c_double, ct.c_int, u8p,
                             ct.POINTER(ct.c_double)], ct.c_uint64),
    "mwvc_hils_solve": ([ct.c_uint32, u32p, ct.c_uint64, u32p, u32p,
                         ct.c_uint32, ct.c_double, ct.c_uint64, ct.c_int,
                         ct.c_int, ct.c_int, ct.c_int, ct.c_uint64, u8p,
                         ct.POINTER(ct.c_double)], ct.c_uint64),
}


def build() -> str:
    """Compile the core into LIB_PATH unless it is newer than its sources,
    or return ``$MWVC_CORE_LIB`` unbuilt when it is set.  Built to a
    temporary file and renamed, so a process that already mapped the old
    library keeps a valid file."""
    override = os.environ.get("MWVC_CORE_LIB")
    if override:
        return override
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

    def is_active(self, u):
        return bool(self._lib.mwvc_is_active(self._h, u))

    def decided(self, u):
        return int(self._lib.mwvc_decided(self._h, u))

    def reduce(self, critical=None):
        if critical is None:
            critical = self.active_count < 1000
        self._lib.mwvc_reduce(self._h, int(critical))

    def select_node(self, u):
        self._lib.mwvc_select_node(self._h, u)

    def select_neighborhood(self, u):
        self._lib.mwvc_select_neighborhood(self._h, u)

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

    def begin_bulk_pass(self):
        """Start a bulk-apply pass: until it ends the core tracks which
        nodes' 1-hop instances drift from the snapshot the device masks
        were computed on (see bulk_r5)."""
        self._lib.mwvc_bulk_begin(self._h)

    def bulk_r1(self, ids):
        """Apply rule 1 to the candidates; the core re-checks each against
        the live state.  Returns the count applied."""
        ids = np.ascontiguousarray(ids, dtype=np.uint32)
        return int(self._lib.mwvc_bulk_r1(self._h, ids, len(ids)))

    def bulk_twins(self, pairs):
        """Fold candidate twin pairs ((k, 2) ids); the core re-checks exact
        twinness.  Returns the count applied."""
        pairs = np.ascontiguousarray(pairs, dtype=np.uint32).reshape(-1)
        return int(self._lib.mwvc_bulk_twins(self._h, pairs, len(pairs) // 2))

    def bulk_r5(self, ids):
        """Apply device-proved rule-5 verdicts to clean candidates only: the
        core skips any whose instance changed since begin_bulk_pass."""
        ids = np.ascontiguousarray(ids, dtype=np.uint32)
        return int(self._lib.mwvc_bulk_r5(self._h, ids, len(ids)))

    def live_rows(self, ids):
        """Live (active, w, nw, deg) of the nodes ``ids``, in their order:
        one pass in the core, O(len(ids))."""
        ids = np.ascontiguousarray(ids, dtype=np.uint32)
        k = len(ids)
        act = np.zeros(k, np.uint8)
        w = np.zeros(k, np.uint64)   # u64: twin folds sum weights past 2^32
        nw = np.zeros(k, np.uint64)
        deg = np.zeros(k, np.uint32)
        # the delta pass against all-zero rows writes every live value into
        # them; with no delta slots it emits nothing
        none_i, none_f, none_m = (np.empty(0, np.int32),
                                  np.empty(0, np.float32),
                                  np.empty(0, np.uint8))
        self._lib.mwvc_sticky_deltas(self._h, k, ids, w, nw, deg, act,
                                     none_i, none_f, none_f, none_f, none_m, 0)
        return act, w, nw, deg

    def node_arrays(self):
        """Live (active, w, nw, deg) over the whole node-id space [0, size):
        an O(n) flat copy, no CSR walk and no compaction."""
        n = self.n_nodes
        active = np.empty(n, np.uint8)
        w = np.empty(n, np.uint64)   # u64: twin folds sum weights past 2^32
        nw = np.empty(n, np.uint64)
        deg = np.empty(n, np.uint32)
        self._lib.mwvc_node_arrays(self._h, active, w, nw, deg)
        return active, w, nw, deg

    def live_edges(self) -> int:
        """Directed live-edge count (the sum of active degrees), O(n)."""
        return int(self._lib.mwvc_live_edges(self._h))

    def solve_small_components(self, limit=75):
        return int(self._lib.mwvc_solve_small_components(self._h, limit))

    def peel(self, order, prob, relable_interval=-1, use_gnn=True,
             use_reductions=True):
        order = np.ascontiguousarray(order, dtype=np.uint32)
        prob = np.ascontiguousarray(prob, dtype=np.float32)
        flags = (1 if use_gnn else 0) | (2 if use_reductions else 0)
        return int(self._lib.mwvc_peel(self._h, order, prob, len(order),
                                       relable_interval, flags))

    @property
    def labels_from_model(self):
        return int(self._lib.mwvc_labels_from_model(self._h))

    @property
    def mistakes_from_model(self):
        """Peel entries skipped, over all peels, because the core had
        already decided the vertex against the model's label."""
        return int(self._lib.mwvc_mistakes_from_model(self._h))

    @property
    def dependent_folds(self):
        """Independent-neighbourhood folds refused, over the whole solve,
        because N(u) was not independent though the sorted merge passed it
        (the JAX package's copy of the core makes those folds)."""
        return int(self._lib.mwvc_dependent_folds(self._h))

    @property
    def meta_counts(self):
        """The small instances the two meta rules would build, over the
        whole solve: ``meta_evals``, of which ``meta_bound_decided`` a
        weight bound decided unbuilt and ``meta_solved`` were solved."""
        out = np.zeros(3, dtype=np.uint64)
        self._lib.mwvc_meta_counts(self._h, out)
        return dict(zip(("meta_evals", "meta_bound_decided", "meta_solved"),
                        (int(x) for x in out)))

    def neighbors_independent(self, u, exact=True):
        """Whether no two live neighbours of ``u`` are adjacent: the
        order-free check, or with ``exact=False`` the sorted merge that the
        fold rule tries first (wrong-true on a gadget's unsorted list)."""
        return bool(self._lib.mwvc_neighbors_independent(self._h, u,
                                                         int(exact)))

    def unfold(self, t=0):
        self._lib.mwvc_unfold(self._h, t)

    def solution(self):
        out = np.empty(self.n_org, dtype=np.int8)
        self._lib.mwvc_get_solution(self._h, out)
        return out

    def preview_solution(self):
        """The original-vertex solution as if unfolded now; the state is
        kept."""
        out = np.empty(self.n_org, dtype=np.int8)
        self._lib.mwvc_preview_solution(self._h, out)
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

    def apply_regions(self, ids, ks, masks):
        """``apply_region`` over a whole batch in one native call: row i of
        ``ids`` (B, W) u32 and ``ks`` (B,) u8, as ``extract_regions``
        returns them, with ``masks[i]`` of the solver's (B,) int32 answer;
        rows in order, rows with k == 0 skipped.  Returns (applied, wide):
        the patches applied, and how many of them flipped more than 16
        vertices of the live cover.  Call commit_patches() after."""
        ids = np.ascontiguousarray(ids, dtype=np.uint32)
        ks = np.ascontiguousarray(ks, dtype=np.uint8)
        masks = np.ascontiguousarray(masks, dtype=np.int32)
        if ids.ndim != 2 or not ks.shape == masks.shape == ids.shape[:1]:
            raise ValueError(f"ids (B, W), ks (B,) and masks (B,) expected, "
                             f"got {ids.shape}, {ks.shape}, {masks.shape}")
        b, stride = ids.shape
        if b and (int(ks.max()) > stride or int(ids.max()) >= self.n):
            raise ValueError("a region size over the row width, or a vertex "
                             "id out of range")
        wide = ct.c_uint32(0)
        applied = self._lib.mwvc_ls_apply_regions(
            self._h, b, stride, ids, ks, masks, ct.byref(wide))
        return int(applied), int(wide.value)

    def commit_patches(self):
        """Snapshot the best cover after a batch of patches; True if the
        best improved."""
        return bool(self._lib.mwvc_ls_commit_patches(self._h))

    def dscores(self):
        out = np.empty(self.n, dtype=np.uint32)
        self._lib.mwvc_ls_get_dscores(self._h, out)
        return out

    def rebuild_scores(self):
        """Rebuild the dscores, scores and heap from scratch (patching keeps
        them up to date incrementally; this is the check)."""
        self._lib.mwvc_ls_rebuild_scores(self._h)

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


def bfs_order(indptr, indices):
    """Pseudo-Cuthill-McKee vertex order: perm[i] = the old id placed at new
    position i."""
    lib = _load()
    n = len(indptr) - 1
    indptr = np.ascontiguousarray(indptr, dtype=np.uint64)
    indices = np.ascontiguousarray(indices, dtype=np.uint32)
    perm = np.empty(n, dtype=np.uint32)
    lib.mwvc_bfs_order(n, indptr, indices, perm)
    return perm


def cluster_order(indptr, indices, cluster_size=128):
    """Window-locality vertex order: chained BFS balls of cluster_size."""
    lib = _load()
    n = len(indptr) - 1
    indptr = np.ascontiguousarray(indptr, dtype=np.uint64)
    indices = np.ascontiguousarray(indices, dtype=np.uint32)
    perm = np.empty(n, dtype=np.uint32)
    lib.mwvc_cluster_order(n, indptr, indices, cluster_size, perm)
    return perm


def relabel_csr(indptr, indices, perm):
    """The symmetric CSR under a vertex permutation (perm[i] = the old id
    placed at new position i), each row's indices sorted; returns (indptr,
    indices) as int64."""
    lib = _load()
    n = len(indptr) - 1
    perm = np.ascontiguousarray(perm, dtype=np.uint32)
    # the native loop indexes by perm unchecked
    if len(perm) != n or (n and (np.bincount(perm, minlength=n) != 1).any()):
        raise ValueError(f"perm is not a permutation of {n} vertices")
    indptr = np.ascontiguousarray(indptr, dtype=np.uint64)
    indices = np.ascontiguousarray(indices, dtype=np.uint32)
    out_indptr = np.empty(n + 1, dtype=np.uint64)
    out_indices = np.empty(len(indices), dtype=np.uint32)
    lib.mwvc_relabel_csr(n, indptr, indices, perm, out_indptr, out_indices)
    return out_indptr.astype(np.int64), out_indices.astype(np.int64)


_KIND_CODES = {"graph": 0, "linear": 1, "relu": 2, "sigmoid": 3}
_NATIVE_WIDTH = 36  # cpuforward.hpp's row stride: no layer may be wider


def _pack_model(model):
    """(kinds i8, dims i32, params f32) blobs of an ``MWVCModel`` for
    ``mwvc_cpu_forward``: each linear layer's (din, dout) and its weight,
    row-major (din, dout) as the JAX package stores it, then its bias.

    The blobs are kept on the model beside every parameter (the object
    itself, so its address cannot be reused) and its version counter, so
    a parameter changed in place (an optimiser step, ``load_state_dict``,
    ``copy_``) or replaced packs again.  A write through ``.data``
    bypasses the version counter and is not seen."""
    params = list(model.parameters())
    key = [(p, p._version) for p in params]
    hit = getattr(model, "_native_pack", None)
    if hit is not None and len(hit[0]) == len(key) and all(
            p is q and v == w for (p, v), (q, w) in zip(hit[0], key)):
        return hit[1]
    kinds = np.array([_KIND_CODES[k] for k in model.kinds], np.int8)
    dims, blobs = [], []
    width = 1
    linears = iter(model.linears)
    for kind in model.kinds:
        if kind == "graph":
            width = 2 * width + 3
        elif kind == "linear":
            lin = next(linears)
            if lin.in_features != width:
                raise ValueError(f"a linear layer takes {lin.in_features} "
                                 f"columns where {width} arrive")
            width = lin.out_features
            dims += [lin.in_features, lin.out_features]
            blobs += [lin.weight.detach().cpu().numpy().T.ravel(),
                      lin.bias.detach().cpu().numpy()]
        if width > _NATIVE_WIDTH:
            raise ValueError(f"a layer {width} wide exceeds the native "
                             f"forward's {_NATIVE_WIDTH} columns")
    packed = (kinds, np.array(dims, np.int32),
              np.concatenate(blobs).astype(np.float32))
    model._native_pack = (key, packed)
    return packed


def cpu_forward_native(snap, model, weight_scale, n_threads=None):
    """The model's scores of a core ``Snapshot`` from the threaded C++
    forward (``cpuforward.hpp``): ``MWVCModel.forward`` with
    ``compat=True`` and ``x_is_node_weights=True`` on the host, without a
    ``DeviceGraph`` build.  Rows are independent, so the thread count
    (default: the host's cores) does not change a bit of the result."""
    lib = _load()
    n = int(snap.n)
    if n == 0:
        return np.zeros(0, np.float32)
    kinds, dims, params = _pack_model(model)
    out = np.empty(n, np.float32)
    lib.mwvc_cpu_forward(
        n, np.ascontiguousarray(snap.indptr, np.uint64),
        np.ascontiguousarray(snap.indices, np.uint32),
        np.ascontiguousarray(snap.weights, np.uint32),
        np.ascontiguousarray(snap.nw, np.uint64),
        np.ascontiguousarray(snap.deg, np.uint32),
        float(weight_scale), len(kinds), kinds, dims, params, out,
        int(n_threads or os.cpu_count() or 1))
    return out


def improve_cover(weights, edges, vc):
    """Neighbourhood-improvement pass over a cover; returns (cost, cover)."""
    lib = _load()
    w = np.ascontiguousarray(weights, dtype=np.uint32)
    m, eu, ev = _split_edges(edges)
    vc = np.ascontiguousarray(vc, dtype=np.uint8).copy()
    cost = lib.mwvc_improve_cover(len(w), w, m, eu, ev, vc)
    return int(cost), vc


def _construct(fn_name, weights, edges):
    lib = _load()
    w = np.ascontiguousarray(weights, dtype=np.uint32)
    m, eu, ev = _split_edges(edges)
    vc = np.zeros(len(w), dtype=np.uint8)
    cost = getattr(lib, fn_name)(len(w), w, m, eu, ev, vc)
    return int(cost), vc


def approx_cover(weights, edges):
    """Primal-dual 2-approximation construction; returns (cost, cover)."""
    return _construct("mwvc_approx_construct", weights, edges)


def greedy_cover(weights, edges):
    """Degree/weight greedy construction; returns (cost, cover)."""
    return _construct("mwvc_greedy_construct", weights, edges)


BASELINE_IDS = {"fastwvc": 0, "dynwvc2": 1, "numwvc": 2, "hils": 3}


def baseline_solve(which, weights, edges, seed=1, cutoff=10.0, cc_mode=3,
                   iterations=None, p=None, target=None):
    """Run a comparison baseline solver; returns (cost, cover, time_to_best).

    which: "fastwvc" | "dynwvc2" | "numwvc" | "hils" (hils solves MWIS and
    returns the complement cover; cost = total weight - IS weight).  hils
    only, the reference's flags: iterations (-i, default 2,000,000), p (-p,
    4 intensification parameters, default (2, 4, 4, 1)), target (stop once
    the IS weight reaches it).
    """
    lib = _load()
    w = np.ascontiguousarray(weights, dtype=np.uint32)
    m, eu, ev = _split_edges(edges)
    vc = np.zeros(len(w), dtype=np.uint8)
    tbest = ct.c_double(0.0)
    if which == "hils" and (iterations is not None or p is not None
                            or target is not None):
        p = tuple(p) if p is not None else (2, 4, 4, 1)
        cost = lib.mwvc_hils_solve(
            len(w), w, m, eu, ev, seed, cutoff,
            int(iterations if iterations is not None else 2_000_000),
            int(p[0]), int(p[1]), int(p[2]), int(p[3]), int(target or 0), vc,
            ct.byref(tbest))
    else:
        cost = lib.mwvc_baseline_solve(BASELINE_IDS[which], len(w), w, m, eu,
                                       ev, seed, cutoff, cc_mode, vc,
                                       ct.byref(tbest))
    return int(cost), vc, float(tbest.value)
