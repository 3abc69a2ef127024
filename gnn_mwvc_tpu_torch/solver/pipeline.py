"""End-to-end GNN-guided MWVC solve on one torch device.

  phase 1 (kernelize + peel): the native core reduces the graph to a fixed
      point; then loop { exactly solve small components; score every live
      vertex with the GNN on the device; order by confidence; peel decisions
      through the core until its staleness trigger } until the graph is
      empty.
  phase 2 (local search): the peeled decisions over the kernel are the
      initial cover of the native anytime local search, run in adaptive
      batches until the time budget, with an ILS kick schedule.  With the
      device assist (default on CUDA) the kernel is scored once on the
      device: the kicks are biased by model misfit, and batches of small
      regions are solved exactly on the device and patched back.
  finally: unfold all reductions and return the cover of the input graph.

The GNN forward and the region solver are the only device work; the rest
is the port's own copy of the C++ core (core/src/).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional

import numpy as np

from gnn_mwvc_tpu_torch.core import (
    PROFILE_RULES,
    CoreLocalSearch,
    CoreSolver,
    cluster_order,
    confidence_order_native,
)
from gnn_mwvc_tpu_torch.graph import DeviceGraph, Graph, resolve_device
from gnn_mwvc_tpu_torch.graphio import cover_cost
from gnn_mwvc_tpu_torch.models import MWVCModel, pretrained_model, score_graph
from gnn_mwvc_tpu_torch.solver.checkpoint import save_checkpoint
from gnn_mwvc_tpu_torch.solver.static_score import GnnScorer, StickyGnnScorer
from gnn_mwvc_tpu_torch.utils.metrics import record, recording, span

__all__ = ["CONF_EPS", "GnnScorer", "SolveResult", "confidence_order",
           "cover_uncovered_edges", "gnn_peel", "ids_lack_locality",
           "resolve_device", "solve"]

CONF_EPS = 1e-4  # confidence tie width (the reference's GNN_VC.cpp:196)

# ids_lack_locality's gate.  Under 2^16 vertices the command line keeps the
# file's ids, so that its covers stay those of the reference ``gnn-vc``,
# which never relabels, bit for bit; the relabel would save at most a few
# tenths of a second there (rgg at 2^15 on an 8-core CPU host: a time-0
# solve 0.63-0.85 s in file order, 0.45-0.63 s relabelled).  The gap share
# is ~0.29 on rgg in generation order, ~n^-0.5 on a grid-order road graph
# and under 0.003 on rgg in any spatial order: 10-20x either side of 1/64
# at the benchmark's sizes
LOCALITY_MIN_N = 1 << 16
LOCALITY_GAP_DIV = 64
LOCALITY_SAMPLE = 1 << 16


def ids_lack_locality(g: Graph) -> tuple:
    """(relabel?, gap share): the median |u - v| over a fixed strided sample
    of at most ``LOCALITY_SAMPLE`` directed CSR entries, as a share of n;
    relabel when ``g`` has at least ``LOCALITY_MIN_N`` vertices and that
    median exceeds n / ``LOCALITY_GAP_DIV``.  On such ids the core's
    reduction rules miss the cache at every neighbour, and
    ``solve(reorder=True)``'s clustered order cures that."""
    nnz = len(g.indices)
    if nnz == 0:
        return False, 0.0
    pos = np.arange(0, nnz, max(1, nnz // LOCALITY_SAMPLE))[:LOCALITY_SAMPLE]
    rows = np.searchsorted(g.indptr, pos, side="right") - 1
    gap = float(np.median(np.abs(rows - g.indices[pos])))
    return (g.n >= LOCALITY_MIN_N and gap * LOCALITY_GAP_DIV > g.n,
            gap / g.n)


def confidence_order(prob: np.ndarray, weights: np.ndarray,
                     deg: np.ndarray) -> np.ndarray:
    """The reference's confidence order: eps-bucketed min(p, 1-p)
    ascending; within a bucket exclusions first; inclusion ties by weight
    ascending then degree descending, exclusion ties by weight descending
    then degree ascending."""
    return confidence_order_native(prob, weights, deg, CONF_EPS)


def cover_uncovered_edges(cover: np.ndarray, edges: np.ndarray,
                          weights: np.ndarray) -> int:
    """Add to ``cover`` (0/1 per vertex, in place) the lighter endpoint (the
    first on a tie) of each edge that neither endpoint covers, edges taken
    in order; returns how many vertices were added.

    A check that should never add a vertex.  The JAX package's copy of the
    native core can leave a kernel edge with both endpoints decided out (on
    road1200 when every round is scored per snapshot): its fold of an
    independent neighbourhood trusts a sorted merge, which can pass a
    dependent one when a fold gadget, whose list is not sorted, is involved,
    and unfolding with the gadget out leaves an edge inside it open.  The
    port's copy refuses those folds (``phase1["dependent_folds"]`` counts
    them), so a non-zero return is a fault.  The local search would keep
    such a start as its best, since it is cheaper than any cover."""
    added = 0
    open_ = (cover[edges[:, 0]] == 0) & (cover[edges[:, 1]] == 0)
    for u, v in edges[open_]:
        if cover[u] == 0 and cover[v] == 0:
            cover[v if weights[v] < weights[u] else u] = 1
            added += 1
    return added


@dataclasses.dataclass
class SolveResult:
    solution: np.ndarray        # 0/1 per original vertex
    cost: int                   # cost of the cover written
    best_seen: int              # cheapest cost observed (may be < cost)
    time_to_best: float
    time_gnn: float
    time_total: float
    kernel_size: int            # nodes left after the initial reductions
    initial_cost: int           # cost paid by the initial reductions
    counters: np.ndarray        # rule-fire counters r1..r8
    ls_steps: int = 0
    # DeviceAssist.stats and best_gain, the best cover's drops at the
    # assist's commits (the rest of phase 2's fall is the search's)
    assist_stats: Optional[dict] = None
    # phase-1 split: t_reduce0_s, t_score_s, t_peel_s, rounds,
    # live_after_reduce0 (the vertices the initial reduction left), the
    # scorer's counts under "scorer", dependent_folds (the folds the
    # core refused), the meta rules' meta_evals, meta_bound_decided and
    # meta_solved (core.meta_counts), "core_counts" (per rule its fires in
    # the reduce and the peel, "<span>.<rule>.fires", and the live vertices
    # summed over the critical-weight calls, "<span>.critical.live") and
    # kernel_edges_uncovered, the vertices cover_uncovered_edges added (0
    # where nothing is left to cover);
    # phase2_start_cost, the full cover's cost when phase 2 starts (absent
    # where phase 1 left no budget to search); "spans": every span of the
    # solve, phase 2's too, as {name: {"seconds", "calls"}}
    # (utils/metrics.py)
    phase1: Optional[dict] = None


@contextlib.contextmanager
def _core_children(core: CoreSolver, parent: str, counts: dict):
    """The core's profile (``CoreSolver.profile``) over the block, as
    children of the span ``parent`` that runs it: under ``reduce`` and
    ``peel``, ``<parent>.<rule>`` (seconds on the rule's worklist, a call
    per evaluation) and ``<parent>.critical`` (a call per critical-weight
    flow), and under ``peel`` also ``peel.select`` (a call per decision);
    under ``components``, ``components.scan`` (a call per search, the
    exact solves' seconds left out) and ``components.exact`` (a call per
    component solved exactly).  The rules' fires and the flows' live
    vertices go to ``counts``."""
    before = core.profile
    yield
    d = {k: v - before[k] for k, v in core.profile.items()}
    if parent == "components":
        children = {"scan": (d["components.ns"] - d["exact.ns"],
                             d["components.calls"]),
                    "exact": (d["exact.ns"], d["exact.calls"])}
    else:
        children = {r: (d[f"{r}.ns"], d[f"{r}.evals"]) for r in PROFILE_RULES}
        children["critical"] = (d["critical.ns"], d["critical.calls"])
        if parent == "peel":
            children["select"] = (d["select.ns"], d["select.calls"])
        for r in PROFILE_RULES:
            key = f"{parent}.{r}.fires"
            counts[key] = counts.get(key, 0) + d[f"{r}.fires"]
        key = f"{parent}.critical.live"
        counts[key] = counts.get(key, 0) + d["critical.live"]
    for name, (ns, calls) in children.items():
        if ns or calls:
            record(f"{parent}.{name}", ns * 1e-9, calls)


def gnn_peel(core: CoreSolver, scorer, weight_scale: float,
             relable_interval: int = -1, component_limit: int = 75,
             verbose: bool = False, metrics=None):
    """Phase 1; returns (timestamp of the kernel, kernel size, initial cost,
    phase-1 split).

    ``scorer``: ``scorer.score_core(core, weight_scale) -> (ids, prob, w,
    deg)`` over the live nodes, and ``scorer.stats``, a dict of counts
    (``solver/static_score.py``).
    Spans: ``reduce``, then per round ``components``, ``score``, ``order``
    and ``peel``; the split's timers are their seconds.  The core's
    profile splits ``reduce``, ``components`` and ``peel`` into children
    (``_core_children``).
    """
    counts = {}
    with span("reduce") as sp, _core_children(core, "reduce", counts):
        core.reduce()
    split = {"t_reduce0_s": sp.seconds, "t_score_s": 0.0,
             "t_peel_s": 0.0, "rounds": 0,
             "live_after_reduce0": core.active_count,
             "core_counts": counts}
    t_kernel = None
    kernel_size = 0
    initial_cost = 0
    while core.active_count > 0:
        with span("components"), _core_children(core, "components", counts):
            core.solve_small_components(component_limit)
        if t_kernel is None:
            t_kernel = core.timestamp
            kernel_size = core.active_count
            initial_cost = core.cost
        if core.active_count == 0:
            break
        with span("score", launches=True) as score:
            ids, prob, wts, deg = scorer.score_core(core, weight_scale)
        edges_scored = int(np.asarray(deg, np.int64).sum())
        with span("order"):
            order = confidence_order(prob, wts, deg)
            core.reset_label_count()
        if verbose:
            print(f"Remaining nodes: {core.active_count}", end="\r",
                  flush=True)
        n_before = core.active_count
        with span("peel") as peel, _core_children(core, "peel", counts):
            core.peel(ids[order], prob[order].astype(np.float32),
                      relable_interval)
        split["t_score_s"] += score.seconds
        split["t_peel_s"] += peel.seconds
        split["rounds"] += 1
        if metrics is not None:
            metrics.record_round(
                nodes_remaining=core.active_count, edges_scored=edges_scored,
                decisions=n_before - core.active_count,
                label_count=core.label_count, seconds_score=score.seconds,
                seconds_peel=peel.seconds)
    if t_kernel is None:
        t_kernel = core.timestamp
    split["scorer"] = dict(scorer.stats)
    if metrics is not None:
        metrics.record_scorer(dict(scorer.stats))
    split["dependent_folds"] = core.dependent_folds
    split.update(core.meta_counts)
    return t_kernel, kernel_size, initial_cost, split


def solve(
    g: Graph,
    model: Optional[MWVCModel] = None,
    time_limit: float = 1000.0,
    relable_interval: int = -1,
    verbose: bool = False,
    scorer=None,
    seed_step_size: int = 1 << 16,
    checkpoint_path: Optional[str] = None,
    checkpoint_interval: float = 60.0,
    reorder: bool = False,
    metrics=None,
    ls_ils_stall: int = 256,
    ls_ils_k: int = 16,
    ls_seed: int = 1,
    device_assist="auto",
    assist_batch: int = 1024,
    assist_rmax: int = 20,
    device="cuda",
) -> SolveResult:
    """Solve MWVC on ``g`` within ``time_limit`` seconds (phase 2 is
    skipped when phase 1 alone uses the budget).

    device: where the GNN and the region solver run; "cuda" without CUDA
    raises.  scorer: defaults to sticky scoring on ``device``.
    device_assist: "auto" = on iff ``device`` is CUDA.

    checkpoint_path: when set, each phase-2 improvement found at least
    ``checkpoint_interval`` seconds after the last checkpoint writes the
    full cover of ``g`` there (``solver/checkpoint.py``; resume with
    ``resume_solve``).

    ls_ils_stall > 0 enables the ILS schedule: after that many consecutive
    non-improving batches at the step-size floor, restore the best cover
    and kick it with a force-k perturbation (k doubles while kicks fail to
    find a new best and resets on success).  ls_ils_stall=0 gives the
    reference's plain phase-2 search.

    The solve's spans (``phase1["spans"]``; none overlaps another at the
    top level): ``relabel``, ``core_build``, then ``gnn_peel``'s,
    ``rewind`` (the peel unfolded back to the kernel), ``handoff`` (phase
    2's set-up: the kernel's snapshot, edge list and start cover, the
    search, the kick bias's forward, the assist), per phase-2 batch
    ``search``, ``kick`` and ``assist`` (``DeviceAssist.tick``), and
    ``finish`` (the best cover back, the full unfold, the cover in the
    input's ids).  Children, named ``<parent>.<child>``: the scorer's and
    the assist's.  In a profile, the spans that may launch device work
    (``score`` and the scorer's upload, refresh and torch forward,
    ``handoff`` with the assist, ``assist`` and ``assist.dispatch``) have
    no range (``utils/metrics.py``).
    """
    t_start = time.perf_counter()
    device = resolve_device(device)
    if g.n == 0:
        return SolveResult(np.zeros(0, np.int8), 0, 0, 0.0, 0.0, 0.0, 0, 0,
                           np.zeros(8, np.uint64))

    g_orig = g
    perm = None
    with recording() as rec:
        if reorder:
            # clustered relabel for aggregation locality; the solution is
            # mapped back to the input's ids at the end
            with span("relabel"):
                perm = cluster_order(g.indptr, g.indices)
                g = g.reorder(perm)

        weight_scale = float(g.weights.max())
        if model is None and scorer is not None:
            model = scorer.model
        if model is None:
            model = pretrained_model()
        if scorer is None:
            scorer = StickyGnnScorer(model, device=device)

        with span("core_build"):
            core = CoreSolver(g.weights, g.edge_array())
        t_kernel, kernel_size, initial_cost, split = gnn_peel(
            core, scorer, weight_scale, relable_interval, verbose=verbose,
            metrics=metrics)
        with span("rewind"):
            core.unfold(t_kernel)  # the peel's decisions stay as the cover
        time_gnn = time.perf_counter() - t_start
        if verbose:
            print(f"GNN-VC done in {time_gnn:.3f}s, cost: {core.cost}")

        def finish(snap=None, ls=None, assist=None):
            """The cover of the input graph, its cost and the rule counters:
            the search's best cover (``ls``, over ``snap``'s kernel) back
            into the core, every reduction unfolded; the spans' totals to
            ``phase1`` and ``metrics``."""
            with span("finish"):
                if assist is not None:
                    assist.stop()
                if ls is not None:
                    # the best cover back (cost in kernel-state weights)
                    core.apply_cover(snap.ids, ls.best())
                core.unfold(0)
                sol = core.solution()
                if (sol < 0).any():
                    raise RuntimeError("core left vertices undecided")
                sol = _unpermute(sol.astype(np.int8), perm)
            split["spans"] = rec.as_dict()
            if metrics is not None:
                metrics.record_spans(split["spans"])
            return sol, core.cost, core.counters

        if core.active_count == 0:
            split["kernel_edges_uncovered"] = 0
            sol, cost, counters = finish()
            return SolveResult(sol, cost, cost, time_gnn, time_gnn,
                               time.perf_counter() - t_start, kernel_size,
                               initial_cost, counters, phase1=split)

        # ---- phase 2: local search over the kernel -------------------------
        assist = None
        kick_bias = None
        if device_assist == "auto":
            device_assist = device.type == "cuda"
        searched = time_gnn < time_limit  # phase 1 left budget to search
        assisted = device_assist and searched
        with span("handoff", launches=assisted):
            snap = core.snapshot()
            rows = np.repeat(np.arange(snap.n, dtype=np.int64),
                             np.diff(snap.indptr.astype(np.int64)))
            keep = rows < snap.indices
            kedges = np.stack([rows[keep], snap.indices[keep]], axis=1)
            s0 = np.array([core.decided(u) == 1 for u in snap.ids],
                          dtype=np.uint8)
            # never non-zero since the core refuses folds on a dependent
            # neighbourhood (cover_uncovered_edges): a count here is a fault
            split["kernel_edges_uncovered"] = cover_uncovered_edges(
                s0, kedges, snap.weights)
            ls = CoreLocalSearch(snap.weights, kedges, s0)
            if searched:
                split["phase2_start_cost"] = ls.cost + initial_cost
            if assisted:
                from gnn_mwvc_tpu_torch.solver.device_assist import (
                    DeviceAssist)

                # kernel scores (one forward on the device) bias the kicks
                # and the region-centre sampling; not a peel round, so not
                # in the scorer's spans
                dg = DeviceGraph.build(snap.weights, snap.indptr,
                                       snap.indices, device)
                prob = score_graph(model.to(device), dg,
                                   weight_scale).cpu().numpy()
                kick_bias = np.clip(1.0 - prob, 0.05, 1.0).astype(np.float32)
                assist = DeviceAssist(prob, device=device, batch=assist_batch,
                                      rmax=assist_rmax, seed=ls_seed)

        t2 = time.perf_counter()
        t_best = t2
        last_ckpt = t2
        step_size = seed_step_size
        stalled = 0
        kicks = 0
        k_cur = ls_ils_k
        best_at_kick = 1 << 62
        best_gain = 0
        while time_gnn + (time.perf_counter() - t2) < time_limit:
            remaining = time_limit - time_gnn - (time.perf_counter() - t2)
            with span("search"):
                improved = ls.search(step_size, remaining)
            if improved:
                stalled = 0
                t_best = time.perf_counter()
                step_size = min(step_size * 2, 1 << 16)
                if verbose:
                    print(f"{time_gnn + (t_best - t2):.2f},"
                          f"{ls.best_cost + initial_cost}, "
                          f"step size {step_size}")
                if checkpoint_path and t_best - last_ckpt >= \
                        checkpoint_interval:
                    core.apply_cover(snap.ids, ls.best())
                    full = _unpermute(
                        (core.preview_solution() == 1).astype(np.int8), perm)
                    save_checkpoint(checkpoint_path, g_orig, full,
                                    cover_cost(g_orig, full),
                                    time_gnn + (t_best - t2))
                    last_ckpt = t_best
            else:
                step_size = max(step_size // 2, 1 << 10)
                if step_size == 1 << 10:
                    stalled += 1
                    if ls_ils_stall and stalled >= ls_ils_stall:
                        stalled = 0
                        kicks += 1
                        if ls.best_cost < best_at_kick:
                            k_cur = ls_ils_k
                        else:
                            k_cur = min(k_cur * 2, 4096)
                        best_at_kick = ls.best_cost
                        _kick(ls, k_cur, ls_seed + kicks, kick_bias)
                        step_size = 1 << 16
            if assist is not None:
                prev_best, prev_cost = ls.best_cost, ls.cost
                assist.tick(ls)
                if ls.best_cost < prev_best:
                    # the assist's part of phase 2's fall: the best cover's
                    # drop at its commit, at most its patches' own drop
                    best_gain += min(prev_best - ls.best_cost,
                                     prev_cost - ls.cost)
                    t_best = time.perf_counter()
                    if verbose:
                        print(f"{time_gnn + (t_best - t2):.2f},"
                              f"{ls.best_cost + initial_cost}, device patch")

        best_seen, steps = ls.best_seen, ls.steps
        sol, cost, counters = finish(snap, ls, assist)
        return SolveResult(
            sol, cost, min(best_seen + initial_cost, cost),
            time_gnn + (t_best - t2), time_gnn, time.perf_counter() - t_start,
            kernel_size, initial_cost, counters, ls_steps=steps,
            assist_stats=(dict(assist.stats, best_gain=best_gain)
                          if assist is not None else None),
            phase1=split)


def _unpermute(sol: np.ndarray, perm) -> np.ndarray:
    """``sol`` over relabelled ids back in the input's ids (``perm`` None:
    not relabelled)."""
    if perm is None:
        return sol
    out = np.empty_like(sol)
    out[perm] = sol
    return out


def _kick(ls, k: int, seed: int, bias):
    """The ILS kick: restore the best cover and perturb ``k`` vertices of
    it, guided by ``bias`` where the assist scored the kernel."""
    with span("kick"):
        ls.restore_best()
        if bias is not None:
            ls.perturb_guided(k, seed, bias)
        else:
            ls.perturb(k, seed)
