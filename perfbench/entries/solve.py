"""Cells that drive ``gnn_mwvc_tpu_torch.solver.pipeline.solve``.

Traffic keys: ``instance`` ("seeded": the instance drawn from ``--seed``;
"fixed": the configuration's ``instance_seed``), ``ls_seed`` (the
solver's seed: "seed" for ``--seed``, or a fixed number), ``loop``
("closed": whole solves back to back while the window has time left, the
window closing when the last returns; "budget": one solve whose
``time_limit`` is the window), ``solve`` (keyword arguments of
``solve``), ``scorer`` (a class of
``gnn_mwvc_tpu_torch.solver.static_score`` with the ``score_core``
protocol of the program's peel loop), ``warmup`` (a small solve in the
set-up, with the scorer's keyword arguments there), ``check`` (what the
reference compares) and ``limits``.

The benchmark's own spans: each scorer call passes through ``ScoreProbe``
(which records its shape and, in the rounds drawn for the check, the live
kernel and the scores), and each region batch through ``RegionProbe`` (which
keeps the batches drawn for the check).
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import time

import numpy as np
import torch

from perfbench.reference.cover import judge_cover
from perfbench.reference.gnn import forward, graph_arrays, load_weights
from perfbench.reference.regions import judge_regions
from perfbench.yardstick.counts import SEA2022_AGG_WIDTHS
from perfbench.yardstick.graphs import road_csr

__all__ = ["CONTROLS", "prepare", "window", "release", "judge", "attempts",
           "counters"]

# what stands in the program's place for the limits' upper readings: the
# reference with TF32 products (the scores; the cover and the regions
# stay the program's)
CONTROLS = ("tf32",)


class ScoreProbe:
    """Wraps a phase-1 scorer's ``score_core``, the protocol of the
    program's peel loop.  Per call it records whether the round was sticky,
    the live vertices and directed edges scored, the shapes of the
    neighbour sums it launched, and the host seconds; in the rounds in
    ``check_rounds`` it keeps the live kernel and the scores, and the
    seconds that took (``check_seconds``: the benchmark's work, inside the
    program's scoring timer, which the readers take out again)."""

    def __init__(self, inner, check_rounds, span):
        self.inner = inner
        self.model = inner.model
        self.check_rounds = set(check_rounds)
        self.span = span
        self.calls = []
        self.samples = []
        self._built = None  # (node-id size, rows, directed edges) of the CSR
        self.check_seconds = 0.0

    @property
    def stats(self):
        return getattr(self.inner, "stats", None)

    def score_core(self, core, weight_scale):
        stats = self.stats or {}
        rounds0 = stats.get("rounds", 0)
        rebuilds0 = stats.get("rebuilds", 0)
        t0 = time.perf_counter()
        with self.span("score"):
            ids, prob, w, deg = self.inner.score_core(core, weight_scale)
        seconds = time.perf_counter() - t0
        sticky = stats.get("rounds", 0) > rounds0
        n, nnz = len(ids), int(np.asarray(deg, np.int64).sum())
        if sticky and stats.get("rebuilds", 0) > rebuilds0:
            self._built = (core.n_nodes, n, nnz)
        if sticky:
            rows, edges, mask = self._built[1], self._built[2], 4
        else:
            rows, edges, mask = n, nnz, 0
        self.calls.append({
            "sticky": sticky, "n": n, "nnz": nnz, "seconds": seconds,
            "k1": [(rows, rows, edges, wd, mask)
                   for wd in SEA2022_AGG_WIDTHS]})
        if len(self.calls) - 1 in self.check_rounds:
            t0 = time.perf_counter()
            snap = core.snapshot()
            self.samples.append({
                "snap": (snap.ids.copy(), snap.weights.astype(np.int64),
                         snap.indptr.astype(np.int64),
                         snap.indices.astype(np.int64)),
                "ids": np.asarray(ids).copy(),
                "prob": np.asarray(prob, np.float32).copy(),
                "built_size": self._built[0] if sticky else None,
                "weight_scale": float(weight_scale)})
            self.check_seconds += time.perf_counter() - t0
        return ids, prob, w, deg


class RegionProbe:
    """Stands in for the region solver the assist calls; keeps the inputs
    and answers of the batches in ``keep`` (copies on the device, made in
    the assist's own stream)."""

    def __init__(self, inner, keep):
        self.inner = inner
        self.keep = set(keep)
        self.batches = 0
        self.kept = []

    def __call__(self, adj, w):
        best_cost, best_set = self.inner(adj, w)
        if self.batches in self.keep:
            self.kept.append((adj.clone(), w.clone(), best_cost.clone(),
                              best_set.clone()))
        self.batches += 1
        return best_cost, best_set


# program calls that a traced run wraps in spans of the benchmark's, so
# that the trace's idle gaps say which host layer the device waited on
TRACED_CALLS = (("gnn_mwvc_tpu_torch.core.api", "CoreSolver",
                 ("reduce", "solve_small_components", "peel", "snapshot",
                  "unfold", "apply_cover")),
                ("gnn_mwvc_tpu_torch.core.api", "CoreLocalSearch",
                 ("search", "extract_regions")),
                ("gnn_mwvc_tpu_torch.solver.device_assist", "DeviceAssist",
                 ("tick",)))


@contextlib.contextmanager
def traced_calls(span):
    """Wrap the ``TRACED_CALLS`` methods in spans while the block runs."""
    saved = []
    if span.on:
        for mod_name, cls_name, methods in TRACED_CALLS:
            cls = getattr(importlib.import_module(mod_name), cls_name)
            for m in methods:
                real = getattr(cls, m)
                saved.append((cls, m, real))
                setattr(cls, m, _spanned(real, f"{cls_name}.{m}", span))
    try:
        yield
    finally:
        for cls, m, real in saved:
            setattr(cls, m, real)


def _spanned(fn, name, span):
    @functools.wraps(fn)
    def call(*args, **kwargs):
        with span(name):
            return fn(*args, **kwargs)
    return call


def prepare(config, traffic, seed, seconds, device):
    from gnn_mwvc_tpu_torch.graph import Graph
    from gnn_mwvc_tpu_torch.models import pretrained_model
    from gnn_mwvc_tpu_torch.solver import static_score
    from gnn_mwvc_tpu_torch.solver.pipeline import solve

    t0 = time.perf_counter()
    inst_seed = (seed if traffic["instance"] == "seeded"
                 else config["instance_seed"])
    csr = road_csr(config["side"], inst_seed, config["extra"])
    t1 = time.perf_counter()
    model = pretrained_model(device)
    scorer_cls = getattr(static_score, traffic["scorer"])
    kwargs = dict(traffic["solve"])
    if "ls_seed" in traffic:
        kwargs["ls_seed"] = (seed if traffic["ls_seed"] == "seed"
                             else traffic["ls_seed"])
    warm = traffic["warmup"]
    t2 = time.perf_counter()
    wg = Graph.from_csr(*road_csr(warm["side"], 1, config["extra"]))
    wscorer = scorer_cls(model, device=device, **warm["scorer_args"])
    solve(wg, model=model, scorer=wscorer, device=device,
          **{**kwargs, "time_limit": warm["time_limit"]})
    rng = np.random.default_rng(seed)
    chk = traffic["check"]
    parts = {"instance_s": t1 - t0, "model_s": t2 - t1,
             "warmup_s": time.perf_counter() - t2}
    return {
        "setup_parts": parts,
        "config": config, "traffic": traffic, "seed": seed, "device": device,
        "csr": csr, "graph": Graph.from_csr(*csr), "model": model,
        "solve": solve, "scorer_cls": scorer_cls, "kwargs": kwargs,
        "check_rounds": [0] + sorted(rng.integers(
            1, chk["round_range"], size=chk["rounds"] - 1).tolist()),
        "keep_batches": [0] + sorted(rng.integers(
            1, chk["batch_range"], size=chk["batches"] - 1).tolist()),
        "region_rng": rng, "solves": [], "error": None,
    }


def window(state, seconds, span):
    from gnn_mwvc_tpu_torch.solver import device_assist

    regions = RegionProbe(device_assist.small_mwvc_mitm,
                          state["keep_batches"])
    device_assist.small_mwvc_mitm = regions
    state["regions"] = regions
    try:
        with traced_calls(span):
            _loop(state, seconds, span)
    finally:
        device_assist.small_mwvc_mitm = regions.inner


def _loop(state, seconds, span):
    from gnn_mwvc_tpu_torch.utils.metrics import SolveMetrics

    traffic = state["traffic"]
    solve = state["solve"]
    budget = traffic["loop"] == "budget"
    deadline = time.perf_counter() + seconds
    try:
        while time.perf_counter() < deadline:
            scorer = ScoreProbe(
                state["scorer_cls"](state["model"], device=state["device"]),
                state["check_rounds"], span)
            metrics = SolveMetrics()
            kwargs = dict(state["kwargs"])
            if budget:
                kwargs["time_limit"] = seconds
            t0 = time.perf_counter()
            with span("solve"):
                res = solve(state["graph"], model=state["model"],
                            scorer=scorer, device=state["device"],
                            metrics=metrics, **kwargs)
            state["solves"].append({
                "seconds": time.perf_counter() - t0, "result": res,
                "rounds": metrics.rounds, "calls": scorer.calls,
                "samples": scorer.samples, "scorer_stats": scorer.stats,
                "check_s": scorer.check_seconds})
            if budget:
                break
    except Exception as e:  # a failed solve ends the window; judged below
        import traceback

        traceback.print_exc()
        state["error"] = repr(e)


def release(state):
    """Free the program's device state before the reference runs."""
    state["model"] = None
    kept = state.get("regions")
    if kept is not None:
        state["kept_regions"] = [tuple(t.cpu().numpy() for t in b)
                                 for b in kept.kept]
        state["regions"] = None


def _score_gap(sample, kinds, linears, device, control=None):
    ids, w, indptr, indices = sample["snap"]
    keep = None
    if sample["built_size"] is not None:
        # a sticky round aggregates over the CSR built at its last rebuild:
        # edges to vertices made after it (fold gadgets) are not summed,
        # and those vertices get a neutral score, so they are not compared
        old = ids < sample["built_size"]
        rows = np.repeat(np.arange(len(ids)), np.diff(indptr))
        keep = old[rows] & old[indices]
    g = graph_arrays(w, indptr, indices, device, agg_keep=keep)
    with torch.no_grad():
        ref = forward(kinds, linears, g, sample["weight_scale"]).cpu().numpy()
        if control:
            prog = forward(kinds, linears, g, sample["weight_scale"],
                           tf32=True).cpu().numpy()
        else:
            # a scored round has live vertices, so neither array is empty
            pos = np.full(int(max(ids.max(), sample["ids"].max())) + 1, -1,
                          np.int64)
            pos[sample["ids"]] = np.arange(len(sample["ids"]))
            at = pos[ids]
            if (at < 0).any():
                return float("inf")  # a live vertex the scorer left out
            prog = sample["prob"][at].astype(np.float64)
    cmp = ids < sample["built_size"] if sample["built_size"] is not None \
        else np.ones(len(ids), bool)
    if not cmp.any():
        return 0.0
    return float(np.abs(np.asarray(prog, np.float64)[cmp]
                        - ref.astype(np.float64)[cmp]).max())


def judge(state, control=None):
    device = state["device"]
    limits = state["traffic"]["limits"]
    w, indptr, indices = state["csr"]
    uncovered = cost_gap = 0
    score_gap = 0.0
    kinds, lin_np = load_weights()
    linears = [(torch.from_numpy(a).to(device), torch.from_numpy(b).to(device))
               for a, b in lin_np]
    for s in state["solves"]:
        res = s["result"]
        unc, cost = judge_cover(w, indptr, indices, res.solution)
        s["cost"] = cost
        s["ok_cover"] = unc == 0 and cost == res.cost
        uncovered += unc
        cost_gap = max(cost_gap, abs(cost - int(res.cost)))
        for sample in s["samples"]:
            score_gap = max(score_gap, _score_gap(sample, kinds, linears,
                                                  device, control))
    checks = {"uncovered_edges": {"value": uncovered,
                                  "limit": limits["uncovered_edges"]},
              "cost_gap": {"value": cost_gap, "limit": limits["cost_gap"]},
              "score_gap": {"value": score_gap, "limit": limits["score_gap"]}}
    kept = state.get("kept_regions") or []
    if state["kwargs"].get("device_assist"):
        wrong, n_checked = 0, 0
        rng = state["region_rng"]
        per = state["traffic"]["check"]["regions_per_batch"]
        for adj, wr, bc, bs in kept:
            used = (wr != 0) | (adj != 0)
            ks = np.where(used.any(1),
                          adj.shape[1] - np.argmax(used[:, ::-1], axis=1), 0)
            rows = np.nonzero(ks)[0]
            rows = np.sort(rng.choice(rows, size=min(per, len(rows)),
                                      replace=False)) if len(rows) else rows
            wrong += judge_regions(adj[rows], wr[rows], ks[rows], bc[rows],
                                   bs[rows], device)
            n_checked += len(rows)
        state["regions_checked"] = n_checked
        # no batch to judge is itself a failure: the assist never ran
        checks["k4_wrong"] = {"value": wrong if n_checked else 1,
                              "limit": limits["k4_wrong"]}
    return checks


def attempts(state):
    attempted = len(state["solves"]) + (1 if state["error"] else 0)
    failed = sum(1 for s in state["solves"] if not s["ok_cover"])
    return attempted, failed + (1 if state["error"] else 0)


def counters(state):
    """What the metric readers read: one entry per completed solve."""
    yardstick = state["config"].get("yardstick_cost")
    out = []
    for s in state["solves"]:
        res = s["result"]
        out.append({
            "seconds": s["seconds"], "cost": s.get("cost"),
            "yardstick": yardstick, "phase1": res.phase1 or {},
            "time_gnn": res.time_gnn, "ls_steps": res.ls_steps,
            "assist": res.assist_stats, "rounds": s["rounds"],
            "calls": s["calls"], "check_s": s["check_s"]})
    return {"solves": out, "regions_checked": state.get("regions_checked")}
