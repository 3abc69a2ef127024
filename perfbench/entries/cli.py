"""Cells that drive the command line ``gnn-vc-torch``
(``gnn_mwvc_tpu_torch.solver.cli.main``) on a METIS file, in the process.

Traffic keys: ``instance`` ("seeded": the instance drawn from ``--seed``;
"fixed": the configuration's ``instance_seed``), ``loop`` ("closed": calls
back to back while the window has time left, the window closing when the
last returns), ``args`` (the command line, with ``{graph}`` and
``{result}`` filled in and the value of ``--device`` set to the run's
device), ``warmup`` (the configuration's size keys for a small instance of
the same family, one call in the set-up), ``check`` (the rounds whose
scores the reference recomputes) and ``limits``.

The configuration's ``family`` picks the generator: ``road``
(``yardstick/graphs.py::road_csr``) or ``geometric``
(``yardstick/geometric.py::rgg_csr``).  The set-up writes the instance as a
METIS file (``yardstick/geometric.py::write_metis``) into a temporary
directory; each call writes its own result file there, which the judge
reads after the window and checks against the benchmark's own CSR.

The benchmark's own spans: each call passes through the span ``cli``, and
each per-snapshot scoring through ``SnapshotProbe`` (span ``score``), which
records its shape in ``solve.py``'s ``calls`` layout and, in the drawn
rounds, keeps the snapshot and the scores.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import tempfile
import time
import types

import numpy as np

from perfbench.entries import solve as solve_entry
from perfbench.yardstick.counts import SEA2022_AGG_WIDTHS
from perfbench.yardstick.geometric import rgg_csr, write_metis
from perfbench.yardstick.graphs import road_csr

__all__ = ["CONTROLS", "prepare", "window", "release", "judge", "attempts",
           "counters"]

CONTROLS = ("tf32",)


def make_csr(config, seed):
    """The configuration's instance at ``seed``, by its ``family``."""
    family = config["family"].split(":")[0].strip()
    if family == "road":
        return road_csr(config["side"], seed, config["extra"])
    if family == "geometric":
        return rgg_csr(config["log2_n"], seed, config["radius_factor"],
                       config["weight_min"], config["weight_max"])
    raise ValueError(f"no generator for the family {family!r}")


class SnapshotProbe:
    """Wraps ``GnnScorer.__call__(snapshot, weight_scale)``, one call per
    peel round.  Per call it records the live vertices and directed edges
    scored, the neighbour sums' shapes (unmasked: the snapshot is the live
    kernel) and the host seconds; in the rounds in ``check_rounds`` it keeps
    the snapshot and the scores, and the seconds that took
    (``check_seconds``, inside the program's scoring timer)."""

    def __init__(self, real, check_rounds, span):
        self.real = real
        self.check_rounds = set(check_rounds)
        self.span = span
        self.reset()

    def reset(self):
        self.calls = []
        self.samples = []
        self.check_seconds = 0.0

    def __call__(self, scorer, snap, weight_scale):
        t0 = time.perf_counter()
        with self.span("score"):
            prob = self.real(scorer, snap, weight_scale)
        seconds = time.perf_counter() - t0
        if snap.n == 0:
            return prob
        n, nnz = int(snap.n), int(snap.indptr[-1])
        self.calls.append({
            "sticky": False, "n": n, "nnz": nnz, "seconds": seconds,
            "k1": [(n, n, nnz, wd, 0) for wd in SEA2022_AGG_WIDTHS]})
        if len(self.calls) - 1 in self.check_rounds:
            t0 = time.perf_counter()
            self.samples.append({
                "snap": (np.asarray(snap.ids).copy(),
                         snap.weights.astype(np.int64),
                         snap.indptr.astype(np.int64),
                         snap.indices.astype(np.int64)),
                "ids": np.asarray(snap.ids).copy(),
                "prob": np.asarray(prob, np.float32).copy(),
                "built_size": None, "weight_scale": float(weight_scale)})
            self.check_seconds += time.perf_counter() - t0
        return prob


def _argv(state, graph, result):
    args = [a.format(graph=graph, result=result)
            for a in state["traffic"]["args"]]
    if "--device" in args:
        args[args.index("--device") + 1] = str(state["device"])
    return args


def _call(argv):
    """(exit code, the ``--json`` object or None) of one in-process call."""
    from gnn_mwvc_tpu_torch.solver import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    lines = [ln for ln in out.getvalue().splitlines() if ln.startswith("{")]
    return rc, (json.loads(lines[-1]) if lines else None)


def prepare(config, traffic, seed, seconds, device):
    t0 = time.perf_counter()
    inst_seed = (seed if traffic["instance"] == "seeded"
                 else config["instance_seed"])
    csr = make_csr(config, inst_seed)
    tmp = tempfile.mkdtemp(prefix="perfbench-cli-")
    graph = os.path.join(tmp, "instance.metis")
    write_metis(graph, *csr)
    t1 = time.perf_counter()
    state = {"config": config, "traffic": traffic, "seed": seed,
             "device": device, "csr": csr, "dir": tmp, "graph": graph,
             "kwargs": {}, "solves": [], "error": None}
    warm = os.path.join(tmp, "warmup.metis")
    write_metis(warm, *make_csr({**config, **traffic["warmup"]}, 1))
    rc, line = _call(_argv(state, warm, os.path.join(tmp, "warmup.sol")))
    if rc != 0 or line is None:
        raise RuntimeError(f"the warm-up call failed (exit code {rc})")
    rng = np.random.default_rng(seed)
    chk = traffic["check"]
    state["check_rounds"] = [0] + sorted(rng.integers(
        1, chk["round_range"], size=chk["rounds"] - 1).tolist())
    state["setup_parts"] = {"instance_s": t1 - t0,
                            "warmup_s": time.perf_counter() - t1}
    return state


def window(state, seconds, span):
    from gnn_mwvc_tpu_torch.solver import pipeline

    real = pipeline.GnnScorer.__call__
    probe = SnapshotProbe(real, state["check_rounds"], span)

    def probed(scorer, snap, weight_scale):
        return probe(scorer, snap, weight_scale)

    pipeline.GnnScorer.__call__ = probed
    try:
        with solve_entry.traced_calls(span):
            _loop(state, seconds, span, probe)
    finally:
        pipeline.GnnScorer.__call__ = real


def _loop(state, seconds, span, probe):
    deadline = time.perf_counter() + seconds
    try:
        while time.perf_counter() < deadline:
            result = os.path.join(state["dir"],
                                  f"result{len(state['solves'])}.sol")
            probe.reset()
            t0 = time.perf_counter()
            with span("cli"):
                rc, line = _call(_argv(state, state["graph"], result))
            secs = time.perf_counter() - t0
            if rc != 0 or line is None:
                state["error"] = f"gnn-vc-torch exited {rc}"
                break
            state["solves"].append({
                "seconds": secs, "path": result, "line": line, "rounds": [],
                "calls": probe.calls, "samples": probe.samples,
                "check_s": probe.check_seconds})
    except (Exception, SystemExit) as e:  # a failed call ends the window
        import traceback

        traceback.print_exc()
        state["error"] = repr(e)


def release(state):
    """Nothing of the program's stays on the device after a call."""


def _read_cover(path, n):
    """The 0/1 per vertex a result file holds; a file that cannot be read
    or holds another count gives an empty cover, which covers nothing."""
    try:
        with open(path, "rb") as f:
            sol = np.array(f.read().split(), dtype=np.int64)
    except (OSError, ValueError):
        return np.zeros(0, np.int64)
    return sol if len(sol) == n else np.zeros(0, np.int64)


def judge(state, control=None):
    """Each written cover against the benchmark's CSR (``judge_cover``),
    its cost against the ``--json`` line's, and the drawn rounds' scores
    against the reference: ``solve.judge`` over the calls."""
    if not state.get("covers_read"):  # once: the control judges again
        state["covers_read"] = True
        n = len(state["csr"][0])
        for s in state["solves"]:
            line = s["line"]
            s["result"] = types.SimpleNamespace(
                solution=_read_cover(s["path"], n), cost=line["cost"],
                phase1=line.get("phase1") or {}, time_gnn=line["time_gnn"],
                ls_steps=line.get("ls_steps", 0),
                assist_stats=line.get("assist"))
        shutil.rmtree(state["dir"], ignore_errors=True)
    return solve_entry.judge(state, control)


attempts = solve_entry.attempts


def counters(state):
    """``solve.py``'s layout, one entry per call, with the command line's
    spans (None where the program records none) and the instance's size."""
    out = solve_entry.counters(state)
    for c, s in zip(out["solves"], state["solves"]):
        c["cli_spans"] = s["line"].get("cli_spans")
        c["n"], c["m"] = s["line"]["n"], s["line"]["m"]
    return out
