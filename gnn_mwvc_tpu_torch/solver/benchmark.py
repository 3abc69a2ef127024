"""mwvc-bench-torch: the differential harness.  It runs this package's
solvers, the baseline reimplementations in the native core and, where
present, the reference binaries on the same instances, and prints one
comparison table (the BASELINE.md protocol).

Usage::

    mwvc-bench-torch g1.metis g2.metis --time 100
    mwvc-bench-torch --suite quick --time 10 --solvers gnn,approx,fastwvc

Reference binaries are looked up in ``$MWVC_REFERENCE_BIN`` (default
``gnn_mwvc_oracle`` under the temporary directory, where
``tests/oracle/build_oracle.sh`` puts them); a missing binary gives a null
row.  ``--device`` (default cuda; cuda without a GPU is an error) is where
the GNN and the region solver of the ``gnn`` and ``quick`` rows run.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REF_BIN = os.environ.get("MWVC_REFERENCE_BIN",
                         os.path.join(tempfile.gettempdir(), "gnn_mwvc_oracle"))
DEFAULT_SOLVERS = ("gnn,quick,approx,fastwvc,dynwvc2,numwvc,hils,ref:GNN_VC,"
                   "ref:FastWVC,ref:DynWVC2")


def _checked(g, cover, cost, what):
    from gnn_mwvc_tpu_torch.graphio import cover_cost, is_vertex_cover

    if not is_vertex_cover(g, cover):
        raise RuntimeError(f"{what}: not a vertex cover")
    if cover_cost(g, cover) != cost:
        raise RuntimeError(f"{what}: cost does not match the cover")


def run_ours(g, budget, mode="gnn", reorder=False, device="cuda"):
    from gnn_mwvc_tpu_torch.solver.pipeline import solve
    from gnn_mwvc_tpu_torch.solver.quick import QuickScorer

    t0 = time.perf_counter()
    res = solve(g, time_limit=budget, reorder=reorder, device=device,
                scorer=QuickScorer() if mode == "quick" else None)
    _checked(g, res.solution, res.cost, mode)
    return {"cost": res.cost, "best_seen": res.best_seen,
            "t_best": round(res.time_to_best, 3),
            "t_total": round(time.perf_counter() - t0, 3)}


def run_approx(g):
    from gnn_mwvc_tpu_torch.solver.approximation import approximate_solve

    vc, cost, dt = approximate_solve(g)
    _checked(g, vc, cost, "approx")
    return {"cost": cost, "best_seen": cost, "t_best": round(dt, 3),
            "t_total": round(dt, 3)}


def run_baseline(g, which, budget, seed=1):
    from gnn_mwvc_tpu_torch.core import baseline_solve

    t0 = time.perf_counter()
    cost, vc, t_best = baseline_solve(which, g.weights, g.edge_array(),
                                      seed=seed, cutoff=budget)
    _checked(g, vc, cost, which)
    return {"cost": cost, "best_seen": cost, "t_best": round(t_best, 3),
            "t_total": round(time.perf_counter() - t0, 3)}


def run_reference(path, name, budget, seed=1):
    """Run a reference binary; returns a dict, or None if unavailable."""
    exe = os.path.join(REF_BIN, name)
    if not os.path.exists(exe):
        return None
    try:
        if name == "GNN_VC":
            cmd = [exe, path, path + ".refsol", str(budget), "-1", "0"]
        elif name == "HILS":
            cmd = [exe, "-t", str(budget), path]
        else:
            cmd = [exe, path, str(seed), str(budget)] + (
                ["3"] if name in ("FastWVC", "DynWVC2") else [])
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=budget * 3 + 300)
        fields = out.stdout.strip().splitlines()[-1].split(",")
        if name == "GNN_VC":
            cost = int(fields[-2]) if len(fields) == 8 else int(fields[1])
            t_best = float(fields[-1])
        elif name == "HILS":
            # prints the IS weight; the cover costs total - IS
            from gnn_mwvc_tpu_torch.graphio import read_metis

            cost = int(read_metis(path).weights.sum()) - int(fields[1])
            t_best = float(fields[2]) if len(fields) > 2 else 0.0
        else:
            cost = int(fields[1])
            t_best = float(fields[2])
        return {"cost": cost, "best_seen": cost, "t_best": t_best,
                "t_total": None}
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def make_suite(which, out_dir=None):
    """Built-in synthetic suites, written as METIS files (no external
    data): the JAX harness's instances, from this package's generators."""
    from gnn_mwvc_tpu_torch.graph import build_road_graph, random_graph
    from gnn_mwvc_tpu_torch.graphio import write_metis

    if which == "quick":
        specs = [("rnd5k", lambda: random_graph(5000, 16, seed=1, wmax=100)),
                 ("road90", lambda: build_road_graph(90))]
    else:
        specs = [
            ("rnd5k", lambda: random_graph(5000, 16, seed=1, wmax=100)),
            ("rnd50k", lambda: random_graph(50_000, 12, seed=2, wmax=1000)),
            ("road300", lambda: build_road_graph(300)),
            ("road900", lambda: build_road_graph(900)),
        ]
    d = out_dir or tempfile.mkdtemp(prefix="mwvc_bench_")
    paths = []
    for name, mk in specs:
        path = os.path.join(d, name + ".metis")
        write_metis(path, mk())
        paths.append(path)
    return paths


def main(argv=None):
    ap = argparse.ArgumentParser(prog="mwvc-bench-torch")
    ap.add_argument("graphs", nargs="*")
    ap.add_argument("--suite", choices=["quick", "full"])
    ap.add_argument("--time", type=float, default=10.0)
    ap.add_argument("--solvers", default=DEFAULT_SOLVERS)
    ap.add_argument("--reorder", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device for the gnn and quick rows")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    from gnn_mwvc_tpu_torch.graph import resolve_device
    from gnn_mwvc_tpu_torch.graphio import read_metis

    solvers = args.solvers.split(",")
    if {"gnn", "quick"} & set(solvers):
        resolve_device(args.device)
    paths = list(args.graphs)
    if args.suite:
        paths += make_suite(args.suite)
    if not paths:
        ap.error("no graphs (pass files or --suite)")

    rows = []
    for path in paths:
        g = read_metis(path)
        name = os.path.splitext(os.path.basename(path))[0]
        row = {"graph": name, "n": g.n, "m": g.m}
        for s in solvers:
            if s in ("gnn", "quick"):
                r = run_ours(g, args.time, s, args.reorder, args.device)
            elif s == "approx":
                r = run_approx(g)
            elif s.startswith("ref:"):
                r = run_reference(path, s[4:], args.time)
            else:
                r = run_baseline(g, s, args.time)
            row[s] = r
            print(f"  {name} {s}: {r['cost'] if r else 'n/a'}",
                  file=sys.stderr)
        rows.append(row)

    if args.json:
        print(json.dumps(rows))
    else:
        print("graph,n,m," + ",".join(f"{s}_cost,{s}_t" for s in solvers))
        for row in rows:
            cells = [row["graph"], str(row["n"]), str(row["m"])]
            for s in solvers:
                r = row[s]
                cells += [str(r["cost"]), str(r["t_best"])] if r else ["", ""]
            print(",".join(cells))
    return 0


if __name__ == "__main__":
    sys.exit(main())
