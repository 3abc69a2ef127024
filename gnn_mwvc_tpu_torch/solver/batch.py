"""mwvc-batch-torch: solve many instances in one warm process.

The model, the native core and the CUDA kernels load once and serve every
instance.  Usage::

    mwvc-batch-torch a.metis b.metis ... --out results/ --time 60
    mwvc-batch-torch --list instances.txt --out results/ --time 1000 --json

Per instance it writes ``<out>/<name>.sol`` (0/1 per vertex) and prints the
reference CSV contract ``name,cost_written,best_seen,time_to_best``;
``--json`` adds one structured line per instance and a final summary.
``--device`` (default cuda; cuda without a GPU is an error) is where the GNN
and the region solver run.  The clustered relabel is on unless
``--no-reorder``: it gives the neighbour sums locality on the device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(prog="mwvc-batch-torch")
    ap.add_argument("graphs", nargs="*")
    ap.add_argument("--list", default=None,
                    help="file with one instance path per line")
    ap.add_argument("--out", default=".")
    ap.add_argument("--time", type=float, default=1000.0,
                    help="per-instance cutoff (reference default 1000 s)")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--no-reorder", action="store_true",
                    help="skip the clustered relabel (on by default: it "
                         "gives the device's neighbour sums locality)")
    ap.add_argument("--device", default="cuda",
                    help="torch device for the GNN and the region solver")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    paths = list(args.graphs)
    if args.list:
        with open(args.list) as f:
            paths += [ln.strip() for ln in f if ln.strip()]
    if not paths:
        ap.error("no instances (pass files or --list)")
    os.makedirs(args.out, exist_ok=True)

    from gnn_mwvc_tpu_torch.graphio import (cover_cost, is_vertex_cover,
                                            read_metis, write_solution)
    from gnn_mwvc_tpu_torch.models import pretrained_model
    from gnn_mwvc_tpu_torch.solver.pipeline import resolve_device, solve
    from gnn_mwvc_tpu_torch.solver.quick import QuickScorer
    from gnn_mwvc_tpu_torch.solver.static_score import StickyGnnScorer

    device = resolve_device(args.device)
    model = pretrained_model(device)
    rows = []
    t_batch = time.perf_counter()
    for path in paths:
        name = os.path.splitext(os.path.basename(path))[0]
        g = read_metis(path)
        t0 = time.perf_counter()
        # a fresh sticky scorer per instance (it holds one graph's state);
        # the model, the core and the kernels stay loaded
        scorer = (QuickScorer() if args.quick
                  else StickyGnnScorer(model, device=device))
        res = solve(g, model=model, time_limit=args.time,
                    reorder=not args.no_reorder, scorer=scorer, device=device)
        dt = time.perf_counter() - t0
        # the serving entry point never writes an unchecked cover
        if not is_vertex_cover(g, res.solution):
            print(f"{name}: INVALID COVER - not written", file=sys.stderr)
            return 2
        if cover_cost(g, res.solution) != res.cost:
            print(f"{name}: cost mismatch - not written", file=sys.stderr)
            return 2
        sol_path = os.path.join(args.out, name + ".sol")
        write_solution(sol_path, res.solution)
        print(f"{name},{res.cost},{res.best_seen},{res.time_to_best:.4g}",
              flush=True)
        rows.append({
            "name": name, "n": int(g.n), "m": int(g.m),
            "cost": int(res.cost), "best_seen": int(res.best_seen),
            "t_best": round(res.time_to_best, 3), "t_total": round(dt, 3),
            "t_phase1": round(res.time_gnn, 3), "solution": sol_path,
            "device": str(device),
        })
        if args.json:
            print(json.dumps(rows[-1]), flush=True)
    if args.json:
        print(json.dumps({
            "instances": len(rows),
            "t_batch": round(time.perf_counter() - t_batch, 3),
            "total_cost": int(sum(r["cost"] for r in rows)),
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
