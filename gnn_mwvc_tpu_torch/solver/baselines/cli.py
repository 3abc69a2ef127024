"""mwvc-baseline-torch: the comparison solvers of the native core with the
reference's CLI contracts (reference: README.md "Programs")::

    mwvc-baseline-torch fastwvc [graph] [seed] [cutoff] [cc mode]
    mwvc-baseline-torch dynwvc2 [graph] [seed] [cutoff] [cc mode]
    mwvc-baseline-torch numwvc  [graph] [seed] [cutoff]
    mwvc-baseline-torch hils    [graph] [seed] [cutoff] [--complement]
    mwvc-baseline-torch fastwvc-tuned [graph] [seed (unused)] [cutoff]

Output: ``file,best_weight,best_time`` CSV (hils: the IS weight and the
equivalent cover cost, ``file,is_weight,vc_cost,best_time``).  These are
host solvers: no device is involved.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def _tuned(g, edges, cutoff):
    """fastwvc-tuned: greedy degree/weight construction, then the core's
    local search under the adaptive step-size schedule (reference:
    old_files/src/apps/fastWVC_tuned.cpp:45-88: the step doubles on an
    improvement and halves on a stall, within [2^10, 2^16]).  Returns
    (cost, cover, time to best)."""
    from gnn_mwvc_tpu_torch.core import CoreLocalSearch, greedy_cover

    _cost0, s0 = greedy_cover(g.weights, edges)
    ls = CoreLocalSearch(g.weights, edges, s0)
    t0 = time.perf_counter()
    t_best = 0.0
    step = 1 << 16
    while time.perf_counter() - t0 < cutoff:
        remaining = cutoff - (time.perf_counter() - t0)
        if ls.search(step, remaining):
            t_best = time.perf_counter() - t0
            step = min(step * 2, 1 << 16)
        else:
            step = max(step // 2, 1 << 10)
    return int(ls.best_cost), ls.best(), t_best


def main(argv=None):
    ap = argparse.ArgumentParser(prog="mwvc-baseline-torch")
    ap.add_argument("solver", choices=["fastwvc", "dynwvc2", "numwvc", "hils",
                                       "fastwvc-tuned"])
    ap.add_argument("graph")
    ap.add_argument("seed", type=int, nargs="?", default=1)
    ap.add_argument("cutoff", type=float, nargs="?", default=10.0)
    ap.add_argument("cc_mode", type=int, nargs="?", default=3)
    ap.add_argument("--out", default=None, help="write the 0/1 cover file")
    # the HILS flags (reference: other_solvers/HILS/ArgPack.h:25-62)
    ap.add_argument("-i", "--iterations", type=int, default=None,
                    help="hils: max ILS iterations (default 2,000,000)")
    ap.add_argument("-p", default=None,
                    help="hils: 4 comma-separated intensification params "
                         "(default 2,4,4,1)")
    ap.add_argument("--target", type=int, default=None,
                    help="hils: stop once the IS weight reaches this")
    ap.add_argument("--complement", action="store_true",
                    help="hils: solve the complement graph (quadratic edge "
                         "count: small graphs only)")
    args = ap.parse_args(argv)

    from gnn_mwvc_tpu_torch.core import baseline_solve
    from gnn_mwvc_tpu_torch.graph import Graph
    from gnn_mwvc_tpu_torch.graphio import (cover_cost, is_vertex_cover,
                                            read_metis, write_solution)

    g = read_metis(args.graph)
    edges = g.edge_array()
    if args.complement:
        if args.solver != "hils":
            ap.error("--complement is a hils flag")
        if g.n > 30_000:
            ap.error("--complement builds a dense graph; n too large")
        adj = np.zeros((g.n, g.n), dtype=bool)
        adj[edges[:, 0], edges[:, 1]] = True
        adj |= adj.T
        np.fill_diagonal(adj, True)
        cu, cv = np.nonzero(np.triu(~adj, 1))
        edges = np.stack([cu, cv], axis=1)
        g = Graph(g.weights, edges)  # validate against the solved graph

    if args.solver == "fastwvc-tuned":
        cost, vc, t_best = _tuned(g, edges, args.cutoff)
    else:
        hils_kw = {}
        if args.solver == "hils":
            hils_kw = dict(
                iterations=args.iterations,
                p=[int(x) for x in args.p.split(",")] if args.p else None,
                target=args.target)
        cost, vc, t_best = baseline_solve(
            args.solver, g.weights, edges, seed=args.seed,
            cutoff=args.cutoff, cc_mode=args.cc_mode, **hils_kw)
    if not is_vertex_cover(g, vc):
        print("Result is not a vertex cover")
        return 1
    if cover_cost(g, vc) != cost:
        print("Result cost does not match the cover")
        return 1
    if args.out:
        write_solution(args.out, vc)
    if args.solver == "hils":
        print(f"{args.graph},{int(g.weights.sum()) - cost},{cost},"
              f"{t_best:.4f}")
    else:
        print(f"{args.graph},{cost},{t_best:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
