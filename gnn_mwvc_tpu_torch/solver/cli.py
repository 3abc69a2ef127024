"""gnn-vc-torch: the solver command line, with the reference program's
positional contract::

    gnn-vc-torch [graph file] [result file] [time] [k (< 0 = auto)] [0|1 verbose]

stdout on the default path: ``[graph],[VC written],[best VC seen],[time to
best]``; when the graph reduces fully or no local search ran:
``[graph],[N],[E],[kernel],[cost_gnn],[t_gnn],[cost],[t]``.

Options: ``--device`` (default cuda; cuda without a GPU is an error),
``--device-assist/--no-device-assist`` (default: on for CUDA), ``--quick``
(no GNN: the weight/degree priority of the reference's QUICK_VC), ``--model``
(a model file in the reference text format), ``--json``, ``--shards N``
(phase 1 scored over N shards, ``ShardedGnnScorer``: one per CUDA card from
``cuda:0``, or N on the host with ``--device cpu``; the phase-2 assist stays
on ``--device``; not with ``--quick``).  ``--device`` names the solve's
device, where the mesh starts: ``cuda`` and ``cuda:0`` both give a shard per
card, unlike a tool's ``--device cuda:0``, which puts every shard there
(``parallel.place_mesh``), and another card is refused.  Without either,
phase 1 scores each round's snapshot with ``GnnScorer`` on ``--device``, as
``gnn-vc`` does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(prog="gnn-vc-torch")
    ap.add_argument("graph")
    ap.add_argument("result")
    ap.add_argument("time", type=float)
    ap.add_argument("k", type=int, nargs="?", default=-1,
                    help="relabel interval; < 0 = auto (N/20 staleness)")
    ap.add_argument("verbose", type=int, nargs="?", default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device for the GNN and the region solver")
    ap.add_argument("--device-assist", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="device-batched exact region patches and guided "
                         "kicks in phase 2 (default: on for CUDA)")
    ap.add_argument("--quick", action="store_true",
                    help="no-GNN mode: weight/degree priority (QUICK_VC)")
    ap.add_argument("--model", default=None,
                    help="model file in the reference text format")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--shards", type=int, default=0,
                    help="score phase 1 over N shards (the edge-partitioned "
                         "halo-exchange forward): N CUDA cards, or N shards "
                         "on the host with --device cpu; 0 = one device")
    args = ap.parse_args(argv)
    mesh = None
    if args.shards:
        import torch

        from gnn_mwvc_tpu_torch.parallel import place_mesh

        if args.quick:
            ap.error("--shards scores phase 1 with the GNN; --quick has none")
        dev = torch.device(args.device)
        host = dev.type == "cpu"
        if not host and dev.index not in (None, 0):
            ap.error(f"--shards {args.shards} takes cuda:0..{args.shards - 1}"
                     f"; --device {args.device} would put the phase-2 assist "
                     "elsewhere")
        try:
            mesh = place_mesh(args.shards, "cpu" if host else "cuda")
        except RuntimeError as e:
            ap.error(f"--shards {args.shards}: {e}")

    from gnn_mwvc_tpu_torch.graphio import (cover_cost, is_vertex_cover,
                                            read_metis, write_solution)
    from gnn_mwvc_tpu_torch.models import MWVCModel, load_model
    from gnn_mwvc_tpu_torch.solver.pipeline import GnnScorer, solve
    from gnn_mwvc_tpu_torch.solver.quick import QuickScorer

    name = os.path.splitext(os.path.basename(args.graph))[0]
    try:
        g = read_metis(args.graph)
    except OSError as e:
        print(f"Error opening graph file: {e}")
        return 1
    if g.n == 0:
        print("Empty graph")
        return 0
    verbose = bool(args.verbose)
    if verbose:
        print(f"{name}, N = {g.n}, E = {g.m}")

    model = MWVCModel.from_spec(load_model(args.model)) if args.model else None
    if args.quick:
        scorer = QuickScorer()
    elif mesh is not None:
        from gnn_mwvc_tpu_torch.solver.sharded_score import ShardedGnnScorer

        scorer = ShardedGnnScorer(model, mesh=mesh)
    else:  # per-snapshot scoring, as gnn-vc (solve()'s default is sticky)
        scorer = GnnScorer(model, device=args.device)
    res = solve(g, model=model, time_limit=args.time,
                relable_interval=args.k, verbose=verbose, device=args.device,
                scorer=scorer,
                device_assist=("auto" if args.device_assist is None
                               else args.device_assist))

    if not is_vertex_cover(g, res.solution):
        print("Result is not a vertex cover")
        return 1
    if cover_cost(g, res.solution) != res.cost:
        print("Result cost does not match the cover")
        return 1
    write_solution(args.result, res.solution)

    if args.json:
        print(json.dumps({
            "name": name, "n": g.n, "m": g.m, "cost": res.cost,
            "best_seen": res.best_seen, "time_to_best": res.time_to_best,
            "time_gnn": res.time_gnn, "time_total": res.time_total,
            "kernel_size": res.kernel_size, "initial_cost": res.initial_cost,
            "counters": res.counters.tolist(), "ls_steps": res.ls_steps,
            "phase1": res.phase1, "assist": res.assist_stats,
            "device": args.device,
        }))
    elif verbose:
        print(f"Vertex cover cost: {res.cost}, found in "
              f"{res.time_to_best:.4f}s, {res.time_total:.4f} total time, "
              f"best seen {res.best_seen}")
    elif res.kernel_size == 0 or res.ls_steps == 0:
        print(f"{name},{g.n},{g.m},{res.kernel_size},{res.cost},"
              f"{res.time_gnn:.6g},{res.cost},{res.time_to_best:.6g}")
    else:
        print(f"{name},{res.cost},{res.best_seen},{res.time_to_best:.6g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
