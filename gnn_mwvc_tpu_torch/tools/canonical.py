"""Canonical-protocol run: the reference's 1000 s cutoff with the JAX tool's
settings (clustered relabel, the sticky scorer with its per-snapshot routing
of small rounds, the device assist when the solve runs on a card).  Prints the reference CSV line
``[graph],[VC written],[best seen],[time to best]`` and then a JSON record,
after checking that the written cover is valid and costs what it says.
The record has the JAX tool's keys (no relay probe); its ``scorer`` holds
the scorer's stats and the phase-1 split (its ``rounds`` is the split's:
every peel round, sticky and per snapshot; ``legacy_rounds`` the per-snapshot
ones).  A ``run:`` line before the CSV line gives what the record does not:
the kernel's size and the card's peak allocation
(``torch.cuda.max_memory_allocated``, null on the CPU).

Usage:
    python -m gnn_mwvc_tpu_torch.tools.canonical road900 [--time 1000]
        [--seed 1] [--tag run] [--out PATH] [--device cuda]
        [--device-assist | --no-device-assist]
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from gnn_mwvc_tpu_torch.graphio import cover_cost, is_vertex_cover
from gnn_mwvc_tpu_torch.solver.pipeline import resolve_device, solve
from gnn_mwvc_tpu_torch.solver.static_score import StickyGnnScorer
from gnn_mwvc_tpu_torch.tools._common import default_out, road_instance


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("instance", help="roadNNN")
    ap.add_argument("--time", type=float, default=1000.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--tag", default="run")
    ap.add_argument("--out", default=None,
                    help="JSON path (default: canonical_<instance>_<tag>.json "
                         "in the temporary directory)")
    ap.add_argument("--device-assist", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="device-assisted phase 2 (default: on when the "
                         "solve runs on a card)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    g = road_instance(args.instance)
    print(f"instance {args.instance}: n={g.n} m={g.m}", flush=True)
    scorer = StickyGnnScorer(device=device)
    assist = "auto" if args.device_assist is None else args.device_assist
    t0 = time.perf_counter()
    res = solve(g, time_limit=args.time, reorder=True, ls_seed=args.seed,
                verbose=True, scorer=scorer, device_assist=assist,
                device=device)
    wall = time.perf_counter() - t0
    if not is_vertex_cover(g, res.solution):
        raise RuntimeError("the written cover is not a vertex cover")
    if cover_cost(g, res.solution) != res.cost:
        raise RuntimeError(f"the written cover costs "
                           f"{cover_cost(g, res.solution)}, not {res.cost}")

    run = {"kernel_size": int(res.kernel_size),
           "peak_device_bytes": (torch.cuda.max_memory_allocated(device)
                                 if device.type == "cuda" else None)}
    print("run: " + json.dumps(run), flush=True)
    phase1 = dict(res.phase1)
    rec = {
        "instance": args.instance, "tag": args.tag, "seed": args.seed,
        "time_limit": args.time, "written": int(res.cost),
        "best": int(res.best_seen), "t_best": round(res.time_to_best, 1),
        "t_gnn": round(res.time_gnn, 1), "wall": round(wall, 1),
        "ls_steps": int(res.ls_steps),
        "scorer": {**phase1.pop("scorer", {}), **phase1},
        "device_assist": res.assist_stats is not None,
        "assist": res.assist_stats,
    }
    print(f"{args.instance},{res.cost},{res.best_seen},"
          f"{res.time_to_best:.1f}", flush=True)
    print(json.dumps(rec), flush=True)
    out = args.out or default_out(f"canonical_{args.instance}_{args.tag}.json")
    with open(out, "w") as f:
        json.dump(rec, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
