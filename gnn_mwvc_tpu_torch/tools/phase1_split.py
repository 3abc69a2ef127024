"""Phase 1 of a road instance and its split, for one or more checkouts of
the repository, each in a process of its own, in the order given.

For each checkout (``--repos``, default this one; e.g. a parent commit
unpacked beside it, ``A,B,B,A`` to interleave two), one process imports
that checkout's ``gnn_mwvc_tpu_torch``, warms up on road40 (the native
core's and the kernels' builds) and runs, on ``--device``, with the
phase-2 budget at 0 and no assist:

  * ``solve(g)`` (its default scorer, the sticky one);
  * ``gnn-vc-torch g.metis out.sol 0 -1 0 --json`` (the CLI's scorer);

and prints one JSON line each: phase-1 seconds (``time_gnn``), reduce /
score / peel seconds, the solve's spans (``phase1["spans"]``, every piece
of the solve timed by name; null where the checkout has none), rounds, the
scorer's sticky and per-snapshot rounds where it has them, the kernel edges
the peel left open and the folds the core refused (where the checkout
counts them), the cover's cost and the kernel launches (or the CLI's
exit code and last line when it fails).  The last line is a JSON list of every record.

Usage:
    python -m gnn_mwvc_tpu_torch.tools.phase1_split [--side 1200]
        [--repos DIR,DIR,...] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# run in the checkout under test: only APIs every port commit has
RUN = r"""
import json, sys
from gnn_mwvc_tpu_torch.graph import build_road_graph
from gnn_mwvc_tpu_torch.graphio import read_metis
from gnn_mwvc_tpu_torch.ops import _build
from gnn_mwvc_tpu_torch.solver import cli
from gnn_mwvc_tpu_torch.solver.pipeline import solve

path, sol, device, repo = sys.argv[1:5]
g = read_metis(path)
# warm-up: the native core's and the kernels' builds, the device's context
solve(build_road_graph(40), time_limit=0.0, device=device, device_assist=False)


def record(surface, p1, t_gnn, cost, launches):
    sc = p1.get("scorer") or {}
    return {"repo": repo, "surface": surface, "t_phase1_s": t_gnn,
            "t_reduce_s": p1["t_reduce0_s"], "t_score_s": p1["t_score_s"],
            "t_peel_s": p1["t_peel_s"], "spans": p1.get("spans"),
            "rounds": p1["rounds"], "sticky_rounds": sc.get("rounds"),
            "legacy_rounds": sc.get("legacy_rounds"),
            "kernel_edges_uncovered": p1.get("kernel_edges_uncovered"),
            "dependent_folds": p1.get("dependent_folds"),
            "cost": cost, "launches": launches}


_build.launches.clear()
res = solve(g, time_limit=0.0, device=device, device_assist=False)
print(json.dumps(record("solve()", res.phase1, res.time_gnn, res.cost,
                        dict(_build.launches))), flush=True)

_build.launches.clear()
out = sys.stdout
sys.stdout = open(sol + ".log", "w")
try:
    rc = cli.main([path, sol, "0", "-1", "0", "--json", "--device", device,
                   "--no-device-assist"])
finally:
    sys.stdout.close()
    sys.stdout = out
with open(sol + ".log") as f:
    last = f.read().strip().splitlines()[-1]
if rc != 0:   # e.g. "Result is not a vertex cover"
    print(json.dumps({"repo": repo, "surface": "gnn-vc-torch", "rc": rc,
                      "error": last}), flush=True)
else:
    rec = json.loads(last)
    print(json.dumps(record("gnn-vc-torch", rec["phase1"], rec["time_gnn"],
                            rec["cost"], dict(_build.launches))), flush=True)
"""


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--side", type=int, default=1200)
    ap.add_argument("--repos", default=HERE,
                    help="comma-separated checkouts, run in this order")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from gnn_mwvc_tpu_torch.graph import build_road_graph
    from gnn_mwvc_tpu_torch.graphio import write_metis

    records = []
    with tempfile.TemporaryDirectory(prefix="phase1_split_") as tmp:
        path = os.path.join(tmp, f"road{args.side}.metis")
        write_metis(path, build_road_graph(args.side))
        for i, repo in enumerate(args.repos.split(",")):
            repo = os.path.abspath(repo)
            out = subprocess.run(
                [sys.executable, "-c", RUN, path,
                 os.path.join(tmp, f"{i}.sol"), args.device, repo],
                cwd=repo, env=dict(os.environ, PYTHONPATH=repo),
                capture_output=True, text=True)
            if out.returncode != 0:
                raise RuntimeError(f"{repo}: exit {out.returncode}\n"
                                   f"{out.stderr[-3000:]}")
            for ln in out.stdout.splitlines():
                if ln.startswith("{"):
                    records.append(json.loads(ln))
                    print(ln, flush=True)
    print(json.dumps(records))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
