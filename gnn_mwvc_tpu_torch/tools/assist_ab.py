"""Phase-2 A/B at equal budget on a dumped kernel (``tools/dump_kernel.py``):

  plain    - ILS with uniform force-k kicks
  guided   - ILS with kicks guided by model misfit
  regions  - uniform kicks + batches of regions solved exactly by K4 on the
             device and patched back
  full     - guided kicks + region patches (the production assist)

Each variant replays the production phase-2 loop (step-size schedule, ILS
stall/kick policy of ``solve()``) from the same initial cover for --time
seconds, and prints one JSON row, with the kernel launches the variant
made (K4 in the region variants, on a card).  On a card the assist keeps
one batch in flight and never blocks the search.

Usage:
    python -m gnn_mwvc_tpu_torch.tools.assist_ab kernel_road900.npz
        --time 300 --seeds 1,2 [--rmax 14|20] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from gnn_mwvc_tpu_torch.core import CoreLocalSearch
from gnn_mwvc_tpu_torch.graph import resolve_device
from gnn_mwvc_tpu_torch.ops import _build
from gnn_mwvc_tpu_torch.solver.device_assist import DeviceAssist
from gnn_mwvc_tpu_torch.tools._common import default_out

VARIANTS = ("plain", "guided", "regions", "full")


def run_variant(kern, variant, budget, seed, device, assist_batch=1024,
                rmax=14):
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    ls = CoreLocalSearch(kern["weights"], kern["edges"], kern["s0"])
    bias = np.clip(1.0 - kern["prob"], 0.05, 1.0).astype(np.float32)
    guided = variant in ("guided", "full")
    launches_before = dict(_build.launches)
    assist = None
    if variant in ("regions", "full"):
        assist = DeviceAssist(kern["prob"], device=device, batch=assist_batch,
                              rmax=rmax, seed=seed)
    t0 = time.perf_counter()
    t_best = t0
    step_size = 1 << 16
    stalled = 0
    kicks = 0
    k_cur = 16
    best_at_kick = 1 << 62
    try:
        while time.perf_counter() - t0 < budget:
            remaining = budget - (time.perf_counter() - t0)
            if ls.search(step_size, remaining):
                stalled = 0
                t_best = time.perf_counter()
                step_size = min(step_size * 2, 1 << 16)
            else:
                step_size = max(step_size // 2, 1 << 10)
                if step_size == 1 << 10:
                    stalled += 1
                    if stalled >= 256:
                        stalled = 0
                        kicks += 1
                        k_cur = 16 if ls.best_cost < best_at_kick else min(
                            k_cur * 2, 4096)
                        best_at_kick = ls.best_cost
                        ls.restore_best()
                        if guided:
                            ls.perturb_guided(k_cur, seed + kicks, bias)
                        else:
                            ls.perturb(k_cur, seed + kicks)
                        step_size = 1 << 16
            if assist is not None:
                prev_best = ls.best_cost
                assist.tick(ls)
                if ls.best_cost < prev_best:
                    t_best = time.perf_counter()
    finally:
        if assist is not None:
            assist.stop()
    return {
        "variant": variant, "seed": seed,
        "best_cost": int(ls.best_cost), "best_seen": int(ls.best_seen),
        "steps": int(ls.steps), "kicks": kicks,
        "t_best": round(t_best - t0, 1),
        "assist": dict(assist.stats) if assist else None,
        "launches": {k: n - launches_before.get(k, 0)
                     for k, n in _build.launches.items()
                     if n > launches_before.get(k, 0)},
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kernel", help="npz from dump_kernel (either package)")
    ap.add_argument("--time", type=float, default=300.0)
    ap.add_argument("--seeds", default="1")
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--rmax", type=int, default=14,
                    help="region size cap: width-16 regions up to 16, "
                         "width 20 above (20 is the production assist's)")
    ap.add_argument("--out", default=None,
                    help="JSON path (default: assist_ab.json in the "
                         "temporary directory)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if not 1 <= args.rmax <= 20:
        ap.error("--rmax must be in 1..20")

    kern = dict(np.load(args.kernel))
    init = int(kern["initial_cost"])
    rows = []
    for seed in map(int, args.seeds.split(",")):
        for variant in args.variants.split(","):
            r = run_variant(kern, variant, args.time, seed, device,
                            assist_batch=args.batch, rmax=args.rmax)
            r["total_with_init"] = r["best_cost"] + init
            rows.append(r)
            print(json.dumps(r), flush=True)
    out = args.out or default_out("assist_ab.json")
    with open(out, "w") as f:
        json.dump({"kernel": args.kernel, "time": args.time,
                   "device": str(device), "rmax": args.rmax, "rows": rows},
                  f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
