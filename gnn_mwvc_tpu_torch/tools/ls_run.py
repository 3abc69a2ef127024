"""Run the phase-2 local search (``CoreLocalSearch``) on a dumped phase-1
kernel (``tools/kernel_dump.py``) with the pipeline's adaptive step-size
loop, as the JAX package's ``tools/ls_run.py`` does, with the same
variants and output.  The search is deterministic in step space, so two
runs with the same ``--steps`` cap end at the same best cost; the clock
moves only steps/s.

Variants (``--variant``):
    plain    - the pipeline's phase 2 without diversification
    forget   - decay the learned edge weights on stall
    restart  - restore the best cover on stall
    perturb  - restore the best cover and remove k random cover vertices
               (k doubles while kicks find no new best, ILS)
    fw       - restore the best cover, then decay the edge weights

Output, one CSV line per event: ``init,0,0.0,cost,best_seen``;
``traj,steps,seconds,best,best_seen`` at each improvement;
``div,steps,seconds,events,k=K`` at each diversification;
``tick,...`` every 4096 batches; ``final,steps,seconds,best,best_seen,
steps_per_s``.  Costs include the kernel's initial cost.

Usage:
    python -m gnn_mwvc_tpu_torch.tools.ls_run K.kern --time 900 \\
        [--steps N] [--variant plain] [--stall 64] [--k 16] [--seed 1]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from gnn_mwvc_tpu_torch.core import CoreLocalSearch
from gnn_mwvc_tpu_torch.tools.kernel_dump import read_kernel

__all__ = ["VARIANTS", "main"]

VARIANTS = ("plain", "forget", "restart", "perturb", "fw")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kernel")
    ap.add_argument("--time", type=float, default=900.0)
    ap.add_argument("--steps", type=int, default=0, help="step cap (0 = none)")
    ap.add_argument("--variant", default="plain", choices=VARIANTS)
    ap.add_argument("--stall", type=int, default=64,
                    help="non-improving floor batches before diversifying")
    ap.add_argument("--k", type=int, default=16, help="first perturbation size")
    ap.add_argument("--scale", type=float, default=0.3, help="forget decay")
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)

    w, eu, ev, s0, c0 = read_kernel(args.kernel)
    ls = CoreLocalSearch(w, np.stack([eu, ev], 1), s0)

    t0 = time.perf_counter()

    def elapsed():
        return time.perf_counter() - t0

    step_size = 1 << 16
    total = batch = stalled = events = 0
    k_cur = args.k
    best_at_kick = 1 << 62
    max_steps = args.steps or (1 << 62)
    print(f"init,0,0.0,{ls.best_cost + c0},{ls.best_cost + c0}", flush=True)
    while elapsed() < args.time and total < max_steps:
        total += step_size
        batch += 1
        if ls.search(step_size, 1e18):
            stalled = 0
            step_size = min(step_size * 2, 1 << 16)
            print(f"traj,{total},{elapsed():.2f},{ls.best_cost + c0},"
                  f"{ls.best_seen + c0}", flush=True)
        else:
            step_size = max(step_size // 2, 1 << 10)
            if step_size == 1 << 10:
                stalled += 1
                if args.variant != "plain" and stalled >= args.stall:
                    stalled = 0
                    events += 1
                    if args.variant == "forget":
                        ls.forget(args.scale)
                    elif args.variant == "restart":
                        ls.restore_best()
                    elif args.variant == "perturb":
                        k_cur = (args.k if ls.best_cost < best_at_kick
                                 else min(k_cur * 2, 4096))
                        best_at_kick = ls.best_cost
                        ls.restore_best()
                        ls.perturb(k_cur, args.seed + events)
                        step_size = 1 << 16
                    elif args.variant == "fw":
                        ls.restore_best()
                        ls.forget(args.scale)
                    print(f"div,{total},{elapsed():.2f},{events},k={k_cur}",
                          flush=True)
        if batch % 4096 == 0:
            print(f"tick,{total},{elapsed():.2f},{ls.best_cost + c0},"
                  f"{ls.best_seen + c0}", flush=True)
    sec = elapsed()
    print(f"final,{total},{sec:.2f},{ls.best_cost + c0},"
          f"{ls.best_seen + c0},{total / sec:.0f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
