"""K4 against the plain enumeration: exact small MWVC in regions/s.

Batches of ``--batch`` random regions (the JAX tool's generator and seed)
at n = 16 and n = 20.  First K4's results are checked equal to its plain
version (``small_mwvc_mitm_plain``) at both widths and, at n = 16, to the
2^16-subset enumeration (``ops/smallsolve.py::batched_small_mwvc``).  Then
each is timed: the mean of ``--per`` back-to-back calls between CUDA events
(the host clock on the CPU), best of ``--bursts``; the enumeration at
n = 16 only, as in JAX.  On the CPU ``small_mwvc_mitm`` runs its plain
version, so keep ``--batch`` small there.

Usage:
    python -m gnn_mwvc_tpu_torch.tools.smallsolve_bench [--batch 1024]
        [--bursts 4] [--per 5] [--out PATH] [--device cuda]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from gnn_mwvc_tpu_torch.graph import resolve_device
from gnn_mwvc_tpu_torch.ops.smallsolve import batched_small_mwvc
from gnn_mwvc_tpu_torch.ops.smallsolve_mitm import (small_mwvc_mitm,
                                                    small_mwvc_mitm_plain)
from gnn_mwvc_tpu_torch.tools._common import default_out, seconds_per_call


def random_batch(rng, b: int, n: int):
    """(adj, w) int32 (b, n): per region m in [n/2, n] used vertices,
    weights in [1, 999], 2m random pairs as edges; the JAX tool's
    ``random_batch``, the same numbers for the same generator."""
    adj = np.zeros((b, n), np.int32)
    w = np.zeros((b, n), np.int32)
    for k in range(b):
        m = int(rng.integers(n // 2, n + 1))
        w[k, :m] = rng.integers(1, 1000, size=m)
        for _ in range(2 * m):
            i, j = rng.integers(0, m, size=2)
            if i != j:
                adj[k, i] |= 1 << j
                adj[k, j] |= 1 << i
    return adj, w


def check_equal(fn, oracle, adj, w, what: str) -> None:
    got, want = fn(adj, w), oracle(adj, w)
    for a, b, name in zip(got, want, ("best_cost", "best_set")):
        if not torch.equal(a, b):
            raise RuntimeError(f"{what}: {name} differs")


def best_seconds(fn, adj, w, device, bursts: int, per: int) -> float:
    return min(seconds_per_call(lambda: fn(adj, w), device, per)
               for _ in range(bursts))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--bursts", type=int, default=4)
    ap.add_argument("--per", type=int, default=5)
    ap.add_argument("--out", default=None,
                    help="JSON path (default: smallsolve_bench.json in the "
                         "temporary directory)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    rng = np.random.default_rng(3)

    def put(a):
        return torch.from_numpy(a).to(device)

    adj16, w16 = map(put, random_batch(rng, args.batch, 16))
    adj20, w20 = map(put, random_batch(rng, args.batch, 20))
    check_equal(small_mwvc_mitm, batched_small_mwvc, adj16, w16,
                "K4 vs the enumeration, n=16")
    check_equal(small_mwvc_mitm, small_mwvc_mitm_plain, adj16, w16,
                "K4 vs its plain version, n=16")
    check_equal(small_mwvc_mitm, small_mwvc_mitm_plain, adj20, w20,
                "K4 vs its plain version, n=20")
    rows = {"parity_n16": "bitwise equal to the enumeration and the plain "
                          "version", "parity_n20": "bitwise equal to the "
                                                   "plain version"}
    t_enum = best_seconds(batched_small_mwvc, adj16, w16, device,
                          args.bursts, args.per)
    t_k4_16 = best_seconds(small_mwvc_mitm, adj16, w16, device, args.bursts,
                           args.per)
    t_k4_20 = best_seconds(small_mwvc_mitm, adj20, w20, device, args.bursts,
                           args.per)
    rows.update({
        "enum_n16_ms": t_enum * 1e3, "k4_n16_ms": t_k4_16 * 1e3,
        "speedup_n16": t_enum / t_k4_16,
        "enum_regions_per_s": args.batch / t_enum,
        "k4_16_regions_per_s": args.batch / t_k4_16,
        "k4_n20_ms": t_k4_20 * 1e3,
        "k4_20_regions_per_s": args.batch / t_k4_20,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "batch": args.batch,
    })
    print(json.dumps(rows))
    with open(args.out or default_out("smallsolve_bench.json"), "w") as f:
        json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
