"""Host reduce against the device rule prepass plus the host finish, on a
road-like instance of the requested scale.

  host:   CoreSolver build + the full worklist ``reduce()`` to the kernel;
  device: CoreSolver build + ``device_reduce_prepass`` (rule-mask rounds on
          the device, bulk-applied on the host) + ``reduce()`` to finish.

Both reach a kernel; the record has each side's seconds, kernel size and
cost, and the last line names the faster side.

Usage:
    python -m gnn_mwvc_tpu_torch.tools.reduce_scale [--side 3600]
        [--out PATH] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time

from gnn_mwvc_tpu_torch.core import CoreSolver
from gnn_mwvc_tpu_torch.graph import build_road_graph, resolve_device
from gnn_mwvc_tpu_torch.solver.device_reduce import device_reduce_prepass
from gnn_mwvc_tpu_torch.tools._common import default_out


def run(side, device=None):
    """One side of the comparison; ``device`` None is the host reduce."""
    g = build_road_graph(side)
    t0 = time.perf_counter()
    core = CoreSolver(g.weights, g.edge_array())
    t_build = time.perf_counter() - t0

    rec = {"n": int(g.n), "e": int(g.m), "t_build": round(t_build, 3)}
    t0 = time.perf_counter()
    if device is not None:
        rec["prepass"] = device_reduce_prepass(core, device=device)
        rec["t_prepass"] = round(time.perf_counter() - t0, 3)
        rec["active_after_prepass"] = int(core.active_count)
        t0 = time.perf_counter()
    core.reduce()
    rec["t_reduce"] = round(time.perf_counter() - t0, 3)
    rec["kernel"] = int(core.active_count)
    rec["cost"] = int(core.cost)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--side", type=int, default=3600)
    ap.add_argument("--out", default=None,
                    help="JSON path (default: reduce_scale.json in the "
                         "temporary directory)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    host = run(args.side)
    print("host:", json.dumps(host), flush=True)
    dev = run(args.side, device=device)
    print("device:", json.dumps(dev), flush=True)

    rep = {"side": args.side, "device_name": str(device), "host": host,
           "device": dev}
    with open(args.out or default_out("reduce_scale.json"), "w") as f:
        json.dump(rep, f, indent=1)
    h = host["t_reduce"]
    d = dev["t_prepass"] + dev["t_reduce"]
    print(json.dumps({"host_to_kernel_s": h, "device_to_kernel_s": round(d, 3),
                      "winner": "device" if d < h else "host"}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
