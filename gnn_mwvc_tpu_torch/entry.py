"""Entry points: one scoring step of the published model, and the
multi-device dry run.

    python -m gnn_mwvc_tpu_torch.entry [--device cuda]
    python -m gnn_mwvc_tpu_torch.entry multichip [N] [--device cuda]

The first runs ``fn(*example_args)`` of ``entry()`` once and prints
``entry ok:`` with its first 4 scores.  ``multichip N`` (default 8) is
``parallel.dryrun local N``: a train step, a forward and a sharded solve
over N shards (``--device cuda``: one per card; ``cuda:0`` or ``cpu``: all
N there).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from gnn_mwvc_tpu_torch.graph import DeviceGraph, resolve_device
from gnn_mwvc_tpu_torch.models import pretrained_model
from gnn_mwvc_tpu_torch.parallel import dryrun

__all__ = ["entry", "main"]


def entry(device="cuda"):
    """``(fn, example_args)``: ``fn(model, dg, weight_scale)`` is the
    solver's forward of the 21-layer SEA-2022 model (``x_is_node_weights``,
    fp32 products) and returns the score column; the example is the
    4096-node, degree-16 synthetic graph of ``dryrun.synthetic_graph``."""
    device = resolve_device(device)
    g = dryrun.synthetic_graph()
    dg = DeviceGraph.from_graph(g, device)

    @torch.no_grad()
    def fn(model, dg, weight_scale):
        x = (dg.weights / weight_scale).reshape(-1, 1)
        return model(x, dg, weight_scale, x_is_node_weights=True)[:, 0]

    return fn, (pretrained_model(device), dg, float(g.weights.max()))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", nargs="?", choices=["multichip"])
    ap.add_argument("n", nargs="?", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.mode == "multichip":
        return dryrun.main(["local", str(args.n), "--device", args.device])
    fn, example_args = entry(args.device)
    out = fn(*example_args)
    print("entry ok:", np.asarray(out[:4].cpu()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
