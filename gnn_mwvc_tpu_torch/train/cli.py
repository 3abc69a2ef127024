"""gnn-train-torch command line (the JAX package's ``gnn-train``, on a
torch device).

Usage: gnn-train-torch graph_path label_path out_path epochs [seed]
           [--lr --momentum --weight-decay --batch-vertices] [--device cuda]

Prints the reference's per-epoch CSV metrics and writes the trained model in
the reference text format, which both packages load.  ``--device cuda``
without a GPU raises.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(prog="gnn-train-torch")
    ap.add_argument("graph_path")
    ap.add_argument("label_path")
    ap.add_argument("out_path")
    ap.add_argument("epochs", type=int)
    ap.add_argument("seed", type=int, nargs="?", default=0)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--momentum", type=float, default=0.9)
    ap.add_argument("--weight-decay", type=float, default=0.0)
    ap.add_argument("--batch-vertices", type=int, default=500_000)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda)")
    args = ap.parse_args(argv)

    from gnn_mwvc_tpu_torch.models import save_model
    from gnn_mwvc_tpu_torch.solver.pipeline import resolve_device
    from gnn_mwvc_tpu_torch.train import (TrainConfig, load_training_set,
                                          train)

    device = resolve_device(args.device)
    samples = load_training_set(args.graph_path, args.label_path,
                                device=device)
    if not samples:
        print("No usable training graphs found")
        return 1
    n_test = max(1, int(len(samples) * 0.1))
    print(f"Training graphs: {len(samples) - n_test}, Test graphs: {n_test}")

    cfg = TrainConfig(
        epochs=args.epochs, lr=args.lr, momentum=args.momentum,
        weight_decay=args.weight_decay, batch_vertices=args.batch_vertices,
        seed=args.seed, log=True,
    )
    model, _ = train(samples, cfg, device=device)
    save_model(args.out_path, model)
    return 0


if __name__ == "__main__":
    sys.exit(main())
