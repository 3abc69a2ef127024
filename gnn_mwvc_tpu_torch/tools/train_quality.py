"""Quality of a model trained by the port against the published weights.

The JAX tool's chain, through the port on ``--device``: a corpus of
random-weight instances (``corpus``) -> 3-rule kernels (``gen_reduced_graph``)
-> labels from the port's own ``solve`` at ``--label-budget`` seconds ->
``gnn-train-torch`` for ``--epochs`` -> on each held-out instance
(``heldout``), the trained and the published model through ``solve`` with a
per-snapshot ``GnnScorer``:

  * the phase-1 cover (``time_limit=0``: the GNN peel alone, the model's
    direct contribution), and
  * the best cover seen at ``--eval-budget`` seconds, and that solve's
    assist counts (``assist``: batches, patches, ``wide_patches``; null
    where the solve ran without the assist).

The corpus and held-out graphs are the JAX tool's, bit for bit (the port's
``random_graph``, ``powerlaw_graph`` and ``build_road_graph``).  ``corpus``
and ``heldout`` are module-level, so a caller can run a smaller set.  A
kernel under 150 vertices or with a label share outside [0.2, 0.8] is
skipped, and labels already in ``--workdir`` are reused, as in JAX.
Writes a JSON report; its last stdout line is the worst and mean final
deltas in percent.

Usage:
    python -m gnn_mwvc_tpu_torch.tools.train_quality [--epochs 120]
        [--label-budget 4] [--eval-budget 10] [--out PATH] [--workdir DIR]
        [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from gnn_mwvc_tpu_torch.graph import (build_road_graph, powerlaw_graph,
                                      random_graph)
from gnn_mwvc_tpu_torch.graphio import write_edge_graph
from gnn_mwvc_tpu_torch.models import MWVCModel, load_model, pretrained_model
from gnn_mwvc_tpu_torch.solver.pipeline import GnnScorer, resolve_device, solve
from gnn_mwvc_tpu_torch.tools._common import default_out
from gnn_mwvc_tpu_torch.train.cli import main as train_main
from gnn_mwvc_tpu_torch.train.data import gen_reduced_graph


def corpus(rng=None):
    """Training instances, ``(name, Graph)``: 10 random, 16 power-law and 4
    road-like graphs (``rng`` is unused, as in the JAX tool)."""
    graphs = []
    for i in range(10):
        graphs.append((f"er{i}", random_graph(
            2000 + 900 * i, 8 + (i % 4) * 2, seed=100 + i, wmax=1000)))
    for i in range(16):
        graphs.append((f"pl{i}", powerlaw_graph(
            3000 + 1000 * i, 3 + (i % 3), seed=200 + i)))
    for i, side in enumerate((40, 55, 70, 85)):
        graphs.append((f"grid{i}", build_road_graph(side, seed=300 + i)))
    return graphs


def heldout():
    """Held-out instances, ``(name, Graph)``."""
    return [
        ("er12k", random_graph(12_000, 10, seed=901, wmax=1000)),
        ("er25k", random_graph(25_000, 14, seed=902, wmax=1000)),
        ("pl15k", powerlaw_graph(15_000, 4, seed=903)),
        ("grid110", build_road_graph(110, seed=904)),
        ("grid160", build_road_graph(160, seed=905)),
    ]


def label_corpus(gdir: str, ldir: str, budget: float, device) -> int:
    """Kernelise and label the corpus into ``gdir``/``ldir``; returns the
    number of samples kept."""
    kept = 0
    for name, g in corpus(np.random.default_rng(0)):
        gp = os.path.join(gdir, f"{name}.mtx")
        lp = os.path.join(ldir, f"{name}.txt")
        if os.path.exists(lp):
            kept += 1
            continue
        kernel, _cost, _ids = gen_reduced_graph(g)
        if kernel.n < 150:
            print(f"corpus {name}: fully reduced (kernel {kernel.n}), skip",
                  flush=True)
            continue
        res = solve(kernel, time_limit=budget, ls_seed=3, device=device)
        y = res.solution.astype(int)
        frac = y.mean()
        if not 0.2 <= frac <= 0.8:
            print(f"corpus {name}: class imbalance {frac:.2f}, skip",
                  flush=True)
            continue
        write_edge_graph(gp, kernel)
        np.savetxt(lp, y, fmt="%d")
        kept += 1
        print(f"corpus {name}: kernel n={kernel.n} cover_frac={frac:.2f}",
              flush=True)
    return kept


def pct(new: int, old: int) -> float:
    return 100.0 * (new - old) / max(old, 1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=120)
    ap.add_argument("--label-budget", type=float, default=4.0)
    ap.add_argument("--eval-budget", type=float, default=10.0)
    ap.add_argument("--out", default=None,
                    help="JSON path (default: train_quality.json in the "
                         "temporary directory)")
    ap.add_argument("--workdir", default=None,
                    help="corpus, labels and model (default: train_quality/ "
                         "in the temporary directory)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    workdir = args.workdir or default_out("train_quality")
    gdir = os.path.join(workdir, "graphs")
    ldir = os.path.join(workdir, "labels")
    os.makedirs(gdir, exist_ok=True)
    os.makedirs(ldir, exist_ok=True)

    t0 = time.perf_counter()
    kept = label_corpus(gdir, ldir, args.label_budget, device)
    t_corpus = time.perf_counter() - t0
    print(f"corpus: {kept} samples in {t_corpus:.1f}s", flush=True)

    model_path = os.path.join(workdir, "model.txt")
    t0 = time.perf_counter()
    if train_main([gdir, ldir, model_path, str(args.epochs), "0",
                   "--device", str(device)]) != 0:
        raise RuntimeError("gnn-train-torch failed")
    t_train = time.perf_counter() - t0
    print(f"training: {args.epochs} epochs in {t_train:.1f}s", flush=True)

    models = {"published": pretrained_model(device),
              "trained": MWVCModel.from_spec(load_model(model_path), device)}
    rows = []
    for name, g in heldout():
        row = {"name": name, "n": int(g.n)}
        for tag, model in models.items():
            res0 = solve(g, time_limit=0.0, device=device,
                         scorer=GnnScorer(model, device))
            res = solve(g, time_limit=args.eval_budget, device=device,
                        scorer=GnnScorer(model, device), ls_seed=5)
            row[tag] = {"phase1": int(res0.cost), "final": int(res.best_seen),
                        "assist": res.assist_stats}
        row["delta_final_pct"] = pct(row["trained"]["final"],
                                     row["published"]["final"])
        row["delta_phase1_pct"] = pct(row["trained"]["phase1"],
                                      row["published"]["phase1"])
        print(name, row["published"]["final"], row["trained"]["final"],
              f"d_final={row['delta_final_pct']:.4f}% "
              f"d_phase1={row['delta_phase1_pct']:.4f}%", flush=True)
        rows.append(row)

    finals = [r["delta_final_pct"] for r in rows]
    rep = {"epochs": args.epochs, "samples": kept, "rows": rows,
           "label_budget": args.label_budget,
           "eval_budget": args.eval_budget, "device": str(device),
           "t_corpus_s": t_corpus, "t_train_s": t_train,
           "worst_final_delta_pct": max(map(abs, finals))}
    with open(args.out or default_out("train_quality.json"), "w") as f:
        json.dump(rep, f, indent=1)
    print(json.dumps({"worst_final_delta_pct": rep["worst_final_delta_pct"],
                      "mean_final_delta_pct": float(np.mean(finals)),
                      "mean_phase1_delta_pct": float(np.mean(
                          [r["delta_phase1_pct"] for r in rows]))}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
