"""GNN training: torch autograd through the port's forward.

The reference semantics, as the JAX package's ``train/trainer.py`` has them
(reference: old_files/src/lib/gnn_training.cpp, gnn_train.cpp:72-111):
unnormalised SSE of the score against the 0/1 labels; gradients summed over
graphs until the vertex counter ``t`` passes ``batch_vertices``, then one
SGD-with-momentum step on the sum divided by ``t``; a shuffled 90/10 split;
``epochs + 1`` passes; per-epoch CSV metrics with per-class accuracy; weight
scale 2000.

The counter keeps the JAX trainer's quirk, or the trajectories part: the
graph whose turn fires a step is in that step's gradient but not in ``t``,
and ``t`` restarts at 0.  The data order comes from the same numpy calls in
the same order, so both packages visit the graphs in the same sequence.

On CUDA the two neighbour sums of each forward and of each backward run
through kernel K1 (``ops/aggregate.py``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from gnn_mwvc_tpu_torch.models.gnn import (MWVCModel, build_reference_arch,
                                           init_params)
from gnn_mwvc_tpu_torch.solver.pipeline import resolve_device
from gnn_mwvc_tpu_torch.train.data import TrainSample

__all__ = ["TrainConfig", "evaluate", "loss_and_metrics", "train"]

WEIGHT_SCALE = 2000.0  # reference: gnn_train.cpp:12


@dataclasses.dataclass
class TrainConfig:
    epochs: int = 50
    lr: float = 0.01
    momentum: float = 0.9
    weight_decay: float = 0.0
    batch_vertices: int = 500_000
    weight_scale: float = WEIGHT_SCALE
    seed: int = 0
    compat: bool = True
    log: bool = True


def loss_and_metrics(model: MWVCModel, s: TrainSample, weight_scale: float,
                     compat: bool = True):
    """(sse, (tp, tn, n_true)) of one graph, all 0-d tensors; x = W/ws."""
    x = (s.dg.weights / weight_scale).reshape(-1, 1)
    out = model(x, s.dg, weight_scale, compat=compat,
                x_is_node_weights=True)[:, 0]
    err = torch.where(s.mask, out - s.y, 0.0)
    sse = (err * err).sum()
    is_true = s.mask & (s.y > 0.5)
    tp = (is_true & (out > 0.5)).sum()
    tn = (s.mask & (s.y <= 0.5) & (out < 0.5)).sum()
    return sse, (tp, tn, is_true.sum())


@torch.no_grad()
def evaluate(model: MWVCModel, samples: Sequence[TrainSample],
             weight_scale=WEIGHT_SCALE, compat=True) -> dict:
    tot_sse = tot_n = tot_tp = tot_tn = tot_true = 0.0
    for s in samples:
        sse, (tp, tn, ntrue) = loss_and_metrics(model, s, weight_scale, compat)
        tot_sse += float(sse)
        tot_n += s.n
        tot_tp += float(tp)
        tot_tn += float(tn)
        tot_true += float(ntrue)
    return {
        "loss": tot_sse / max(tot_n, 1),
        "accuracy": (tot_tp + tot_tn) / max(tot_n, 1),
        "total": int(tot_n),
        "true_accuracy": tot_tp / max(tot_true, 1),
        "true_total": int(tot_true),
    }


def _sgd_step(opt: torch.optim.SGD, t: int) -> None:
    """velocity = momentum * v + (g / t [+ 2 wd p]); p -= lr * velocity."""
    for group in opt.param_groups:
        for p in group["params"]:
            p.grad.div_(t)
    opt.step()
    opt.zero_grad()


def train(samples: Sequence[TrainSample], cfg: TrainConfig = TrainConfig(),
          model: Optional[MWVCModel] = None, device="cuda"):
    """Returns (model, history), one history entry per pass: the JAX
    package's ``epoch``/``train``/``test`` metrics plus ``steps`` (SGD steps
    taken) and ``train_seconds`` (host clock over the pass's gradients and
    steps, after a device synchronise).

    Every sample must already be on ``device``; ``model`` (default: the
    reference architecture, ``init_params`` from ``cfg.seed``) is moved
    there.  ``device="cuda"`` without CUDA raises.
    """
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    for s in samples:
        if s.dg.weights.device != device:
            raise ValueError(f"sample {s.name!r} is on {s.dg.weights.device}, "
                             f"training on {device}")
    rng = np.random.default_rng(cfg.seed)
    if model is None:
        model = init_params(MWVCModel(*build_reference_arch()), seed=cfg.seed)
    model.to(device)
    opt = torch.optim.SGD(model.parameters(), lr=cfg.lr,
                          momentum=cfg.momentum,
                          weight_decay=2.0 * cfg.weight_decay)

    idx = np.arange(len(samples))
    split = int(len(samples) * 0.9)
    rng.shuffle(idx)
    train_set = [samples[i] for i in idx[:split]]
    test_set = [samples[i] for i in idx[split:]]

    history = []
    if cfg.log:
        print("Epoch,Loss,Accuracy,Total,True accuracy,True total,"
              "Test loss,Test accuracy,Test total,Test true acc,"
              "Test true total")
    for epoch in range(cfg.epochs + 1):
        order = rng.permutation(len(train_set))
        opt.zero_grad()
        t = 0
        steps = 0
        t0 = time.perf_counter()
        for i in order:
            s = train_set[i]
            sse, _ = loss_and_metrics(model, s, cfg.weight_scale, cfg.compat)
            sse.backward()
            if t > cfg.batch_vertices:
                _sgd_step(opt, t)
                steps += 1
                t = 0
            else:
                t += s.n
        if t > 0:
            _sgd_step(opt, t)
            steps += 1
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds = time.perf_counter() - t0

        tr = evaluate(model, train_set, cfg.weight_scale, cfg.compat)
        te = evaluate(model, test_set, cfg.weight_scale, cfg.compat) \
            if test_set else dict.fromkeys(tr, 0)
        history.append({"epoch": epoch, "train": tr, "test": te,
                        "steps": steps, "train_seconds": seconds})
        if cfg.log:
            print(
                f"{epoch},{tr['loss']:.4f},{tr['accuracy'] * 100:.4f},"
                f"{tr['total']},{tr['true_accuracy'] * 100:.4f},"
                f"{tr['true_total']},{te['loss']:.4f},"
                f"{te['accuracy'] * 100:.4f},{te['total']},"
                f"{te['true_accuracy'] * 100:.4f},{te['true_total']}"
            )
    return model, history
