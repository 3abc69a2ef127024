"""Cells that drive ``gnn_mwvc_tpu_torch.train.trainer.train``.

Traffic keys: ``graphs`` (how many instances, drawn from ``--seed``),
``train`` (``TrainConfig`` fields besides the seed), ``warmup`` (the
``epochs`` of a ``train`` call on the same samples in the set-up) and
``limits``.  The window calls
``train(samples, TrainConfig(seed=--seed, log=False, ...))`` back to back
while it has time left and closes when the last call returns; each call
starts from the trainer's own initialisation.  The benchmark makes the
instances and their 0/1 labels (``perfbench.yardstick.graphs``) and hands
the program only those.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from perfbench.reference.gnn import load_weights
from perfbench.reference.train import reference_train
from perfbench.yardstick.counts import SEA2022_LINEARS
from perfbench.yardstick.graphs import road_csr, rule_labels

__all__ = ["CONTROLS", "prepare", "window", "release", "judge", "attempts",
           "counters"]

# what stands in the program's place for the limits' upper readings: the
# control (TF32 products) and the fault "half of the batch left out"; the
# fault "a step that leaves the state unchanged" reads 1 by construction
CONTROLS = ("tf32", "half_batch")


def _samples(csrs, labels, device, names):
    from gnn_mwvc_tpu_torch.graph import Graph
    from gnn_mwvc_tpu_torch.train import make_sample

    return [make_sample(Graph.from_csr(*c), y, name, device=device)
            for c, y, name in zip(csrs, labels, names)]


def prepare(config, traffic, seed, seconds, device):
    from gnn_mwvc_tpu_torch.train import TrainConfig, train

    t0 = time.perf_counter()
    seeds = np.random.default_rng(seed).integers(
        0, 2**31, size=traffic["graphs"]).tolist()

    def instance(s):
        csr = road_csr(config["side"], s, config["extra"])
        return csr, rule_labels(*csr)

    # numpy's sorts release the interpreter lock: the graphs build at once
    with ThreadPoolExecutor(len(seeds)) as pool:
        csrs, labels = map(list, zip(*pool.map(instance, seeds)))
    t1 = time.perf_counter()
    samples = _samples(csrs, labels, device, [f"road{s}" for s in seeds])
    t2 = time.perf_counter()
    # the warm-up is a call on the window's own samples, so every shape the
    # window uses is met once before it opens
    train(samples, TrainConfig(**{**traffic["train"],
                                  "epochs": traffic["warmup"]["epochs"]},
                               seed=seed, log=False), device=device)
    cfg = TrainConfig(**traffic["train"], seed=seed, log=False)
    parts = {"instances_s": t1 - t0, "samples_s": t2 - t1,
             "warmup_s": time.perf_counter() - t2}
    return {"setup_parts": parts, "config": config, "traffic": traffic,
            "seed": seed, "device": device, "csrs": csrs, "labels": labels,
            "samples": samples, "cfg": cfg, "train": train, "calls": [],
            "error": None}


def window(state, seconds, span):
    deadline = time.perf_counter() + seconds
    try:
        while time.perf_counter() < deadline:
            t0 = time.perf_counter()
            with span("train"):
                model, history = state["train"](state["samples"],
                                                state["cfg"],
                                                device=state["device"])
            state["calls"].append({"seconds": time.perf_counter() - t0,
                                   "model": model, "history": history})
    except Exception as e:  # a failed call ends the window; judged below
        import traceback

        traceback.print_exc()
        state["error"] = repr(e)


def release(state):
    """Keep each call's parameters on the host; free the program's state."""
    for c in state["calls"]:
        c["params"] = [(lin.weight.detach().cpu().numpy(),
                        lin.bias.detach().cpu().numpy())
                       for lin in c.pop("model").linears]
    state["samples"] = None


def _leaf_gap(params, ref):
    """The worst leaf's gap between the program's and the reference's norm
    of the change from the first parameters, against the larger of the
    reference's norm for that leaf and the median leaf's.  Leaves whose
    first reference gradient is under a thousandth of the median leaf's
    are left out (they move by rounding alone)."""
    init = [a for wb in ref["initial"] for a in wb]
    fin = [a for wb in ref["final"] for a in wb]
    grad = [a for wb in ref["first_grad"] for a in wb]
    prog = [np.asarray(a, np.float64) for wb in params for a in wb]
    gnorm = np.array([np.linalg.norm(g) for g in grad])
    keep = gnorm >= 1e-3 * np.median(gnorm)
    rnorm = np.array([np.linalg.norm(f.astype(np.float64) - i)
                      for f, i in zip(fin, init)])
    pnorm = np.array([np.linalg.norm(p - i) if p.shape == i.shape else np.inf
                      for p, i in zip(prog, init)])
    scale = np.maximum(rnorm, np.median(rnorm[keep]))
    return float((np.abs(pnorm - rnorm) / scale)[keep].max())


def judge(state, control=None):
    cfg = state["cfg"]
    limits = state["traffic"]["limits"]
    kinds, _ = load_weights()
    common = dict(kinds=kinds, dims=SEA2022_LINEARS, seed=state["seed"],
                  passes=cfg.epochs + 1, lr=cfg.lr, momentum=cfg.momentum,
                  batch_vertices=cfg.batch_vertices,
                  weight_scale=cfg.weight_scale, device=state["device"])
    if "reference" not in state:
        state["reference"] = reference_train(state["csrs"], state["labels"],
                                             **common)
    ref = state["reference"]
    if control:
        ctl = reference_train(state["csrs"], state["labels"],
                              **{control: True}, **common)
        runs = [{"history": [{"train": {"loss": a}, "test": {"loss": b},
                              "steps": s} for a, b, s in
                             zip(ctl["train_loss"], ctl["test_loss"],
                                 ctl["steps"])],
                 "params": ctl["final"]}]
    else:
        runs = state["calls"]
    loss_gap = step_gap = change_gap = 0.0
    for c in runs:
        h = c["history"]
        if len(h) != len(ref["steps"]):
            loss_gap = float("inf")
            continue
        for p, a, b, s in zip(h, ref["train_loss"], ref["test_loss"],
                              ref["steps"]):
            loss_gap = max(loss_gap, abs(p["train"]["loss"] - a) / a)
            if b:
                loss_gap = max(loss_gap, abs(p["test"]["loss"] - b) / b)
            step_gap = max(step_gap, abs(p["steps"] - s))
        change_gap = max(change_gap, _leaf_gap(c["params"], ref))
    return {"loss_gap": {"value": loss_gap, "limit": limits["loss_gap"]},
            "step_gap": {"value": step_gap, "limit": limits["step_gap"]},
            "change_gap": {"value": change_gap,
                           "limit": limits["change_gap"]}}


def attempts(state):
    return (len(state["calls"]) + (1 if state["error"] else 0),
            1 if state["error"] else 0)


def counters(state):
    """What the metric readers read: per completed call its seconds and,
    per pass, the training-set vertices and directed edges and the
    evaluated vertices and edges."""
    n = [len(c[0]) for c in state["csrs"]]
    nnz = [len(c[2]) for c in state["csrs"]]
    rng = np.random.default_rng(state["seed"])
    idx = np.arange(len(n))
    rng.shuffle(idx)
    split = int(len(n) * 0.9)
    tr, te = idx[:split], idx[split:]
    per_pass = {"train_n": sum(n[i] for i in tr),
                "train_nnz": sum(nnz[i] for i in tr),
                "eval_n": sum(n[i] for i in idx),
                "eval_nnz": sum(nnz[i] for i in idx),
                "train_graphs": [(n[i], nnz[i]) for i in tr],
                "eval_graphs": [(n[i], nnz[i]) for i in np.concatenate(
                    [tr, te])]}
    return {"calls": [{"seconds": c["seconds"],
                       "passes": len(c["history"])} for c in state["calls"]],
            "per_pass": per_pass}
