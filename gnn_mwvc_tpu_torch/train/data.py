"""Training data: the 3-rule kernelisation and the labelled-set loader.

The data-prep chain of the reference (and of the JAX package's
``train/data.py``): a weighted graph is reduced with the first three
reduction rules (neighbourhood, twin, domination) by the native core
(``gen_reduced_graph``); the kernel is written in the edge-list format and
labelled 0/1 per vertex; ``load_training_set`` pairs graphs with label files
and drops graphs where either class holds at most 20% of the vertices.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from gnn_mwvc_tpu_torch.core import CoreSolver
from gnn_mwvc_tpu_torch.graph import DeviceGraph, Graph
from gnn_mwvc_tpu_torch.graphio import read_edge_graph

__all__ = ["TrainSample", "make_sample", "load_training_set",
           "gen_reduced_graph"]


@dataclasses.dataclass
class TrainSample:
    """One labelled graph on the training device.  The port does not pad,
    so ``mask`` is all-true over the ``n`` rows; it is kept so the loss
    reads like the JAX package's."""

    dg: DeviceGraph
    y: torch.Tensor      # (n,) float32 0/1 labels
    mask: torch.Tensor   # (n,) bool
    n: int
    name: str = ""


def make_sample(g: Graph, labels: np.ndarray, name: str = "",
                device="cuda") -> TrainSample:
    labels = np.asarray(labels, np.float32)
    if labels.shape != (g.n,):
        raise ValueError(f"{name}: {labels.shape} labels for {g.n} vertices")
    dg = DeviceGraph.from_graph(g, device)
    y = torch.from_numpy(labels.copy()).to(device)
    mask = torch.ones(g.n, dtype=torch.bool, device=device)
    return TrainSample(dg=dg, y=y, mask=mask, n=g.n, name=name)


def load_training_set(graph_dir, label_dir, min_class_frac=0.2,
                      graph_suffix=".mtx", device="cuda"):
    """Pair each label file with its graph; drop class-imbalanced graphs."""
    samples = []
    for entry in sorted(os.listdir(label_dir)):
        stem = os.path.splitext(entry)[0]
        gpath = os.path.join(graph_dir, stem + graph_suffix)
        if not os.path.exists(gpath):
            continue
        g = read_edge_graph(gpath)
        y = np.loadtxt(os.path.join(label_dir, entry)).reshape(-1)[:g.n]
        tc = float((y > 0.5).sum())
        fc = float(g.n - tc)
        if tc <= g.n * min_class_frac or fc <= g.n * min_class_frac:
            continue
        samples.append(make_sample(g, (y > 0.5).astype(np.float32), stem,
                                   device=device))
    return samples


def gen_reduced_graph(g: Graph):
    """3-rule kernelisation; returns (kernel Graph, cost_paid, org_ids).

    org_ids maps kernel vertices back to original ids."""
    core = CoreSolver(g.weights, g.edge_array(), num_rules=3)
    core.reduce(critical=False)
    snap = core.snapshot()
    rows = np.repeat(np.arange(snap.n, dtype=np.int64),
                     np.diff(snap.indptr.astype(np.int64)))
    keep = rows < snap.indices
    edges = np.stack([rows[keep], snap.indices[keep].astype(np.int64)], axis=1)
    kernel = Graph(snap.weights.astype(np.int64), edges)
    return kernel, core.cost, snap.ids.copy()
