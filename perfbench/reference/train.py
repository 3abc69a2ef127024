"""The plain reference of ``train()``: the same data order, loss and
SGD-with-momentum step, in plain PyTorch float32 over the reference
forward (``perfbench.reference.gnn``).

Semantics followed (the reference recipe as the port's trainer states it):
a shuffled 90/10 split of the graphs from ``numpy.random.default_rng(seed)``;
each pass visits the training graphs in ``rng.permutation`` order, adds each
graph's gradient of the unnormalised squared error of its scores against
its 0/1 labels, and steps once the vertex counter ``t`` exceeds
``batch_vertices`` (the graph whose turn fires the step is in the step's
gradient but not in ``t``; ``t`` restarts at 0), and once more at the end
of a pass with ``t > 0``.  A step divides the summed gradient by ``t`` and
applies velocity = momentum * velocity + gradient (the gradient alone at
the first step), parameter -= lr * velocity.  After each pass the mean
squared error over the training and the test graphs is evaluated.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.gnn import forward, graph_arrays, init_weights

__all__ = ["reference_train"]


def reference_train(graphs, labels, kinds, dims, seed: int, passes: int,
                    lr: float, momentum: float, batch_vertices: int,
                    weight_scale: float, device, tf32: bool = False,
                    half_batch: bool = False):
    """graphs: [(weights, indptr, indices)] numpy; labels: [(n,) 0/1].
    ``tf32`` and ``half_batch`` give the control and a fault, not the
    reference: TF32 products, and each training graph's gradient taken
    over its first half of vertices alone, doubled (the mean over the
    rest).

    Returns a dict: ``train_loss`` and ``test_loss`` per pass, ``steps`` per
    pass, ``initial`` and ``final`` parameters as [(W (out, in), b)] numpy
    (``nn.Linear``'s layout) and ``first_grad``, the first step's gradient
    per leaf in the same layout."""
    rng = np.random.default_rng(seed)
    gs = [graph_arrays(*g, device) for g in graphs]
    ys = [torch.from_numpy(np.asarray(y, np.float32)).to(device)
          for y in labels]
    init = init_weights(kinds, dims, seed)
    params = [(torch.tensor(w, device=device, requires_grad=True),
               torch.tensor(b, device=device, requires_grad=True))
              for w, b in init]
    leaves = [p for wb in params for p in wb]
    velocity = [None] * len(leaves)

    idx = np.arange(len(graphs))
    split = int(len(graphs) * 0.9)
    rng.shuffle(idx)
    train_idx, test_idx = idx[:split], idx[split:]

    def sse(i, train=False):
        out = forward(kinds, params, gs[i], weight_scale, tf32)
        if train and half_batch:
            h = gs[i].n // 2
            return 2 * ((out[:h] - ys[i][:h]) ** 2).sum()
        return ((out - ys[i]) ** 2).sum()

    first_grad = None

    def step(t):
        nonlocal first_grad
        with torch.no_grad():
            grads = [p.grad / t for p in leaves]
            if first_grad is None:
                first_grad = [g.detach().clone() for g in grads]
            for k, (p, g) in enumerate(zip(leaves, grads)):
                velocity[k] = (g.clone() if velocity[k] is None
                               else momentum * velocity[k] + g)
                p -= lr * velocity[k]
                p.grad = None

    def mean_sse(ids):
        if not len(ids):
            return 0.0
        with torch.no_grad():
            tot = sum(float(sse(i)) for i in ids)
        return tot / sum(gs[i].n for i in ids)

    hist = {"train_loss": [], "test_loss": [], "steps": []}
    for _ in range(passes):
        order = rng.permutation(len(train_idx))
        t = steps = 0
        for j in order:
            i = train_idx[j]
            sse(i, train=True).backward()
            if t > batch_vertices:
                step(t)
                steps += 1
                t = 0
            else:
                t += gs[i].n
        if t > 0:
            step(t)
            steps += 1
        hist["steps"].append(steps)
        hist["train_loss"].append(mean_sse(train_idx))
        hist["test_loss"].append(mean_sse(test_idx))

    def nn_layout(ps):
        return [(w.detach().T.contiguous().cpu().numpy(),
                 b.detach().cpu().numpy()) for w, b in ps]

    hist["initial"] = [(np.ascontiguousarray(w.T), b) for w, b in init]
    hist["final"] = nn_layout(params)
    hist["first_grad"] = [(first_grad[2 * k].T.contiguous().cpu().numpy(),
                           first_grad[2 * k + 1].cpu().numpy())
                          for k in range(len(params))]
    return hist
