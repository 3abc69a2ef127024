"""The plain reference of the vertex-scoring GNN: the published SEA-2022
network's forward in plain PyTorch float32 (no kernel, no cache, no
batching), read from the benchmark's own copy of the weights file, and its
initialisation and SGD training for the training cell.

A graph layer outputs ``[agg | x | stats]`` with stats = (D, W/ws, NW/ws)
written from column w + 1 over a zero tail (the layout the published
weights were trained with; for w = 1 it is the plain concatenation).  The
first graph layer's input is W/ws, so its neighbour sum is NW/ws.

``tf32=True`` is the control: every product's inputs rounded to TF32 (10
mantissa bits, to nearest even) before a float32 product, as a card's TF32
mode computes, on any device.  Otherwise products run with TF32 off.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from perfbench.reference import threefry

__all__ = ["WEIGHTS_PATH", "load_weights", "init_weights", "fp32_products",
           "forward", "GraphArrays", "graph_arrays"]

WEIGHTS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "sea2022_weights.txt")
_KINDS = {"Graph_Layer": "graph", "Linear_Layer": "linear",
          "ReLU_Activation": "relu", "Sigmoid_Activation": "sigmoid"}


def load_weights(path: str = WEIGHTS_PATH):
    """(kinds, [(W (in, out), b (out,)) float32 numpy per linear layer])
    of a model in the reference's text format."""
    toks = open(path).read().split()
    pos = 2  # name, layer count
    n = int(toks[1])
    if toks[pos] != "Layers":
        raise ValueError(f"{path}: not a model file")
    pos += 1
    kinds, linears = [], []
    for _ in range(n):
        kind = _KINDS[toks[pos]]
        pos += 1
        kinds.append(kind)
        if kind != "linear":
            continue
        h, w = int(toks[pos + 1]), int(toks[pos + 2])
        pos += 3
        wm = np.array(toks[pos:pos + h * w], np.float32).reshape(h, w)
        pos += h * w
        bw = int(toks[pos + 2])
        pos += 3
        b = np.array(toks[pos:pos + bw], np.float32)
        pos += bw
        linears.append((wm, b))
    return tuple(kinds), linears


def init_weights(kinds, dims, seed: int):
    """The trainer's first parameters from ``seed``: linear layer i draws
    U(-lim, lim), lim = 1/sqrt(in + 1), its (in, out) weight from the
    first of the two keys split from key(seed + i) and its bias from the
    second."""
    out = []
    for i, (din, dout) in enumerate(dims):
        lim = 1.0 / np.sqrt(din + 1)
        kw, kb = threefry.split(threefry.key(seed + i))
        out.append((threefry.uniform(kw, (din, dout), -lim, lim),
                    threefry.uniform(kb, (dout,), -lim, lim)))
    return out


@contextlib.contextmanager
def fp32_products():
    """Float32 products with TF32 off on a card, whatever the process had."""
    flags = torch.backends.cuda.matmul
    saved = {}
    for name, value in (("allow_tf32", False), ("fp32_precision", "ieee")):
        if hasattr(flags, name):
            saved[name] = getattr(flags, name)
            setattr(flags, name, value)
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        for name, value in saved.items():
            setattr(flags, name, value)
        torch.backends.cudnn.allow_tf32 = cudnn


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to 10 mantissa bits, to nearest even (finite inputs); the
    gradient passes through unchanged."""
    d = x.detach().contiguous()
    i = d.view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return x + (i.view(torch.float32) - d)


class GraphArrays:
    """One graph on a torch device: rows/cols of every directed edge that
    the neighbour sums run over, and the per-vertex features."""

    def __init__(self, n, rows, cols, w, deg, nw):
        self.n, self.rows, self.cols = n, rows, cols
        self.w, self.deg, self.nw = w, deg, nw


def graph_arrays(weights, indptr, indices, device, agg_keep=None):
    """GraphArrays of a symmetric CSR.  D and NW count every edge;
    ``agg_keep`` (bool per CSR entry) limits the neighbour sums to the kept
    entries."""
    weights = np.asarray(weights, np.int64)
    indptr = np.asarray(indptr, np.int64)
    indices = np.asarray(indices, np.int64)
    n = len(weights)
    deg = np.diff(indptr)
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    nw = np.bincount(rows, weights=weights[indices].astype(np.float64),
                     minlength=n)
    if agg_keep is not None:
        rows, indices = rows[agg_keep], indices[agg_keep]

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    return GraphArrays(n, put(rows, np.int64), put(indices, np.int64),
                       put(weights, np.float32), put(deg, np.float32),
                       put(nw, np.float32))


def _neighbour_sum(h, g):
    return torch.zeros_like(h).index_add_(0, g.rows, h[g.cols])


def forward(kinds, linears, g: GraphArrays, weight_scale: float,
            tf32: bool = False) -> torch.Tensor:
    """(n,) scores.  ``linears``: [(W (in, out), b (out,))] as tensors on
    the graph's device (autograd flows through them when they require
    it)."""
    h = (g.w / weight_scale).reshape(-1, 1)
    first = True
    it = iter(linears)
    with fp32_products():
        for kind in kinds:
            if kind == "linear":
                wm, b = next(it)
                h = (_tf32(h) @ _tf32(wm) if tf32 else h @ wm) + b
            elif kind == "relu":
                h = torch.relu(h)
            elif kind == "sigmoid":
                h = torch.sigmoid(h)
            else:
                width = h.shape[1]
                agg = ((g.nw / weight_scale).reshape(-1, 1) if first
                       else _neighbour_sum(h, g))
                first = False
                stats = torch.stack([g.deg, g.w / weight_scale,
                                     g.nw / weight_scale], dim=1)
                out = torch.cat([agg, h, h.new_zeros(g.n, 3)], dim=1)
                h = torch.cat([out[:, :width + 1], stats,
                               out[:, width + 4:]], dim=1)
    return h[:, 0]
