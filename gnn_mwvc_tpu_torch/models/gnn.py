"""The vertex-scoring GNN as a PyTorch module.

The model is a sequence of four layer kinds: ``graph`` (message passing, out
width 2w + 3), ``linear``, ``relu`` and ``sigmoid``.  The published SEA-2022
network has 21 layers, 3 graph layers and 6,209 parameters.

A graph layer outputs ``[agg | x | stats]`` with stats = (D, W/ws, NW/ws).
With ``compat=True`` (the published weights need it) the output is
``[agg | x | 0, 0, 0]`` with the stats written starting at column w + 1: for
w = 1 that is the documented layout, for w = 16 it overwrites copied input
columns 1..3 and leaves the last three columns zero.  The trained weights
bake this in; do not "fix" it.

The forward is differentiable end to end (the neighbour sums through K1's
``autograd.Function``; the compat overwrite gives the overwritten input
columns zero gradient, as ``dynamic_update_slice`` does under ``jax.grad``),
which is what ``train/`` trains.

The linear layers are ``nn.Linear`` in float32.  ``precision`` picks their
products on a card, as the JAX forward's does: ``"highest"`` (the default)
full fp32, as the JAX reference's ``Precision.HIGHEST``; ``"default"`` TF32.
The switch holds for the call alone (``matmul_precision``).  K1 sums in
fp32 under either, so the JAX "mixed" setting (products at highest,
aggregation at default) is ``"highest"`` here.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch import nn

from gnn_mwvc_tpu_torch.graph import DeviceGraph
from gnn_mwvc_tpu_torch.models import _threefry as threefry
from gnn_mwvc_tpu_torch.models.serialize import ModelSpec, params_from_jax
from gnn_mwvc_tpu_torch.ops.aggregate import csr_aggregate

__all__ = ["MWVCModel", "PRECISIONS", "build_reference_arch", "graph_layer",
           "init_params", "matmul_precision", "score_graph"]

PRECISIONS = ("highest", "default")


@contextlib.contextmanager
def matmul_precision(precision: str):
    """cuBLAS float32 products inside the block: ``"highest"`` IEEE fp32,
    ``"default"`` TF32.  The process's setting is restored on exit, and
    whatever it was before does not reach the block.  CPU products are
    fp32 under either."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} is not one of {PRECISIONS}")
    tf32 = precision == "default"
    flags = torch.backends.cuda.matmul
    if hasattr(flags, "fp32_precision"):
        name, value = "fp32_precision", "tf32" if tf32 else "ieee"
    else:
        name, value = "allow_tf32", tf32
    before = getattr(flags, name)
    setattr(flags, name, value)
    try:
        yield
    finally:
        setattr(flags, name, before)


def graph_layer(x: torch.Tensor, agg: torch.Tensor, dg: DeviceGraph,
                weight_scale: float, compat: bool = True) -> torch.Tensor:
    """Assemble one message-passing layer's output from its aggregate."""
    n, w = x.shape
    stats = torch.stack(
        [dg.degrees, dg.weights / weight_scale, dg.nw / weight_scale], dim=1)
    if not compat:
        return torch.cat([agg, x, stats], dim=1)
    out = torch.cat([agg, x, x.new_zeros(n, 3)], dim=1)
    out[:, w + 1:w + 4] = stats
    return out


class MWVCModel(nn.Module):
    """Layer sequence ``kinds`` with one ``nn.Linear`` per linear layer."""

    def __init__(self, kinds, dims, name: str = "MWVC_Model"):
        super().__init__()
        self.kinds = tuple(kinds)
        self.name = name
        self.linears = nn.ModuleList(nn.Linear(i, o) for i, o in dims)
        if sum(k == "linear" for k in self.kinds) != len(self.linears):
            raise ValueError("one (in, out) pair per linear layer is needed")

    @classmethod
    def from_spec(cls, spec: ModelSpec, device=None) -> "MWVCModel":
        """Build from numpy parameters in the JAX package's layout."""
        dims = [tuple(p["w"].shape)
                for k, p in zip(spec.kinds, spec.params) if k == "linear"]
        model = cls(spec.kinds, dims, spec.name)
        model.load_state_dict(params_from_jax(spec.kinds, spec.params))
        return model.to(device) if device is not None else model

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def forward(self, x: torch.Tensor, dg: DeviceGraph, weight_scale: float,
                compat: bool = True, x_is_node_weights: bool = False,
                source_mask: torch.Tensor | None = None,
                precision: str = "highest") -> torch.Tensor:
        """Run the layer sequence; returns (n, out_width) activations.

        x_is_node_weights: x == W/ws (the solver's input), so the first
        graph layer's neighbour sum is exactly NW/ws and costs nothing.

        source_mask: (n,) 0/1, the sticky-scoring mode.  The CSR is a
        superset of the live graph; every aggregation after the first
        weights each source row by its mask, so dead rows contribute
        nothing and live rows aggregate over their live neighbourhoods.
        Dead rows' own outputs are not meaningful.

        precision: ``"highest"`` or ``"default"`` (``matmul_precision``).
        """
        with matmul_precision(precision):
            return self._layers(x, dg, weight_scale, compat,
                                x_is_node_weights, source_mask)

    def _layers(self, x, dg, weight_scale, compat, x_is_node_weights,
                source_mask):
        h = x
        first_graph = True
        linears = iter(self.linears)
        for kind in self.kinds:
            if kind == "linear":
                h = next(linears)(h)
            elif kind == "relu":
                h = torch.relu(h)
            elif kind == "sigmoid":
                h = torch.sigmoid(h)
            elif kind == "graph":
                if first_graph and x_is_node_weights:
                    agg = (dg.nw / weight_scale).reshape(-1, 1).to(h.dtype)
                else:
                    agg = csr_aggregate(h.contiguous(), dg.indptr, dg.indices,
                                        source_mask)
                h = graph_layer(h, agg, dg, weight_scale, compat)
                first_graph = False
            else:
                raise ValueError(f"unknown layer kind {kind!r}")
        return h


@torch.no_grad()
def score_graph(model: MWVCModel, dg: DeviceGraph, weight_scale: float,
                compat: bool = True) -> torch.Tensor:
    """Scores in [0, 1] for every vertex, with x(u) = W(u)/ws."""
    x = (dg.weights / weight_scale).reshape(-1, 1)
    return model(x, dg, weight_scale, compat=compat,
                 x_is_node_weights=True)[:, 0]


def build_reference_arch() -> tuple:
    """The 21-layer SEA-2022 architecture as ``(kinds, dims)``, the JAX
    package's ``build_reference_arch``:

    Graph -> Lin(5,32) -> ReLU -> Lin(32,32) -> ReLU -> Lin(32,16) -> ReLU ->
    Graph -> Lin(35,32) -> ReLU -> Lin(32,32) -> ReLU -> Lin(32,16) -> ReLU ->
    Graph -> Lin(35,32) -> ReLU -> Lin(32,16) -> ReLU -> Lin(16,1) -> Sigmoid
    """
    block = ["graph", "linear", "relu", "linear", "relu", "linear"]
    kinds = tuple(block + ["relu"] + block + ["relu"] + block + ["sigmoid"])
    dims = [(5, 32), (32, 32), (32, 16),
            (35, 32), (32, 32), (32, 16),
            (35, 32), (32, 16), (16, 1)]
    return kinds, dims


@torch.no_grad()
def init_params(model: MWVCModel, seed: int = 0) -> MWVCModel:
    """U(-lim, lim) init in place, lim = 1/sqrt(dim_in + 1): the JAX
    ``init_params``'s numbers, bit for bit.  Linear layer i draws from
    ``key(seed + i)`` split in two, the (din, dout) weight from the first
    key and the bias from the second (``models/_threefry.py``, the JAX
    default PRNG in numpy); the weight is stored transposed, as
    ``nn.Linear`` keeps (dout, din)."""
    for i, lin in enumerate(model.linears):
        din, dout = lin.in_features, lin.out_features
        lim = 1.0 / np.sqrt(din + 1)
        kw, kb = threefry.split(threefry.key(seed + i))
        w = threefry.uniform(kw, (din, dout), -lim, lim)
        b = threefry.uniform(kb, (dout,), -lim, lim)
        lin.weight.copy_(torch.from_numpy(np.ascontiguousarray(w.T)))
        lin.bias.copy_(torch.from_numpy(b))
    return model
