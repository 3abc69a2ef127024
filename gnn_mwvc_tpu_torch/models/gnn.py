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

The linear layers are ``nn.Linear`` in float32.  The JAX reference runs its
dots at ``Precision.HIGHEST`` (full fp32), so TF32 is switched off for both
matmuls and cuDNN here, at import.
"""

from __future__ import annotations

import torch
from torch import nn

from gnn_mwvc_tpu_torch.graph import DeviceGraph
from gnn_mwvc_tpu_torch.models.serialize import ModelSpec, params_from_jax
from gnn_mwvc_tpu_torch.ops.aggregate import csr_aggregate

__all__ = ["MWVCModel", "graph_layer", "score_graph"]

# fp32 parity with the JAX reference (Precision.HIGHEST): no TF32 anywhere
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


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
                source_mask: torch.Tensor | None = None) -> torch.Tensor:
        """Run the layer sequence; returns (n, out_width) activations.

        x_is_node_weights: x == W/ws (the solver's input), so the first
        graph layer's neighbour sum is exactly NW/ws and costs nothing.

        source_mask: (n,) 0/1, the sticky-scoring mode.  The CSR is a
        superset of the live graph; every aggregation after the first
        weights each source row by its mask, so dead rows contribute
        nothing and live rows aggregate over their live neighbourhoods.
        Dead rows' own outputs are not meaningful.
        """
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
