"""The reference text model format, read into numpy and written from a
``MWVCModel``, and the conversion between JAX-layout parameters and a
``MWVCModel``'s.

Text format (the reference's ``operator>>``; token based, so any whitespace
layout parses)::

    <name>
    <n> Layers
    Graph_Layer
    Linear_Layer
    Weights: <in> <out>
    <in rows of out floats>
    Bias: 1 <out>
    <out floats>
    ReLU_Activation
    ...
    Sigmoid_Activation

The published SEA-2022 weights are read from the JAX package's copy
(``gnn_mwvc_tpu/models/weights/gnn_vc_sea2022.txt``), so one copy of the
data exists.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

__all__ = ["ModelSpec", "dumps_model", "loads_model", "load_model",
           "load_pretrained", "params_from_jax", "params_to_jax", "save_model",
           "PRETRAINED_PATH"]

PRETRAINED_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "gnn_mwvc_tpu", "models", "weights", "gnn_vc_sea2022.txt",
)

_KIND_TO_TOKEN = {
    "linear": "Linear_Layer",
    "graph": "Graph_Layer",
    "relu": "ReLU_Activation",
    "sigmoid": "Sigmoid_Activation",
}
_TOKEN_TO_KIND = {v: k for k, v in _KIND_TO_TOKEN.items()}


@dataclasses.dataclass
class ModelSpec:
    """A model as numpy data in the JAX package's layout: one entry of
    ``params`` per layer, ``{"w": (in, out), "b": (out,)}`` for a linear
    layer and None otherwise."""

    kinds: tuple
    params: list
    name: str = "MWVC_Model"


def loads_model(text: str) -> ModelSpec:
    toks = text.split()
    pos = 0

    def take():
        nonlocal pos
        pos += 1
        return toks[pos - 1]

    def expect(tok):
        got = take()
        if got != tok:
            raise ValueError(f"model text: expected {tok!r}, got {got!r}")

    name = take()
    n = int(take())
    expect("Layers")
    kinds, params = [], []
    for _ in range(n):
        kind = _TOKEN_TO_KIND[take()]
        kinds.append(kind)
        if kind != "linear":
            params.append(None)
            continue
        expect("Weights:")
        h, w = int(take()), int(take())
        wdat = np.array(toks[pos:pos + h * w], dtype=np.float32).reshape(h, w)
        pos += h * w
        expect("Bias:")
        expect("1")
        bw = int(take())
        bdat = np.array(toks[pos:pos + bw], dtype=np.float32)
        pos += bw
        params.append({"w": wdat, "b": bdat})
    return ModelSpec(kinds=tuple(kinds), params=params, name=name)


def dumps_model(model) -> str:
    """A ``MWVCModel`` in the reference text format, byte for byte what the
    JAX package's ``dumps_model`` writes for the same parameters (``%g``
    floats, a blank line after each layer), so both packages load it."""
    out = [model.name, f"{len(model.kinds)} Layers"]
    for kind, p in zip(model.kinds, params_to_jax(model)):
        out.append(_KIND_TO_TOKEN[kind])
        if kind == "linear":
            w, b = p["w"], p["b"]
            out.append(f"Weights: {w.shape[0]} {w.shape[1]}")
            for row in w:
                out.append(" ".join(f"{v:g}" for v in row) + " ")
            out.append(f"Bias: 1 {b.shape[0]}")
            out.append(" ".join(f"{v:g}" for v in b) + " ")
        out.append("")
    return "\n".join(out) + "\n"


def save_model(path, model) -> None:
    with open(path, "w") as f:
        f.write(dumps_model(model))


def load_model(path) -> ModelSpec:
    with open(path) as f:
        return loads_model(f.read())


def load_pretrained() -> ModelSpec:
    """The published 21-layer / 6,209-parameter SEA-2022 model."""
    return load_model(PRETRAINED_PATH)


def params_from_jax(kinds, params) -> dict:
    """State dict of ``MWVCModel`` from JAX-layout numpy parameters.

    JAX stores a linear layer's weight as (in, out) and computes x @ W;
    ``nn.Linear`` stores (out, in), so each weight is transposed."""
    sd = {}
    i = 0
    for kind, p in zip(kinds, params):
        if kind != "linear":
            continue
        sd[f"linears.{i}.weight"] = torch.from_numpy(
            np.array(np.asarray(p["w"], np.float32).T, order="C"))
        sd[f"linears.{i}.bias"] = torch.from_numpy(
            np.asarray(p["b"], np.float32).copy())
        i += 1
    return sd


def params_to_jax(model) -> list:
    """The inverse of ``params_from_jax``: one entry per layer of ``model``,
    ``{"w": (in, out), "b": (out,)}`` float32 numpy for a linear layer and
    None otherwise."""
    linears = iter(model.linears)
    params = []
    for kind in model.kinds:
        if kind != "linear":
            params.append(None)
            continue
        lin = next(linears)
        params.append({"w": lin.weight.detach().cpu().numpy().T.copy(),
                       "b": lin.bias.detach().cpu().numpy().copy()})
    return params
