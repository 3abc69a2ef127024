"""The native MWVC host core, shared with the JAX package.

The reversible graph, the reduction rules, branch-and-reduce, local search
and unfold are C++ (``gnn_mwvc_tpu/core/src``) behind ctypes bindings in
``gnn_mwvc_tpu/core/api.py``.  That file imports only numpy and ctypes, but
importing it as ``gnn_mwvc_tpu.core.api`` would run the JAX package's
``__init__`` (which imports jax).  So it is loaded here by path under a
private module name: the C++ sources, the g++ build (``libmwvc_core.so`` next
to the sources) and the ctypes signatures exist once, for both packages.
"""

from __future__ import annotations

import importlib.util
import os
import sys

_API_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "gnn_mwvc_tpu", "core", "api.py",
)
_MODULE_NAME = "_gnn_mwvc_native_core_api"


def _load_api():
    mod = sys.modules.get(_MODULE_NAME)
    if mod is not None:
        return mod
    spec = importlib.util.spec_from_file_location(_MODULE_NAME, _API_PATH)
    if spec is None or spec.loader is None:
        raise ImportError(f"native core bindings not found at {_API_PATH}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[_MODULE_NAME] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[_MODULE_NAME]
        raise
    return mod


_api = _load_api()

CoreSolver = _api.CoreSolver
CoreLocalSearch = _api.CoreLocalSearch
Snapshot = _api.Snapshot
confidence_order_native = _api.confidence_order_native
cluster_order = _api.cluster_order

__all__ = ["CoreSolver", "CoreLocalSearch", "Snapshot",
           "confidence_order_native", "cluster_order"]
