"""What the tools share: instance names, output paths and device timing.
``chip_smoke.py`` takes its device times and HBM bounds from here too, so
its kernel numbers and the tools' are measured alike."""

from __future__ import annotations

import os
import tempfile
import time

import torch

from gnn_mwvc_tpu_torch.graph import Graph, build_road_graph
from gnn_mwvc_tpu_torch.parallel.mesh import synchronize

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3, NVIDIA's data sheet
GRAPH_ITERS = 20            # calls per CUDA graph in ``graph_ms``


def road_instance(name: str) -> Graph:
    """``roadNNN``: ``build_road_graph(NNN)``, the JAX package's bench
    workload of NNN^2 nodes."""
    if not name.startswith("road") or not name[4:].isdigit():
        raise ValueError(f"instance {name!r} is not roadNNN")
    return build_road_graph(int(name[4:]))


def default_out(filename: str) -> str:
    """The default output path: ``filename`` in the temporary directory."""
    return os.path.join(tempfile.gettempdir(), filename)


def seconds_per_call(fn, device: torch.device, iters: int) -> float:
    """Mean seconds per call of ``iters`` back-to-back calls after one
    warm-up: CUDA events around them on a card, the host clock on the
    CPU."""
    fn()
    synchronize(device)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def graph_ms(fn, iters: int = GRAPH_ITERS) -> float:
    """Device milliseconds per call of ``iters`` calls captured in one CUDA
    graph: the device's time without the host's per-call launch cost."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    # captured on the current card's side stream: torch.cuda.graph's own
    # default stream belongs to the card that was current at its first use
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def hbm_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def hbm_bound_ms(*tensors) -> float:
    """Least milliseconds to read each input once and write the output
    once at the HBM rate."""
    return hbm_bytes(*tensors) / HBM_BYTES_PER_S * 1e3
