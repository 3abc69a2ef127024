#!/usr/bin/env python3
"""Timing study of kernel K1 (``csr_aggregate``) on the road-like graph.

    python3 gnn_mwvc_tpu_torch/tools/k1_timing.py [--repo DIR] [--sweep]

Needs one CUDA device.  ``gnn_mwvc_tpu_torch`` is imported from ``--repo``
(default: the checkout holding this file), so that two checkouts are timed
by one method: run the script once per checkout in one session on the card.

Each operation is timed three ways:
  eager  - 20 back-to-back calls between two CUDA events (what a caller
           that launches call by call pays; the method of chip_smoke.py's
           ``ms``)
  host   - the host's milliseconds to issue each of those calls, read
           before the device is synchronised: when it exceeds the device
           time, the eager time is the host's
  device - 20 calls captured in one CUDA graph, one replay between events
           (the device's time without the host's per-call cost)

Operations, at w = 16 with a 70% live f32 mask:
  forward masked / unmasked            K1 on x
  backward (autograd)                  torch.autograd.grad through K1's
                                       unmasked output, the training path;
                                       eager and host timed before and
                                       after the CUDA-graph captures, right
                                       after a neighbour sum on the CPU and
                                       after one through autograd (the
                                       plain version, as chip_smoke.py
                                       checks), and one second after each
  backward launch                      K1 on the gradient alone
  window                               the masked forward with every gather
                                       in the first 65,536 rows of x (4 MB,
                                       L2 resident): the walk's cost when no
                                       gather reaches HBM
  torch.sparse.mm                      the library call on a CSR tensor
                                       (unmasked)
``--sweep`` also builds this checkout's ``csrc/csr_aggregate.cu`` with
other rows per group, edges per step and block sizes, holds each build
bitwise equal to the package's K1, and times it in a graph.
"""

import argparse
import ctypes as ct
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = os.path.dirname(HERE)
ITERS = 20


def eager_ms(torch, fn):
    """(device ms per call, host issue ms per call) of ITERS eager calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / ITERS
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / ITERS, host


def device_ms(torch, fn):
    """Device ms per call of ITERS calls captured in one CUDA graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(ITERS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / ITERS


def report(what, eager=None, device=None):
    parts = []
    if eager is not None:
        parts.append(f"eager {eager[0]:.4f} ms, host {eager[1]:.4f} ms")
    if device is not None:
        parts.append(f"device {device:.4f} ms")
    print(f"{what}: " + "; ".join(parts), flush=True)


def sweep(torch, x, dg, mask, want_masked, want_unmasked):
    """Build csr_aggregate.cu with other constants and time each build."""
    src = open(os.path.join(PKG, "csrc", "csr_aggregate.cu")).read()
    out_dir = os.path.join(PKG, "_build", "k1_sweep")
    os.makedirs(out_dir, exist_ok=True)
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    builds = {}
    for rows in (1, 2, 4):
        for step in (4, 8):
            for threads in (128, 256):
                text = src
                for name, val in (("kRows", rows), ("kStep", step),
                                  ("kThreads", threads)):
                    text, hits = re.subn(rf"constexpr int {name} = \d+;",
                                         f"constexpr int {name} = {val};", text)
                    if hits != 1:
                        raise RuntimeError(f"{name} not found once in the source")
                tag = f"rows{rows}_step{step}_threads{threads}"
                cu = os.path.join(out_dir, tag + ".cu")
                so = os.path.join(out_dir, tag + ".so")
                with open(cu, "w") as f:
                    f.write(text)
                builds[tag] = (so, subprocess.Popen(
                    [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                     "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                     "-o", so, cu], stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True))
    n, w = x.shape
    for tag, (so, proc) in builds.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"sweep {tag}: nvcc failed\n{log[-2000:]}")
            continue
        fn = ct.CDLL(so).csr_aggregate_f32
        fn.argtypes = [ct.c_void_p] * 4 + [ct.c_int, ct.c_void_p, ct.c_int,
                                           ct.c_int, ct.c_void_p]
        fn.restype = ct.c_int
        out = torch.empty_like(x)

        def run(m):
            err = fn(x.data_ptr(), dg.indptr.data_ptr(), dg.indices.data_ptr(),
                     m.data_ptr() if m is not None else None,
                     1 if m is not None else 0, out.data_ptr(), n, w,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"sweep {tag}: CUDA error {err}")

        same = []
        for m, want in ((mask, want_masked), (None, want_unmasked)):
            run(m)
            torch.cuda.synchronize()
            same.append(torch.equal(out, want))
        masked = device_ms(torch, lambda: run(mask))
        unmasked = device_ms(torch, lambda: run(None))
        print(f"sweep {tag}: bitwise equal {same}; device masked "
              f"{masked:.4f} ms, unmasked {unmasked:.4f} ms", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=os.path.dirname(PKG),
                    help="checkout whose gnn_mwvc_tpu_torch is timed")
    ap.add_argument("--side", type=int, default=1200,
                    help="road-like graph side (side^2 nodes)")
    ap.add_argument("--sweep", action="store_true",
                    help="also time other builds of this checkout's K1")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.repo))
    import numpy as np
    import torch

    from gnn_mwvc_tpu_torch.graph import DeviceGraph, build_road_graph
    from gnn_mwvc_tpu_torch.ops.aggregate import csr_aggregate

    if not torch.cuda.is_available():
        sys.exit("a CUDA device is required")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    import gnn_mwvc_tpu_torch
    print(f"{smi.stdout.strip()}; package {gnn_mwvc_tpu_torch.__file__}")
    dg = DeviceGraph.from_graph(build_road_graph(args.side), "cuda")
    n, nnz = dg.n, dg.indices.numel()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((n, 16)).astype(np.float32)).cuda()
    g = torch.from_numpy(rng.standard_normal((n, 16)).astype(np.float32)).cuda()
    mask = torch.from_numpy((rng.random(n) < 0.7).astype(np.float32)).cuda()
    xg = x.clone().requires_grad_()
    out = csr_aggregate(xg, dg.indptr, dg.indices)
    print(f"road side {args.side}: n={n} nnz={nnz}", flush=True)

    def backward():
        return torch.autograd.grad(out, xg, g, retain_graph=True)

    report("backward (autograd), before any capture", eager=eager_ms(torch, backward))
    for what, m in (("forward masked", mask), ("forward unmasked", None)):
        def fwd(m=m):
            return csr_aggregate(x, dg.indptr, dg.indices, m)
        report(what, eager=eager_ms(torch, fwd), device=device_ms(torch, fwd))

    def launch():
        return csr_aggregate(g, dg.indptr, dg.indices)

    report("backward launch", eager=eager_ms(torch, launch),
           device=device_ms(torch, launch))
    report("backward (autograd), after the captures", eager=eager_ms(torch, backward))
    cpu = [t.cpu() for t in (x, dg.indptr, dg.indices, mask)]
    csr_aggregate(*cpu)
    report("backward (autograd), right after a neighbour sum on the CPU",
           eager=eager_ms(torch, backward))
    time.sleep(1.0)
    report("backward (autograd), one second later", eager=eager_ms(torch, backward))
    xc = cpu[0].clone().requires_grad_()
    torch.autograd.grad(csr_aggregate(xc, *cpu[1:3]), xc, g.cpu())
    report("backward (autograd), right after an autograd neighbour sum on the "
           f"CPU ({torch.get_num_threads()} threads)", eager=eager_ms(torch, backward))
    time.sleep(1.0)
    report("backward (autograd), one second later", eager=eager_ms(torch, backward))
    del cpu, xc
    window = dg.indices % 65536
    report("forward masked, gathers in a 4 MB window", device=device_ms(
        torch, lambda: csr_aggregate(x, dg.indptr, window, mask)))
    del window
    if args.sweep:
        sweep(torch, x, dg, mask, csr_aggregate(x, dg.indptr, dg.indices, mask),
              csr_aggregate(x, dg.indptr, dg.indices))
    a_csr = torch.sparse_csr_tensor(dg.indptr, dg.indices,
                                    torch.ones(nnz, device="cuda"), size=(n, n),
                                    check_invariants=False)
    report("torch.sparse.mm (CSR, unmasked)",
           eager=eager_ms(torch, lambda: torch.sparse.mm(a_csr, x)),
           device=device_ms(torch, lambda: torch.sparse.mm(a_csr, x)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
