#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (gnn_mwvc_tpu_torch) on one GPU.

Run from the repository root:  python3 chip_smoke.py [--time SECONDS]

Phases, each printing one line of its own numbers; any failure exits
non-zero:
  1. device  - a CUDA device is required; prints nvidia-smi name, power limit
  2. build   - nvcc builds the kernels from gnn_mwvc_tpu_torch/csrc/
  3. K4      - region solver vs its plain version on the card, B = 1024 at
               n = 16 and n = 20: bitwise equal; ms per batch, regions/s
  4. K1      - CSR neighbour sum vs its plain version on the 1.44M-node
               road-like graph: within 1e-5, bitwise repeatable; edges/s
  5. forward - the published model on the full graph, through K1 and
               through the plain aggregation: within 2e-5; edges/s
  6. solve   - solve() on the road-like graph (1,440,000 nodes) with the
               kernel launch counters reset just before: a valid cover, K1
               launched in phase 1, K4 launched by the phase-2 assist
Then one JSON line of per-kernel numbers, and as the last line
{"ok": true, "device": {...}}.
"""

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROAD_SIDE = 1200  # 1,440,000 nodes: the road1200 workload


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(fn, iters):
    """Mean device milliseconds per call over ``iters`` calls (after one
    warm-up call), timed with CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def region_batch(rng, b, n):
    """B region instances of width n: random graphs, tie-heavy unit
    weights, self-loop (forced) vertices and padding rows, as the assist
    extracts them."""
    import numpy as np

    adj = np.zeros((b, n), np.int32)
    w = np.zeros((b, n), np.int32)
    for i in range(b):
        k = int(rng.integers(1, n + 1))           # used vertices; rest padding
        w[i, :k] = 1 if i % 4 == 0 else rng.integers(1, 1000, size=k)
        for _ in range(int(rng.integers(0, 3 * k + 1))):
            u, v = rng.integers(0, k, size=2)
            if u != v:
                adj[i, u] |= 1 << v
                adj[i, v] |= 1 << u
        for u in range(k):
            if rng.random() < 0.1:
                adj[i, u] |= 1 << u                # forced into the cover
    return adj, w


def phase_k4(torch, rng):
    from gnn_mwvc_tpu_torch.ops.smallsolve_mitm import (
        small_mwvc_mitm, small_mwvc_mitm_plain)

    out = {}
    for n in (16, 20):
        adj, w = region_batch(rng, 1024, n)
        d_adj = torch.from_numpy(adj).cuda()
        d_w = torch.from_numpy(w).cuda()
        c1, s1 = small_mwvc_mitm(d_adj, d_w)
        c0, s0 = small_mwvc_mitm_plain(d_adj, d_w)
        torch.cuda.synchronize()
        if not (torch.equal(c0, c1) and torch.equal(s0, s1)):
            bad = int(((c0 != c1) | (s0 != s1)).sum())
            fail(f"K4 n={n}: {bad} of 1024 instances differ from the plain version")
        ms = cuda_ms(lambda: small_mwvc_mitm(d_adj, d_w), 20)
        plain_ms = cuda_ms(lambda: small_mwvc_mitm_plain(d_adj, d_w), 3)
        err = int((c0.long() - c1.long()).abs().max())
        print(f"K4 n={n} B=1024: bitwise equal; kernel {ms:.4f} ms/batch "
              f"({1024 / ms * 1e3:.6g} regions/s), plain {plain_ms:.4f} ms/batch "
              f"({1024 / plain_ms * 1e3:.6g} regions/s)")
        out[n] = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err}
    return out


def phase_k1(torch, dg, rng):
    import numpy as np

    from gnn_mwvc_tpu_torch.ops.aggregate import (csr_aggregate,
                                                  csr_aggregate_plain)

    n = dg.n
    nnz = dg.indices.numel()
    x = torch.from_numpy(rng.standard_normal((n, 16)).astype(np.float32)).cuda()
    alive = rng.random(n) < 0.7
    mask = torch.from_numpy(alive.astype(np.float32)).cuda()
    mask_u8 = torch.from_numpy(alive.astype(np.uint8)).cuda()
    a1 = csr_aggregate(x, dg.indptr, dg.indices, mask)
    a2 = csr_aggregate(x, dg.indptr, dg.indices, mask)
    a3 = csr_aggregate(x, dg.indptr, dg.indices, mask_u8)
    a4 = csr_aggregate(x, dg.indptr, dg.indices)
    ref = csr_aggregate_plain(x, dg.indptr, dg.indices, mask)
    ref4 = csr_aggregate_plain(x, dg.indptr, dg.indices)
    torch.cuda.synchronize()
    if not torch.equal(a1, a2):
        fail("K1: two runs on the same input differ")
    if not torch.equal(a1, a3):
        fail("K1: float32 and uint8 masks disagree")
    # sums are taken in another order than index_add_'s
    for got, want, what in ((a1, ref, "masked"), (a4, ref4, "unmasked")):
        if not torch.allclose(got, want, rtol=1e-5, atol=1e-5):
            fail(f"K1 {what}: max |diff| {float((got - want).abs().max())}")
    err = float(torch.maximum((a1 - ref).abs().max(), (a4 - ref4).abs().max()))
    ms = cuda_ms(lambda: csr_aggregate(x, dg.indptr, dg.indices, mask), 20)
    plain_ms = cuda_ms(
        lambda: csr_aggregate_plain(x, dg.indptr, dg.indices, mask), 5)
    print(f"K1 n={n} nnz={nnz} w=16: within 1e-5 (max |diff| {err:.3g}), "
          f"bitwise repeatable; kernel {ms:.4f} ms ({nnz / ms * 1e3:.6g} edges/s), "
          f"plain {plain_ms:.4f} ms ({nnz / plain_ms * 1e3:.6g} edges/s)")
    return {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err}


def phase_forward(torch, g, dg, rng):
    import numpy as np

    import gnn_mwvc_tpu_torch.models.gnn as gnn_mod
    from gnn_mwvc_tpu_torch.models import pretrained_model, score_graph
    from gnn_mwvc_tpu_torch.ops.aggregate import csr_aggregate_plain

    model = pretrained_model("cuda")
    ws = float(g.weights.max())
    mask = torch.from_numpy((rng.random(dg.n) < 0.7).astype(np.float32)).cuda()

    def masked():
        x = (dg.weights / ws * mask).reshape(-1, 1)
        with torch.no_grad():
            return model(x, dg, ws, x_is_node_weights=True,
                         source_mask=mask)[:, 0]

    s_kernel = score_graph(model, dg, ws)
    m_kernel = masked()
    kernel_aggregate = gnn_mod.csr_aggregate
    gnn_mod.csr_aggregate = csr_aggregate_plain  # the same forward, plain K1
    try:
        s_plain = score_graph(model, dg, ws)
        m_plain = masked()
        plain_ms = cuda_ms(lambda: score_graph(model, dg, ws), 5)
    finally:
        gnn_mod.csr_aggregate = kernel_aggregate
    live = mask.bool()
    if not bool(torch.isfinite(s_kernel).all()):
        fail("forward: non-finite scores")
    if float(s_kernel.min()) < 0 or float(s_kernel.max()) > 1:
        fail("forward: scores outside [0, 1]")
    err = max(float((s_kernel - s_plain).abs().max()),
              float((m_kernel - m_plain)[live].abs().max()))
    if err > 2e-5:
        fail(f"forward: K1 vs plain aggregation differ by {err}")
    ms = cuda_ms(lambda: score_graph(model, dg, ws), 10)
    nnz = dg.indices.numel()
    print(f"forward n={dg.n} nnz={nnz}: finite, in [0, 1], within 2e-5 of the "
          f"plain aggregation (max |diff| {err:.3g}); {ms:.4f} ms "
          f"({nnz / ms * 1e3:.6g} edges/s), plain aggregation {plain_ms:.4f} ms "
          f"({nnz / plain_ms * 1e3:.6g} edges/s)")


def phase_solve(torch, g, time_limit):
    import io

    from gnn_mwvc_tpu_torch.graphio import cover_cost, is_vertex_cover, read_metis
    from gnn_mwvc_tpu_torch.ops import _build
    from gnn_mwvc_tpu_torch.solver.pipeline import solve

    ex3 = read_metis(io.BytesIO(b"3 2 10\n15 3\n15 3\n20 1 2\n"))
    r = solve(ex3, time_limit=1.0, device="cuda")
    if r.cost != 20 or list(r.solution) != [0, 0, 1]:
        fail(f"solve ex3: cost {r.cost}, cover {list(r.solution)}; want 20, [0, 0, 1]")

    _build.launches.clear()
    t0 = time.perf_counter()
    res = solve(g, time_limit=time_limit, device="cuda")
    wall = time.perf_counter() - t0
    launches = dict(_build.launches)
    if not is_vertex_cover(g, res.solution):
        fail("solve: result is not a vertex cover")
    if cover_cost(g, res.solution) != res.cost:
        fail("solve: cost does not match the cover")
    p1 = res.phase1
    k1 = launches.get("csr_aggregate", 0)
    k4 = launches.get("small_mwvc_mitm", 0)
    if p1["rounds"] < 1 or k1 < 2 * p1["rounds"]:
        fail(f"solve: K1 launched {k1} times over {p1['rounds']} phase-1 rounds")
    stats = res.assist_stats or {}
    if k4 < 1 or stats.get("batches", 0) < 1:
        fail(f"solve: K4 launched {k4} times, assist batches {stats.get('batches')}")
    phase2 = res.time_total - res.time_gnn
    print(f"solve n={g.n} m={g.m} T={time_limit}: phase1 {res.time_gnn:.3f} s "
          f"(reduce {p1['t_reduce0_s']:.3f}, score {p1['t_score_s']:.3f}, "
          f"peel {p1['t_peel_s']:.3f}, rounds {p1['rounds']}), phase2 "
          f"{phase2:.3f} s, wall {wall:.3f} s; kernel {res.kernel_size}, "
          f"cost {res.cost}, best_seen {res.best_seen}, ls_steps {res.ls_steps}; "
          f"launches {launches}; scorer {json.dumps(p1.get('scorer'))}; "
          f"assist {json.dumps(stats)}")
    if phase2 < 30:
        fail(f"solve: phase 2 got {phase2:.1f} s, under 30 s; raise --time")
    return launches


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--time", type=float, default=150.0,
                    help="solve() time limit on the road-like graph")
    ap.add_argument("--side", type=int, default=ROAD_SIDE,
                    help="road-like graph side (side^2 nodes)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not os.path.isdir(os.path.join(HERE, "gnn_mwvc_tpu_torch", "csrc")):
        fail("run from a checkout of the repository (gnn_mwvc_tpu_torch/ missing)")
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    # 1. device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"device: {torch.cuda.get_device_name(0)}, count "
          f"{torch.cuda.device_count()}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")

    # 2. build
    from gnn_mwvc_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.lib()
    ptxas = [ln.strip() for ln in _build.build_log.splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    print(f"build: {time.perf_counter() - t0:.3f} s; " + " | ".join(ptxas))

    rng = np.random.default_rng(args.seed)
    # 3. K4
    k4 = phase_k4(torch, rng)

    # 4. K1 and 5. forward on the road-like graph
    from gnn_mwvc_tpu_torch.graph import DeviceGraph, build_road_graph

    t0 = time.perf_counter()
    g = build_road_graph(args.side)
    dg = DeviceGraph.from_graph(g, "cuda")
    print(f"graph: road side {args.side}, n={g.n}, m={g.m}, "
          f"built in {time.perf_counter() - t0:.3f} s")
    k1 = phase_k1(torch, dg, rng)
    phase_forward(torch, g, dg, rng)
    del dg
    torch.cuda.empty_cache()

    # 6. solve
    launches = phase_solve(torch, g, args.time)

    print(json.dumps({"kernels": [
        {"name": "csr_aggregate", "route": "cuda",
         "source": "gnn_mwvc_tpu_torch/csrc/csr_aggregate.cu",
         "replaces": "gnn_mwvc_tpu/ops/aggregate.py:209",
         "launches": launches.get("csr_aggregate", 0),
         "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
         "plain_ms": k1["plain_ms"]},
        {"name": "small_mwvc_mitm", "route": "cuda",
         "source": "gnn_mwvc_tpu_torch/csrc/smallsolve_mitm.cu",
         "replaces": "gnn_mwvc_tpu/ops/smallsolve_pallas.py:154",
         "launches": launches.get("small_mwvc_mitm", 0),
         "max_abs_err": max(k4[16]["max_abs_err"], k4[20]["max_abs_err"]),
         "ms": k4[20]["ms"], "plain_ms": k4[20]["plain_ms"]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
