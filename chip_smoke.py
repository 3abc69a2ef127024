#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (gnn_mwvc_tpu_torch) on one GPU.

Run from the repository root:  python3 chip_smoke.py [--time SECONDS]

Phases, each printing one line of its own numbers; any failure exits
non-zero:
  1. device  - a CUDA device is required; prints nvidia-smi name, power limit
               and SM clocks (the clock sets the integer-operation bound)
  2. build   - nvcc builds the kernels from gnn_mwvc_tpu_torch/csrc/
  3. K4      - region solver vs its plain version on the card, synthetic
               batches of B = 1, 7, 1024, 1500 at n = 16 and n = 20: bitwise
               equal; ms per eager call and on the device alone, regions/s
  4. K1      - CSR neighbour sum on the 1.44M-node road-like graph, masked
               (f32, u8) and unmasked: bitwise equal to the plain version run
               on CPU copies, within 1e-5 of it on the card, bitwise
               repeatable; ms and edges/s beside the HBM bound and
               torch.sparse.mm on a CSR tensor (the library yardstick)
  5. forward - the published model on the full graph, through K1 and
               through the plain aggregation: within 2e-5; edges/s.
     backward - on the same graph: K1's backward alone (w = 16, masked and
               unmasked) bitwise equal to the CPU plain autograd, within 1e-5
               of the plain autograd on the card and bitwise repeatable; the
               full-model SSE gradients of a random-init reference model
               through K1 and through the plain aggregation, every parameter
               tensor within 1e-4 of its largest entry; ms of one autograd
               call and the host's share of it, forward + backward ms and
               edges/s
  6. solve   - solve() on the road-like graph (1,440,000 nodes) with the
               kernel launch counters reset just before: a valid cover, K1
               launched in phase 1, K4 launched by the phase-2 assist
     regions - K4 on 1024 regions extracted from a local search over the
               road-like graph and solve()'s cover, as the assist extracts
               them: bitwise equal to the plain version; region sizes, ms
  7. train   - 8 road-like graphs (side 400) kernelised with the 3 rules and
               labelled by solve()'s phase-1 cover (over 1,000,000 kernel
               vertices), then train() for 2 epochs on the card with the
               counters reset just before: finite losses, moved parameters,
               K1's backward launched for every training graph, and the
               saved model reloads and drives a valid solve(); ms per SGD
               step, vertices/s, per-epoch losses
Then one JSON line of per-kernel numbers, and as the last line
{"ok": true, "device": {...}}.

Timing: ``ms``, ``plain_ms`` and ``library_ms`` are eager calls between two
CUDA events, as a caller that launches call by call pays them (the method of
every earlier run); ``device_ms`` and ``library_device_ms`` replay 20 calls
captured in one CUDA graph, the device's time without the host's per-call
cost, which exceeds a K4 launch's run.
"""

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROAD_SIDE = 1200  # 1,440,000 nodes: the road1200 workload
# training corpus: 8 x 160,000 nodes; the 3-rule kernel keeps ~98% of a
# road-like graph, so 7 training graphs of ~157k kernel vertices fire the
# 500k-vertex accumulation twice a pass (once mid-pass, once at its end)
TRAIN_SIDE = 400
TRAIN_GRAPHS = 8
TRAIN_MIN_VERTICES = 1_000_000
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3, NVIDIA's data sheet
INT32_LANES_PER_SM = 64     # Hopper SM: 64 INT32 lanes a clock


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def eager_times(fn, iters):
    """(milliseconds per call between CUDA events, host milliseconds to
    issue each call) over ``iters`` back-to-back calls after one warm-up
    call.  Where the host's exceeds the device's, the call is host-bound."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, host_ms


def cuda_ms(fn, iters):
    """Mean milliseconds per eager call, timed with CUDA events."""
    return eager_times(fn, iters)[0]


def graph_ms(fn, iters):
    """Mean device milliseconds per call of ``iters`` back-to-back calls
    captured in one CUDA graph: the device's time without the host's
    launch cost, which exceeds a short kernel's run."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
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


def hbm_bound_ms(*tensors):
    """Least time to read the inputs once and write the output once."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    return nbytes / HBM_BYTES_PER_S * 1e3


def k4_ops(b, n):
    """Integer operations of K4's algorithm for B instances of width n (see
    csrc/smallsolve_mitm.cu): per high pattern a weight add, a neighbour OR
    and an independence test; per subset-maximum step a 64-bit maximum (2
    operations); per low pattern an add, an OR, a test, the lookup's
    subtraction and a 64-bit minimum (2)."""
    lo = n // 2
    hi = n - lo
    return b * (3 * 2**hi + 2 * hi * 2**(hi - 1) + 6 * 2**lo)


def region_batch(rng, b, n):
    """B region instances of width n: random graphs, tie-heavy unit
    weights, self-loop (forced) vertices and padding rows, as the assist
    extracts them, with some all-padding rows and full cliques."""
    import numpy as np

    adj = np.zeros((b, n), np.int32)
    w = np.zeros((b, n), np.int32)
    for i in range(b):
        if i % 16 == 1:
            continue                               # all padding
        k = int(rng.integers(1, n + 1))           # used vertices; rest padding
        w[i, :k] = 1 if i % 4 == 0 else rng.integers(1, 1000, size=k)
        if i % 16 == 2:
            adj[i, :k] = ((1 << k) - 1) ^ (1 << np.arange(k))   # clique
            continue
        for _ in range(int(rng.integers(0, 3 * k + 1))):
            u, v = rng.integers(0, k, size=2)
            if u != v:
                adj[i, u] |= 1 << v
                adj[i, v] |= 1 << u
        for u in range(k):
            if rng.random() < 0.1:
                adj[i, u] |= 1 << u                # forced into the cover
    return adj, w


def check_k4(torch, adj, w, what):
    """K4 against its plain version on the card, bitwise; returns the
    largest |cost difference| (0)."""
    from gnn_mwvc_tpu_torch.ops.smallsolve_mitm import (
        small_mwvc_mitm, small_mwvc_mitm_plain)

    c1, s1 = small_mwvc_mitm(adj, w)
    c0, s0 = small_mwvc_mitm_plain(adj, w)
    torch.cuda.synchronize()
    if not (torch.equal(c0, c1) and torch.equal(s0, s1)):
        bad = int(((c0 != c1) | (s0 != s1)).sum())
        fail(f"K4 {what}: {bad} of {len(c0)} instances differ from the "
             "plain version")
    return int((c0.long() - c1.long()).abs().max())


def time_k4(torch, adj, w, plain_iters):
    from gnn_mwvc_tpu_torch.ops.smallsolve_mitm import (
        small_mwvc_mitm, small_mwvc_mitm_plain)

    ms = cuda_ms(lambda: small_mwvc_mitm(adj, w), 20)
    device_ms = graph_ms(lambda: small_mwvc_mitm(adj, w), 20)
    plain_ms = cuda_ms(lambda: small_mwvc_mitm_plain(adj, w), plain_iters)
    return ms, device_ms, plain_ms


def phase_k4(torch, rng, int_ops_per_s):
    """Returns the largest |cost difference| over all batches (0)."""
    err = 0
    for n in (16, 20):
        for b in (1, 7, 1024, 1500):
            adj, w = region_batch(rng, b, n)
            d_adj = torch.from_numpy(adj).cuda()
            d_w = torch.from_numpy(w).cuda()
            err = max(err, check_k4(torch, d_adj, d_w, f"n={n} B={b}"))
            ms, device_ms, plain_ms = time_k4(torch, d_adj, d_w,
                                              3 if b >= 1024 else 5)
            bound_ms = k4_ops(b, n) / int_ops_per_s * 1e3
            print(f"K4 n={n} B={b}: bitwise equal; {ms:.5f} ms per eager call "
                  f"({b / ms * 1e3:.6g} regions/s), {device_ms:.5f} ms/batch on "
                  f"the device; bound {bound_ms:.6f} ms (int32, "
                  f"{k4_ops(b, n)} ops); plain {plain_ms:.4f} ms/batch")
    return err


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
    # the card's index_add_ adds in another order
    for got, want, what in ((a1, ref, "masked"), (a4, ref4, "unmasked")):
        if not torch.allclose(got, want, rtol=1e-5, atol=1e-5):
            fail(f"K1 {what}: max |diff| {float((got - want).abs().max())}")
    err = float(torch.maximum((a1 - ref).abs().max(), (a4 - ref4).abs().max()))
    # the CPU's index_add_ adds each row's terms in CSR order, as K1 does
    cpu = [t.cpu() for t in (x, dg.indptr, dg.indices, mask, mask_u8)]
    for got, m, what in ((a1, cpu[3], "f32 mask"), (a3, cpu[4], "u8 mask"),
                         (a4, None, "unmasked")):
        want = csr_aggregate_plain(*cpu[:3], m)
        if not torch.equal(got.cpu(), want):
            diff = float((got.cpu() - want).abs().max())
            fail(f"K1 {what}: not bitwise equal to the CPU plain version "
                 f"(max |diff| {diff})")
    del ref, ref4, a2, a3, cpu
    a_csr = torch.sparse_csr_tensor(
        dg.indptr, dg.indices, torch.ones(nnz, device="cuda"), size=(n, n),
        check_invariants=False)
    lib_out = torch.sparse.mm(a_csr, x)
    lib_err = float((lib_out - a4).abs().max())
    del lib_out
    ms = cuda_ms(lambda: csr_aggregate(x, dg.indptr, dg.indices, mask), 20)
    device_ms = graph_ms(
        lambda: csr_aggregate(x, dg.indptr, dg.indices, mask), 20)
    unmasked_ms = cuda_ms(lambda: csr_aggregate(x, dg.indptr, dg.indices), 20)
    unmasked_device_ms = graph_ms(
        lambda: csr_aggregate(x, dg.indptr, dg.indices), 20)
    library_ms = cuda_ms(lambda: torch.sparse.mm(a_csr, x), 20)
    library_device_ms = graph_ms(lambda: torch.sparse.mm(a_csr, x), 20)
    plain_ms = cuda_ms(
        lambda: csr_aggregate_plain(x, dg.indptr, dg.indices, mask), 5)
    bound_ms = hbm_bound_ms(dg.indptr, dg.indices, x, mask, a1)
    unmasked_bound_ms = hbm_bound_ms(dg.indptr, dg.indices, x, a4)
    print(f"K1 n={n} nnz={nnz} w=16: bitwise equal to the CPU plain version "
          f"(f32 mask, u8 mask, unmasked), within 1e-5 of it on the card "
          f"(max |diff| {err:.3g}), bitwise repeatable; masked {ms:.4f} ms "
          f"eager, {device_ms:.4f} ms on the device ({nnz / device_ms * 1e3:.6g} "
          f"edges/s, HBM bound {bound_ms:.4f} ms, {bound_ms / device_ms:.1%}), "
          f"unmasked {unmasked_ms:.4f} ms eager, {unmasked_device_ms:.4f} ms on "
          f"the device (bound {unmasked_bound_ms:.4f} ms, "
          f"{unmasked_bound_ms / unmasked_device_ms:.1%}); torch.sparse.mm (CSR, "
          f"unmasked) {library_ms:.4f} ms eager, {library_device_ms:.4f} ms on "
          f"the device (max |diff| {lib_err:.3g}); plain {plain_ms:.4f} ms "
          f"({nnz / plain_ms * 1e3:.6g} edges/s)")
    return {"ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "max_abs_err": err, "bound_ms": bound_ms, "library_ms": library_ms,
            "library_device_ms": library_device_ms}


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


def phase_backward(torch, dg, rng, seed):
    import numpy as np

    import gnn_mwvc_tpu_torch.models.gnn as gnn_mod
    from gnn_mwvc_tpu_torch.models import (MWVCModel, build_reference_arch,
                                           init_params)
    from gnn_mwvc_tpu_torch.ops.aggregate import (csr_aggregate,
                                                  csr_aggregate_plain)
    from gnn_mwvc_tpu_torch.train import TrainSample, loss_and_metrics
    from gnn_mwvc_tpu_torch.train.trainer import WEIGHT_SCALE

    n = dg.n
    nnz = dg.indices.numel()

    def randn(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).cuda()

    # K1's backward alone
    x = randn(n, 16).requires_grad_()
    g = randn(n, 16)
    mask = torch.from_numpy((rng.random(n) < 0.7).astype(np.float32)).cuda()
    cpu_csr = (dg.indptr.cpu(), dg.indices.cpu())
    err = 0.0
    for what, m in (("masked", mask), ("unmasked", None)):
        out_k = csr_aggregate(x, dg.indptr, dg.indices, m)
        out_p = csr_aggregate_plain(x, dg.indptr, dg.indices, m)
        (b1,) = torch.autograd.grad(out_k, x, g, retain_graph=True)
        (b2,) = torch.autograd.grad(out_k, x, g, retain_graph=True)
        (ref,) = torch.autograd.grad(out_p, x, g, retain_graph=True)
        torch.cuda.synchronize()
        if not torch.equal(b1, b2):
            fail(f"K1 backward {what}: two runs on the same input differ")
        # index_add_'s backward sums in another order (and with atomics)
        if not torch.allclose(b1, ref, rtol=1e-5, atol=1e-5):
            fail(f"K1 backward {what}: max |diff| {float((b1 - ref).abs().max())}")
        err = max(err, float((b1 - ref).abs().max()))
        # on CPU tensors the same autograd runs the plain version both ways
        x_cpu = x.detach().cpu().requires_grad_()
        (want,) = torch.autograd.grad(
            csr_aggregate(x_cpu, *cpu_csr, None if m is None else m.cpu()),
            x_cpu, g.cpu())
        if not torch.equal(b1.cpu(), want):
            fail(f"K1 backward {what}: not bitwise equal to the CPU plain "
                 f"autograd (max |diff| {float((b1.cpu() - want).abs().max())})")
        del x_cpu, want
    # the training path's backward is unmasked: one autograd call through
    # K1 (with the host's time to issue it), and its K1 launch on the device
    ms, host_ms = eager_times(
        lambda: torch.autograd.grad(out_k, x, g, retain_graph=True), 20)
    device_ms = graph_ms(lambda: csr_aggregate(g, dg.indptr, dg.indices), 20)
    plain_ms = cuda_ms(
        lambda: torch.autograd.grad(out_p, x, g, retain_graph=True), 5)
    # the gradient's neighbour sum as one library call: A g (A symmetric)
    a_csr = torch.sparse_csr_tensor(dg.indptr, dg.indices,
                                    torch.ones(nnz, device="cuda"), size=(n, n),
                                    check_invariants=False)
    library_ms = cuda_ms(lambda: torch.sparse.mm(a_csr, g), 20)
    library_device_ms = graph_ms(lambda: torch.sparse.mm(a_csr, g), 20)
    bound_ms = hbm_bound_ms(dg.indptr, dg.indices, g, b1)
    del x, g, out_k, out_p, b1, b2, ref, a_csr
    print(f"K1 backward n={n} nnz={nnz} w=16: bitwise equal to the CPU plain "
          f"autograd, within 1e-5 of the plain autograd on the card (max "
          f"|diff| {err:.3g}), bitwise repeatable; {ms:.4f} ms per eager "
          f"autograd call ({host_ms:.4f} ms of host to issue it), its K1 "
          f"launch {device_ms:.4f} ms on the device ({nnz / device_ms * 1e3:.6g} "
          f"edges/s, HBM bound {bound_ms:.4f} ms, {bound_ms / device_ms:.1%}); "
          f"torch.sparse.mm {library_ms:.4f} ms eager, {library_device_ms:.4f} "
          f"ms on the device; plain {plain_ms:.4f} ms "
          f"({nnz / plain_ms * 1e3:.6g} edges/s)")

    # the full model's SSE gradients, through K1 and through the plain sum
    model = init_params(MWVCModel(*build_reference_arch()), seed=seed).cuda()
    y = torch.from_numpy((rng.random(n) < 0.5).astype(np.float32)).cuda()
    sample = TrainSample(dg=dg, y=y, n=n,
                         mask=torch.ones(n, dtype=torch.bool, device="cuda"))

    def grads():
        model.zero_grad(set_to_none=True)
        sse, _ = loss_and_metrics(model, sample, WEIGHT_SCALE)
        sse.backward()
        return [p.grad for p in model.parameters()]

    g_kernel = grads()
    step_ms = cuda_ms(grads, 5)
    kernel_aggregate = gnn_mod.csr_aggregate
    gnn_mod.csr_aggregate = csr_aggregate_plain  # the same model, plain K1
    try:
        g_plain = grads()
        plain_step_ms = cuda_ms(grads, 3)
    finally:
        gnn_mod.csr_aggregate = kernel_aggregate
    worst = 0.0
    for (name, _p), gk, gp in zip(model.named_parameters(), g_kernel, g_plain):
        if not (bool(torch.isfinite(gk).all()) and float(gp.abs().max()) > 0):
            fail(f"SSE gradient {name}: non-finite or all zero")
        rel = float((gk - gp).abs().max() / gp.abs().max())
        if rel > 1e-4:
            fail(f"SSE gradient {name}: K1 vs plain differ by {rel:.3g} "
                 "of the largest entry")
        worst = max(worst, rel)
    print(f"SSE gradient n={n} nnz={nnz}, {len(g_kernel)} tensors: K1 within "
          f"{worst:.3g} of the largest entry of the plain-aggregation "
          f"gradients (limit 1e-4); forward + backward {step_ms:.4f} ms "
          f"({nnz / step_ms * 1e3:.6g} edges/s), plain aggregation "
          f"{plain_step_ms:.4f} ms ({nnz / plain_step_ms * 1e3:.6g} edges/s)")
    return {"ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "max_abs_err": err, "bound_ms": bound_ms, "library_ms": library_ms,
            "library_device_ms": library_device_ms}


def phase_train(torch, seed):
    import math
    import tempfile

    from gnn_mwvc_tpu_torch.graph import build_road_graph
    from gnn_mwvc_tpu_torch.graphio import cover_cost, is_vertex_cover
    from gnn_mwvc_tpu_torch.models import (MWVCModel, build_reference_arch,
                                           init_params, load_model, save_model)
    from gnn_mwvc_tpu_torch.ops import _build
    from gnn_mwvc_tpu_torch.solver.pipeline import solve
    from gnn_mwvc_tpu_torch.train import (TrainConfig, gen_reduced_graph,
                                          make_sample, train)

    t0 = time.perf_counter()
    samples = []
    for i in range(TRAIN_GRAPHS):
        g = build_road_graph(TRAIN_SIDE, seed=seed + 100 + i)
        kernel, _cost, _ids = gen_reduced_graph(g)
        labels = solve(kernel, time_limit=0, device="cuda").solution
        samples.append(make_sample(kernel, labels, f"road{TRAIN_SIDE}_{i}",
                                   device="cuda"))
    prep_s = time.perf_counter() - t0
    vertices = sum(s.n for s in samples)
    if vertices < TRAIN_MIN_VERTICES:
        fail(f"train: {vertices} kernel vertices, under {TRAIN_MIN_VERTICES}")
    frac = sum(float(s.y.sum()) for s in samples) / vertices
    print(f"train data: {TRAIN_GRAPHS} x road{TRAIN_SIDE} kernels, "
          f"{vertices} vertices, {frac:.4f} labelled in the cover; "
          f"prep {prep_s:.3f} s")

    cfg = TrainConfig(epochs=2, seed=seed, log=True)
    start = init_params(MWVCModel(*build_reference_arch()), seed=cfg.seed)
    start_params = [p.detach().clone() for p in start.parameters()]
    _build.launches.clear()
    model, hist = train(samples, cfg, model=start, device="cuda")
    launches = dict(_build.launches)

    n_train = int(len(samples) * 0.9)
    losses = [(h["train"]["loss"], h["test"]["loss"]) for h in hist]
    if not all(math.isfinite(v) for pair in losses for v in pair):
        fail(f"train: non-finite losses {losses}")
    moved = max(float((p.detach().cpu() - q).abs().max())
                for p, q in zip(model.parameters(), start_params))
    if moved == 0:
        fail("train: the parameters did not move")
    back = launches.get("csr_aggregate_backward", 0)
    if back < 2 * n_train:
        fail(f"train: K1 backward launched {back} times for {n_train} "
             "training graphs")
    if min(h["steps"] for h in hist) < 2:
        fail(f"train: SGD steps per pass {[h['steps'] for h in hist]}, want >= 2")
    steps = sum(h["steps"] for h in hist)
    seconds = sum(h["train_seconds"] for h in hist)
    train_vertices = hist[0]["train"]["total"] * len(hist)
    print(f"train: {len(hist)} passes, {steps} SGD steps, {n_train} training "
          f"graphs ({hist[0]['train']['total']} vertices); "
          f"{seconds / steps * 1e3:.4f} ms per SGD step, "
          f"{train_vertices / seconds:.6g} vertices/s (gradient passes, host "
          f"clock; per pass {[round(h['train_seconds'], 4) for h in hist]} s); "
          f"losses (train, test) per pass {losses}; moved "
          f"{moved:.3g}; launches {launches}")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "model.txt")
        save_model(path, model)
        reloaded = MWVCModel.from_spec(load_model(path), device="cuda")
    for p, q in zip(model.parameters(), reloaded.parameters()):
        # the text format keeps 6 significant digits
        if not torch.allclose(p, q, rtol=1e-5, atol=1e-6):
            fail("train: the saved model does not reload to its parameters")
    g = build_road_graph(60, seed=seed)
    res = solve(g, model=reloaded, time_limit=2.0, device="cuda")
    if not is_vertex_cover(g, res.solution):
        fail("train: solve() with the trained model is not a vertex cover")
    if cover_cost(g, res.solution) != res.cost:
        fail("train: solve() with the trained model: cost does not match")
    print(f"trained model: saved, reloaded, solve() on road60 a valid cover "
          f"of cost {res.cost}")
    return launches


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
    return launches, res.solution


def phase_regions(torch, g, cover, int_ops_per_s):
    """K4 on one batch of regions as the assist extracts them
    (DeviceAssist.tick): centres sampled from the cover by the assist's
    pool (neutral scores, so uniform over the cover), regions cut by the
    local search around them."""
    import numpy as np

    from gnn_mwvc_tpu_torch.core import CoreLocalSearch
    from gnn_mwvc_tpu_torch.solver.device_assist import DeviceAssist

    t0 = time.perf_counter()
    ls = CoreLocalSearch(g.weights, g.edge_array(), cover)
    assist = DeviceAssist(np.full(g.n, 0.5, np.float32), device="cuda")
    centers = assist._sample_centers(ls)
    _ids, adj, w, ks = ls.extract_regions(centers, rmax=assist.rmax)
    prep_s = time.perf_counter() - t0
    d_adj = torch.from_numpy(adj).cuda()
    d_w = torch.from_numpy(w).cuda()
    err = check_k4(torch, d_adj, d_w, "road regions")
    ms, device_ms, plain_ms = time_k4(torch, d_adj, d_w, 3)
    b, n = adj.shape
    bound_ms = k4_ops(b, n) / int_ops_per_s * 1e3
    sizes = {int(k): int(c) for k, c in enumerate(np.bincount(ks)) if c}
    print(f"K4 road regions B={b} n={n}: bitwise equal; region sizes "
          f"{{k: count}} {sizes}; {ms:.5f} ms per eager call, {device_ms:.5f} "
          f"ms/batch on the device; bound {bound_ms:.6f} ms (int32); "
          f"plain {plain_ms:.4f} ms/batch; extraction {prep_s:.3f} s")
    return {"ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "max_abs_err": err, "bound_ms": bound_ms}


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
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm,clocks.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60)
    max_mhz, cur_mhz = (float(v) for v in
                        clocks.stdout.strip().splitlines()[0].split(","))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    int_ops_per_s = sms * INT32_LANES_PER_SM * max_mhz * 1e6
    print(f"clocks: SM max {max_mhz:g} MHz, now {cur_mhz:g} MHz; {sms} SMs, "
          f"int32 peak {int_ops_per_s:.6g} op/s; HBM {HBM_BYTES_PER_S:.3g} B/s")
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
    k4_err = phase_k4(torch, rng, int_ops_per_s)

    # 4. K1 and 5. forward on the road-like graph
    from gnn_mwvc_tpu_torch.graph import DeviceGraph, build_road_graph

    t0 = time.perf_counter()
    g = build_road_graph(args.side)
    dg = DeviceGraph.from_graph(g, "cuda")
    print(f"graph: road side {args.side}, n={g.n}, m={g.m}, "
          f"built in {time.perf_counter() - t0:.3f} s")
    k1 = phase_k1(torch, dg, rng)
    phase_forward(torch, g, dg, rng)
    k1_back = phase_backward(torch, dg, rng, args.seed)
    del dg
    torch.cuda.empty_cache()

    # 6. solve, then K4 on regions of its cover
    launches, cover = phase_solve(torch, g, args.time)
    k4_road = phase_regions(torch, g, cover, int_ops_per_s)
    del g, cover

    # 7. train
    train_launches = phase_train(torch, args.seed)

    timing = ("ms, plain_ms, library_ms: eager calls between CUDA events; "
              "device_ms, library_device_ms: a CUDA graph of 20 calls")
    print(json.dumps({"kernels": [
        {"name": "csr_aggregate", "route": "cuda",
         "source": "gnn_mwvc_tpu_torch/csrc/csr_aggregate.cu",
         "replaces": "gnn_mwvc_tpu/ops/aggregate.py:209",
         "launches": launches.get("csr_aggregate", 0),
         "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
         "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
         "bound_by": "bytes", "bound_kind": "hbm",
         "library_ms": k1["library_ms"], "device_ms": k1["device_ms"],
         "library_device_ms": k1["library_device_ms"], "timing": timing},
        {"name": "csr_aggregate_backward", "route": "cuda",
         "source": "gnn_mwvc_tpu_torch/csrc/csr_aggregate.cu",
         "replaces": "gnn_mwvc_tpu/train/trainer.py:66",
         "launches": train_launches.get("csr_aggregate_backward", 0),
         "max_abs_err": k1_back["max_abs_err"], "ms": k1_back["ms"],
         "plain_ms": k1_back["plain_ms"], "bound_ms": k1_back["bound_ms"],
         "bound_by": "bytes", "bound_kind": "hbm",
         "library_ms": k1_back["library_ms"],
         "device_ms": k1_back["device_ms"],
         "library_device_ms": k1_back["library_device_ms"],
         "timing": "ms, plain_ms: one torch.autograd.grad call and "
                   "library_ms: eager, between CUDA events; device_ms: its "
                   "K1 launch alone and library_device_ms: a CUDA graph of "
                   "20 calls"},
        {"name": "small_mwvc_mitm", "route": "cuda",
         "source": "gnn_mwvc_tpu_torch/csrc/smallsolve_mitm.cu",
         "replaces": "gnn_mwvc_tpu/ops/smallsolve_pallas.py:154",
         "launches": launches.get("small_mwvc_mitm", 0),
         "max_abs_err": max(k4_err, k4_road["max_abs_err"]),
         "ms": k4_road["ms"],
         "plain_ms": k4_road["plain_ms"], "bound_ms": k4_road["bound_ms"],
         "bound_by": "operations", "bound_kind": "int32",
         "library_ms": None, "device_ms": k4_road["device_ms"],
         "library_device_ms": None, "timing": timing},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
