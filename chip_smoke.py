#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (gnn_mwvc_tpu_torch) on one GPU,
and on several where the machine has them (phase 14).

Run from the repository root:  python3 chip_smoke.py [--time SECONDS]
                               python3 chip_smoke.py --multi-card
(``--multi-card``: phases 1, 2 and 14 alone; it fails on fewer than 2 cards;
without it one card runs phases 1-13 and 15)

Phases, each printing one line of its own numbers; any failure exits
non-zero:
  1. device  - a CUDA device is required; prints nvidia-smi name, power limit
               and SM clocks (the clock sets the integer-operation bound)
  2. build   - nvcc builds the kernels from gnn_mwvc_tpu_torch/csrc/
  3. K4      - region solver vs its plain version on the card, synthetic
               batches of B = 1, 7, 1024, 1500 at n = 16 and n = 20: bitwise
               equal; ms per eager call and on the device alone, regions/s;
               at n = 16, B = 1024 also bitwise equal to the 2^16-subset
               enumeration (ops/smallsolve.py) on the card
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
               launched in phase 1, K4 launched by the phase-2 assist; the
               sticky scorer's rounds under 4M live edges scored per
               snapshot on the card (at least one; their count printed);
               no kernel edge left open by the peel (the folds the core
               refused on a dependent neighbourhood printed).  Every phase
               that runs a phase 1 (6, 9, 10b, 13d, 15) fails on an open
               kernel edge and prints the refused folds
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
  8. prepass - the device rule prepass on the road-like graph: rule_masks and
               r5_candidates of the first snapshot on the card bitwise equal
               to the same ops on CPU copies (ms on each); then
               device_reduce_prepass(device="cuda") and the host reduce,
               beside a host-only reduce of a fresh core (kernel sizes,
               seconds); the masks' device checked; the prepassed core peeled
               with the sticky scorer on the card and unfolded to a valid
               cover
  9. surfaces - on a road-like (side 300) and a random instance written as
               METIS files, each as a subprocess on the card: gnn-vc-torch
               --quick, gnn-vc-torch (every round per snapshot, K1 in each
               round; its phase-1 split), gnn-vc-torch on the road-like
               graph (1,440,000 nodes, its METIS file written first) at
               --time 0 with every round per snapshot, the path on which the
               JAX package's core leaves a kernel edge open (a valid cover,
               no open edge, the refused folds printed), mwvc-batch-torch
               --json over both, solve() with a
               checkpoint then resume_solve() in a new process, mwvc-bench-
               torch on the road-like instance (our, approximation and
               baseline rows) and mwvc-tools-torch vc-validate; any non-zero
               exit fails, and so does a process that scores with the GNN
               without launching K1, or runs a phase 2 without launching K4
               (each prints its own launch counts)
  10. sharded - the multi-device path on the one card, on the road-like
               graph: (a) partition_device_graph at P = 2 and 4 on cuda:0
               (seconds, h_max, halo bytes beside a full gather's); one
               masked sticky-sharded forward of the published model with
               every shard's K1 output bitwise equal to its rows of the
               single-device K1 output, scores within 1e-5, 2 x P K1
               launches, ms beside the single-device forward (host clock
               between synchronises of every card); (b) solve()
               at time_limit=0 with ShardedGnnScorer over 4 shards of cuda:0,
               a valid cover, K1 launched in every mesh round, its cost
               beside a single-device phase-1 solve's; (c) 2 steps of the
               sharded train step at P = 4: finite, falling losses, first-step
               gradients within 1e-4 (of each tensor's largest entry) of the
               single-device MSE's, K1's backward launched on every shard;
               (d) two processes in a gloo world on cuda:0 (parallel.dryrun
               dist, road300): both exit 0, launch K1, and match the
               single-device forward within 1e-5; (e) gnn-vc-torch --shards 1
               on road300 as a subprocess, launching K1 and K4; (f) as (d)
               with 2 shards per rank (shards 0-1 and 2-3, copies within a
               rank, all_to_all_single between them), each rank allocating on
               cuda:0 alone, the train step's loss within 1e-5 of a local
               4-shard mesh's
  11. tools  - every port tool (gnn_mwvc_tpu_torch/tools/) in a subprocess on
               the card ((a) and (b) one each, (c)-(g) one together, each
               tool's launches counted from 0): (a) dump_kernel on the
               road-like graph, launching
               K1; (b) assist_ab on that kernel, the four phase-2 variants at
               10 s each, K4 launched by the region variants and only by
               them, none worse than the dumped cover; (c) canonical on
               road300 for 5 s, its CSV line, K1 and K4 launched;
               (d) sharded_solve on road300 at P = 4: identical covers;
               (e) er_slice_bench on ER n = 200,000, degree 16, P = 1 and 4:
               K1's device ms beside its HBM bound and torch.sparse.mm, K1
               within 1e-4 of its plain version; (f) scale_bench and
               scaling_weak: sharded scores within 1e-5 of one device's;
               (g) reduce_scale at side 450: both kernel sizes and times;
               (d) and (f) pass --device cuda:0, all P shards on the card
  14. multi-card - only with 2 or more cards (else one line says it did not
               run), P = 2 and 4 up to the card count, on the road-like
               graph: (a) phase 10a's checks with shard i on cuda:i, each
               K1 output on its shard's card, ms beside P shards of cuda:0
               and one device; (b) phase 10b with a card per shard beside
               4 shards of cuda:0 and one device, K1 on every card in the
               mesh rounds; (c) phase 10c on 4 cards, K1's backward on every
               card; (d) NCCL, a rank per card (parallel.dryrun dist): rows
               within 1e-5 of each rank's single-card forward, K1 on every
               rank, equal losses within 1e-5 of (c)'s first; (e) the same
               for 2 ranks x 2 cards; (f) gnn-vc-torch --shards 4 on road300
               (K1 and K4), sharded_solve, scale_bench and scaling_weak
               with --device cuda (a card per shard; identical covers, rows
               within 1e-5) and entry multichip 4, as subprocesses
  12. studies - in one subprocess on the card: (a) precision_study on the
               road-like graph relabelled by cluster_order: ms, edges/s and
               error vs the CPU fp32 forward at highest / mixed / default
               (TF32), highest within 2e-5; (b) train_quality cut to 4 corpus
               graphs, 2 epochs, 0.5 s budgets and 2 held-out graphs: the
               trained model's covers beside the published one's; (c)
               smallsolve_bench at B = 1024: K4 bitwise equal to its plain
               version (n = 16, 20) and to the enumeration (n = 16), then ms
               and regions/s of each
  13. last surfaces - (a) python -m gnn_mwvc_tpu_torch.bench as a
               subprocess: one JSON line with the JAX bench's keys, K1
               launched; its edges/s; (b) entry() on cuda:0: within 2e-5 of
               the plain forward on CPU copies, K1 launched; (c) road1200's
               cluster_order relabel, native (Graph.reorder) and numpy
               (reorder_plain): equal CSRs, seconds of each; (d) solve() on
               road1200 at time 0 with every per-snapshot round scored by the
               card's GnnScorer and also by the native CPU forward: within
               2e-5, ms of each per round and the size where they cross; (e)
               tools.kernel_dump on road300 (cut from road900) and
               tools.ls_run --variant perturb on its file for 10 s
  15. scale - python -m gnn_mwvc_tpu_torch.tools.canonical road1600 --time
               120 --seed 2 as a subprocess on the card (2,560,000 nodes,
               the largest instance of the JAX package's records), run from
               a copy of gnn_mwvc_tpu_torch/ alone in a temporary directory
               (no _build/, no JAX package; cwd and PYTHONPATH that
               directory), so g++ builds the core from the copy's core/src
               and nvcc the kernels from its csrc/: both libraries built in
               the copy, exit 0
               (the tool checks that the cover is valid and costs what it
               says), its CSV line equal to its JSON record, the written
               cover no dearer than the phase-1 cover, K1 launched in every
               phase-1 round and K4 in the phase-2 assist, no kernel edge
               left open; prints n, m, the kernel
               size, phase 1 split into relabel, reduce, score, peel and the
               rest, the sticky and per-snapshot rounds, LS steps, the
               assist's batches, patches (wide_patches: those that flip
               more than 16 vertices), gain and host share of phase 2, and
               the card's peak allocation
Then one JSON line of launch counts by path, one of per-kernel numbers, one
of the plain-torch device ops (``device_ops``: the rule masks, r5 and the
2^16 enumeration, which are not hand kernels), and as the last line
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
INT32_LANES_PER_SM = 64     # Hopper SM: 64 INT32 lanes a clock
SURFACE_SIDE = 300          # phase 9's road-like instance (90,000 nodes)
SURFACE_TIME = 5.0          # phase 9's per-run budget, seconds; phase 1
                            # on road300 leaves most of it to phase 2


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
    from gnn_mwvc_tpu_torch.tools._common import graph_ms

    ms = cuda_ms(lambda: small_mwvc_mitm(adj, w), 20)
    device_ms = graph_ms(lambda: small_mwvc_mitm(adj, w), 20)
    plain_ms = cuda_ms(lambda: small_mwvc_mitm_plain(adj, w), plain_iters)
    return ms, device_ms, plain_ms


def enumeration_ops(b):
    """int32 operations of the 2^16-subset enumeration for B instances of
    16 vertices: per subset and vertex the chosen bit (shift, AND), the
    covered test (AND, compare), the validity AND and the cost add (6); per
    subset the sentinel select, the minimum and the first-index select (3)."""
    return b * 2**16 * (16 * 6 + 3)


def phase_enumeration(torch, adj, w, int_ops_per_s):
    """The plain-torch 2^16 enumeration, the oracle of K4 at n = 16, on the
    card: bitwise equal to K4; its device-op numbers."""
    from gnn_mwvc_tpu_torch.ops.smallsolve import batched_small_mwvc
    from gnn_mwvc_tpu_torch.ops.smallsolve_mitm import small_mwvc_mitm
    from gnn_mwvc_tpu_torch.tools._common import HBM_BYTES_PER_S, hbm_bytes

    c0, s0 = batched_small_mwvc(adj, w)
    c1, s1 = small_mwvc_mitm(adj, w)
    torch.cuda.synchronize()
    if c0.device.type != "cuda":
        fail("enumeration: result not on the card")
    if not (torch.equal(c0, c1) and torch.equal(s0, s1)):
        fail(f"enumeration: {int(((c0 != c1) | (s0 != s1)).sum())} of "
             f"{len(c0)} instances differ from K4")
    b = adj.shape[0]
    ms = cuda_ms(lambda: batched_small_mwvc(adj, w), 5)
    ops = enumeration_ops(b)
    bound_ms = max(ops / int_ops_per_s, hbm_bytes(adj, w, c0, s0)
                   / HBM_BYTES_PER_S) * 1e3
    print(f"enumeration n=16 B={b}: bitwise equal to K4 on the card; "
          f"{ms:.4f} ms on the card; bound {bound_ms:.5f} ms (int32, {ops} "
          "ops)")
    return {"name": "batched_small_mwvc", "route": "plain torch",
            "source": "gnn_mwvc_tpu_torch/ops/smallsolve.py",
            "replaces": "gnn_mwvc_tpu/ops/smallsolve.py:44",
            "shape": f"B={b}, n=16", "ms": ms, "cpu_ms": None,
            "bound_ms": bound_ms, "bound_by": "operations", "ops": ops}


def phase_k4(torch, rng, int_ops_per_s):
    """Returns the largest |cost difference| over all batches (0) and the
    enumeration's device-op numbers."""
    err = 0
    enum = None
    for n in (16, 20):
        for b in (1, 7, 1024, 1500):
            adj, w = region_batch(rng, b, n)
            d_adj = torch.from_numpy(adj).cuda()
            d_w = torch.from_numpy(w).cuda()
            err = max(err, check_k4(torch, d_adj, d_w, f"n={n} B={b}"))
            if n == 16 and b == 1024:
                enum = phase_enumeration(torch, d_adj, d_w, int_ops_per_s)
            ms, device_ms, plain_ms = time_k4(torch, d_adj, d_w,
                                              3 if b >= 1024 else 5)
            bound_ms = k4_ops(b, n) / int_ops_per_s * 1e3
            print(f"K4 n={n} B={b}: bitwise equal; {ms:.5f} ms per eager call "
                  f"({b / ms * 1e3:.6g} regions/s), {device_ms:.5f} ms/batch on "
                  f"the device; bound {bound_ms:.6f} ms (int32, "
                  f"{k4_ops(b, n)} ops); plain {plain_ms:.4f} ms/batch")
    return err, enum


def phase_k1(torch, dg, rng):
    import numpy as np

    from gnn_mwvc_tpu_torch.ops.aggregate import (csr_aggregate,
                                                  csr_aggregate_plain)
    from gnn_mwvc_tpu_torch.tools._common import graph_ms, hbm_bound_ms

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
    from gnn_mwvc_tpu_torch.tools._common import graph_ms, hbm_bound_ms
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


def open_edges(p1):
    """The phase-1 record's kernel edges left open and refused folds."""
    return (f"kernel_edges_uncovered {p1.get('kernel_edges_uncovered')}, "
            f"dependent_folds {p1.get('dependent_folds')}")


def check_open_edges(p1, what):
    """Fails unless the peel left no kernel edge open: the port's core
    refuses the folds on a dependent neighbourhood that leave one (they are
    counted in ``dependent_folds``, which must be recorded)."""
    if p1.get("kernel_edges_uncovered") != 0 or "dependent_folds" not in p1:
        fail(f"{what}: {open_edges(p1)}; the peel must leave no kernel edge "
             "open")


def phase_solve(torch, g, time_limit):
    import io

    from gnn_mwvc_tpu_torch.graphio import cover_cost, is_vertex_cover, read_metis
    from gnn_mwvc_tpu_torch.ops import _build
    from gnn_mwvc_tpu_torch.solver.pipeline import solve
    from gnn_mwvc_tpu_torch.solver.static_score import StickyGnnScorer

    ex3 = read_metis(io.BytesIO(b"3 2 10\n15 3\n15 3\n20 1 2\n"))
    r = solve(ex3, time_limit=1.0, device="cuda")
    if r.cost != 20 or list(r.solution) != [0, 0, 1]:
        fail(f"solve ex3: cost {r.cost}, cover {list(r.solution)}; want 20, [0, 0, 1]")

    # solve()'s own default scorer, built here to read its routing
    scorer = StickyGnnScorer(device="cuda")
    _build.launches.clear()
    t0 = time.perf_counter()
    res = solve(g, time_limit=time_limit, device="cuda", scorer=scorer)
    wall = time.perf_counter() - t0
    launches = dict(_build.launches)
    if not is_vertex_cover(g, res.solution):
        fail("solve: result is not a vertex cover")
    if cover_cost(g, res.solution) != res.cost:
        fail("solve: cost does not match the cover")
    p1 = res.phase1
    check_open_edges(p1, "solve")
    k1 = launches.get("csr_aggregate", 0)
    k4 = launches.get("small_mwvc_mitm", 0)
    if p1["rounds"] < 1 or k1 < 2 * p1["rounds"]:
        fail(f"solve: K1 launched {k1} times over {p1['rounds']} phase-1 rounds")
    sticky, legacy = scorer.stats["rounds"], scorer.stats["legacy_rounds"]
    snap_dev = getattr(scorer._snapshot_scorer, "device", None)
    if sticky + legacy != p1["rounds"] or legacy < 1 or \
            snap_dev is None or snap_dev.type != "cuda":
        fail(f"solve: {sticky} sticky + {legacy} per-snapshot rounds of "
             f"{p1['rounds']}, per-snapshot device {snap_dev}")
    print(f"solve routing: {sticky} sticky rounds, {legacy} per-snapshot "
          f"rounds on {snap_dev} (under {scorer.min_live_edges:,} live "
          f"directed edges); score {p1['spans']['score']['seconds']:.3f} s; K1 "
          f"{k1} launches over {p1['rounds']} rounds")
    stats = res.assist_stats or {}
    if k4 < 1 or stats.get("batches", 0) < 1:
        fail(f"solve: K4 launched {k4} times, assist batches {stats.get('batches')}")
    phase2 = res.time_total - res.time_gnn
    print(f"solve n={g.n} m={g.m} T={time_limit}: phase1 {res.time_gnn:.3f} s "
          f"(reduce {p1['t_reduce0_s']:.3f}, score {p1['t_score_s']:.3f}, "
          f"peel {p1['t_peel_s']:.3f}, rounds {p1['rounds']}, "
          f"{open_edges(p1)}), phase2 "
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

def r5_ops(deg):
    """int32 operations r5_candidates needs: for each vertex of degree <= 8,
    the exact MWVC of its neighbourhood over 2^8 subsets; per subset and
    neighbour slot the chosen bit (shift, AND), the covered test (AND,
    compare), the validity AND and the cost add (6), per subset the
    sentinel select and the minimum (2)."""
    return int((deg <= 8).sum()) * 256 * (8 * 6 + 2)


def phase_prepass(torch, g, int_ops_per_s):
    """The device rule prepass on the full graph; returns its device-op
    numbers (rule_masks, r5_candidates)."""
    import numpy as np

    from gnn_mwvc_tpu_torch.core import CoreSolver
    from gnn_mwvc_tpu_torch.graphio import cover_cost, is_vertex_cover
    from gnn_mwvc_tpu_torch.ops import _build, rules
    from gnn_mwvc_tpu_torch.solver.device_reduce import device_reduce_prepass
    from gnn_mwvc_tpu_torch.solver.pipeline import gnn_peel
    from gnn_mwvc_tpu_torch.solver.static_score import StickyGnnScorer
    from gnn_mwvc_tpu_torch.tools._common import HBM_BYTES_PER_S, hbm_bytes

    core = CoreSolver(g.weights, g.edge_array())
    snap = core.snapshot()          # the snapshot the prepass starts from
    n = snap.n
    mask_in = rules.mask_inputs(snap.weights, snap.indptr, snap.indices)
    ell, ellv = rules.build_ell8(snap.indptr.astype(np.int64),
                                 snap.indices.astype(np.int64), snap.deg)
    r5_in = (ell, ellv, snap.weights.astype(np.int32),
             snap.nw.astype(np.int32), snap.deg.astype(np.int32))
    outs, ms = {}, {}
    for dev in ("cuda", "cpu"):
        m_in = [torch.from_numpy(a).to(dev) for a in mask_in]
        f_in = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in r5_in]
        ones = torch.ones(n, dtype=torch.bool, device=dev)
        masks = rules.rule_masks(*m_in, ones)
        r5 = rules.r5_candidates(*f_in, ones)
        if dev == "cuda":
            torch.cuda.synchronize()
            if any(t.device.type != "cuda" for t in [r5, *masks.values()]):
                fail("prepass: masks not computed on the card")
            ms["rule_masks"] = cuda_ms(lambda: rules.rule_masks(*m_in, ones), 5)
            ms["r5_candidates"] = cuda_ms(
                lambda: rules.r5_candidates(*f_in, ones), 3)
            bytes_masks = hbm_bytes(*m_in, ones, masks["r1"],
                                    masks["dom_edge"], masks["iso_cand"]) \
                + 4 * n                       # the uint32 twin key
            bytes_r5 = hbm_bytes(*f_in, ones, r5)
        else:
            t0 = time.perf_counter()
            rules.rule_masks(*m_in, ones)
            ms["rule_masks_cpu"] = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            rules.r5_candidates(*f_in, ones)
            ms["r5_candidates_cpu"] = (time.perf_counter() - t0) * 1e3
        outs[dev] = {**{k: v.cpu() for k, v in masks.items()}, "r5": r5.cpu()}
    for key in outs["cpu"]:
        if not torch.equal(outs["cuda"][key], outs["cpu"][key]):
            bad = int((outs["cuda"][key] != outs["cpu"][key]).sum())
            fail(f"prepass: {key} on the card differs from the CPU in {bad} "
                 "places")
    counts = {k: int(v.sum()) for k, v in outs["cpu"].items()
              if v.dtype == torch.bool}
    ops5 = r5_ops(snap.deg)
    bound_masks = bytes_masks / HBM_BYTES_PER_S * 1e3
    bound_r5 = max(ops5 / int_ops_per_s, bytes_r5 / HBM_BYTES_PER_S) * 1e3
    print(f"prepass masks n={n} e={len(snap.indices)}: r1, twin_key, dom_edge, "
          f"iso_cand and r5 bitwise equal on the card and the CPU (all "
          f"vertices; set bits {counts}); rule_masks {ms['rule_masks']:.4f} ms "
          f"on the card, {ms['rule_masks_cpu']:.1f} ms on the host CPU, bound "
          f"{bound_masks:.5f} ms ({bytes_masks} bytes); r5_candidates "
          f"{ms['r5_candidates']:.4f} ms on the card, "
          f"{ms['r5_candidates_cpu']:.1f} ms on the host CPU, bound "
          f"{bound_r5:.5f} ms (int32, {ops5} ops)")
    del outs

    rules.calls.clear()
    t0 = time.perf_counter()
    stats = device_reduce_prepass(core, device="cuda")
    t_prepass = time.perf_counter() - t0
    calls = dict(rules.calls)
    if stats["rounds"] < 1 or calls.get("rule_masks/cuda") != stats["rounds"] \
            or any(k.endswith("/cpu") for k in calls):
        fail(f"prepass: rounds {stats['rounds']}, mask calls {calls}")
    after_prepass = core.active_count
    t0 = time.perf_counter()
    core.reduce()
    t_finish = time.perf_counter() - t0
    fresh = CoreSolver(g.weights, g.edge_array())
    t0 = time.perf_counter()
    fresh.reduce()
    t_host = time.perf_counter() - t0
    print(f"prepass: stats {json.dumps(stats)}, mask calls {calls}; "
          f"{t_prepass:.3f} s on the card, {after_prepass} nodes left, then "
          f"host reduce {t_finish:.3f} s to a kernel of {core.active_count} "
          f"(cost {core.cost}); host-only reduce of a fresh core {t_host:.3f} s "
          f"to a kernel of {fresh.active_count} (cost {fresh.cost})")
    del fresh

    _build.launches.clear()
    t0 = time.perf_counter()
    _t_kernel, _size, _cost, split = gnn_peel(
        core, StickyGnnScorer(device="cuda"), float(g.weights.max()))
    core.unfold(0)
    sol = core.solution()
    t_peel = time.perf_counter() - t0
    if (sol < 0).any() or not is_vertex_cover(g, sol):
        fail("prepass: the peeled cover is not a vertex cover")
    if cover_cost(g, sol) != core.cost:
        fail("prepass: cost does not match the cover")
    if _build.launches.get("csr_aggregate", 0) < 2 * split["rounds"]:
        fail(f"prepass: peel launched K1 {dict(_build.launches)} over "
             f"{split['rounds']} rounds")
    print(f"prepass peel: {split['rounds']} rounds with the sticky scorer on "
          f"the card in {t_peel:.3f} s; valid cover of cost {core.cost}; "
          f"launches {dict(_build.launches)}")
    common = {"route": "plain torch", "source": "gnn_mwvc_tpu_torch/ops/rules.py",
              "shape": f"n={n}, e={len(snap.indices)}",
              "calls_in_prepass": stats["rounds"]}
    return [
        {"name": "rule_masks", "replaces": "gnn_mwvc_tpu/ops/rules.py:48",
         "ms": ms["rule_masks"], "cpu_ms": ms["rule_masks_cpu"],
         "bound_ms": bound_masks, "bound_by": "bytes", "bytes": bytes_masks,
         **common},
        {"name": "r5_candidates", "replaces": "gnn_mwvc_tpu/ops/rules.py:113",
         "ms": ms["r5_candidates"], "cpu_ms": ms["r5_candidates_cpu"],
         "bound_ms": bound_r5, "bound_by": "operations", "ops": ops5,
         **common},
    ]


SURFACE_LAUNCHES = {}  # run_surfaces' launch counts, by what

# Runs entry points as ``__main__`` in one process, one after the other:
# argv[1] is a JSON list of [what, target, args], the target a module or a
# script file (``.py``).  Each starts with the launch counts at 0, prints
# "=== what" to stdout first and, however it ends, writes its counts to
# stderr; a non-zero exit ends the process with it.
LAUNCH_PROBE = (
    "import json, runpy, sys\n"
    "from gnn_mwvc_tpu_torch.ops import _build\n"
    "for what, target, args in json.loads(sys.argv[1]):\n"
    "    _build.launches.clear()\n"
    "    print('=== ' + what, flush=True)\n"
    "    sys.argv = [target, *args]\n"
    "    try:\n"
    "        if target.endswith('.py'):\n"
    "            runpy.run_path(target, run_name='__main__')\n"
    "        else:\n"
    "            runpy.run_module(target, run_name='__main__', alter_sys=True)\n"
    "    except SystemExit as e:\n"
    "        if e.code not in (0, None):\n"
    "            raise\n"
    "    finally:\n"
    "        sys.stdout.flush()\n"
    "        sys.stderr.write('\\nLAUNCHES ' + json.dumps(\n"
    "            [what, dict(_build.launches)]) + '\\n')\n")


def run_surfaces(runs, timeout=600, root=HERE):
    """Port entry points ``(what, target, args, need)``, a module or a
    script file each, in one subprocess of this interpreter from ``root``
    (the checkout, or a directory that holds a copy of the port), which
    saves each one's start-up (~10 s on the card's machine).  A non-zero
    exit fails the smoke, and so does a kernel of ``need`` that an entry
    point never launched.  Returns each one's stdout, by what."""
    t0 = time.perf_counter()
    spec = [[what, target, [str(a) for a in args]]
            for what, target, args, _need in runs]
    out = subprocess.run(
        [sys.executable, "-c", LAUNCH_PROBE, json.dumps(spec)],
        capture_output=True, text=True, timeout=timeout, cwd=root,
        env=dict(os.environ, PYTHONPATH=root))
    if out.returncode != 0:
        fail(f"{[r[0] for r in runs]}: exit {out.returncode}\n"
             f"{out.stdout[-2000:]}\n{out.stderr[-3000:]}")
    texts, what = {}, None
    for ln in out.stdout.splitlines(keepends=True):
        if ln.startswith("=== "):
            what = ln[4:].strip()
            texts[what] = ""
        elif what is not None:
            texts[what] += ln
    for ln in out.stderr.splitlines():
        if ln.startswith("LAUNCHES "):
            what, counts = json.loads(ln[len("LAUNCHES "):])
            SURFACE_LAUNCHES[what] = counts
    for what, _target, _args, need in runs:
        launches = SURFACE_LAUNCHES.get(what)
        if launches is None or what not in texts:
            fail(f"{what}: no output or launch counts\n{out.stderr[-2000:]}")
        missing = [k for k in need if launches.get(k, 0) < 1]
        if missing:
            fail(f"{what}: launched no {missing}; launches {launches}")
        last = (texts[what].strip().splitlines() or [""])[-1]
        print(f"surface {what}: exit 0; launches {launches}; {last[:300]}")
    print(f"surfaces {[r[0] for r in runs]}: one process, "
          f"{time.perf_counter() - t0:.3f} s")
    return texts


def run_surface(what, target, args, need=(), timeout=300, root=HERE):
    """One entry point in a subprocess of its own; returns its stdout."""
    return run_surfaces([(what, target, args, need)], timeout, root)[what]


def phase_surfaces(seed, big):
    """Every new single-device entry point, each in its own process on the
    card (the default device).  Each one that scores with the GNN must
    launch K1, and each one with a phase 2 must launch K4 in its assist.
    ``big``: the road-like graph that gnn-vc-torch also solves at time 0."""
    import tempfile

    from gnn_mwvc_tpu_torch.graph import build_road_graph, random_graph
    from gnn_mwvc_tpu_torch.graphio import (cover_cost, is_vertex_cover,
                                            read_solution, write_metis)

    graphs = {f"road{SURFACE_SIDE}": build_road_graph(SURFACE_SIDE, seed=seed),
              "rnd20k": random_graph(20_000, 16, seed=seed, wmax=1000)}
    both = ("csr_aggregate", "small_mwvc_mitm")
    t = str(SURFACE_TIME)
    with tempfile.TemporaryDirectory(prefix="mwvc_surfaces_") as tmp:
        paths = {}
        for name, g in graphs.items():
            paths[name] = os.path.join(tmp, name + ".metis")
            write_metis(paths[name], g)
        road = f"road{SURFACE_SIDE}"
        g = graphs[road]

        def checked_cover(path, cost, what):
            sol = read_solution(path)
            if not is_vertex_cover(g, sol) or cover_cost(g, sol) != cost:
                fail(f"{what}: the written cover is invalid or costs "
                     f"{cover_cost(g, sol)}, not {cost}")
            return sol

        def script(name, body):
            path = os.path.join(tmp, name)
            with open(path, "w") as f:
                f.write("import json\n"
                        "from gnn_mwvc_tpu_torch.graphio import read_metis\n"
                        f"g = read_metis({paths[road]!r})\n" + body)
            return path

        # --quick scores without the GNN: K4 in phase 2 only
        sol_path = os.path.join(tmp, road + ".sol")
        line = run_surface("gnn-vc-torch --quick",
                           "gnn_mwvc_tpu_torch.solver.cli",
                           [paths[road], sol_path, t, "-1", "0", "--quick"],
                           need=("small_mwvc_mitm",)
                           ).strip().splitlines()[-1].split(",")
        if line[0] != road or len(line) not in (4, 8):
            fail(f"gnn-vc-torch --quick: CSV line {line}")
        quick_cost = int(line[1] if len(line) == 4 else line[6])
        checked_cover(sol_path, quick_cost, "gnn-vc-torch --quick")

        # the default: every round scored per snapshot (GnnScorer), on the
        # card, K1 in each round and K4 in the phase-2 assist; then the
        # full road-like graph at time 0 (phase 1 alone), where the JAX
        # package's core folds dependent neighbourhoods and leaves a kernel
        # edge open.  One process for both.
        big_road = f"road{int(round(big.n ** 0.5))}"
        big_path = os.path.join(tmp, big_road + ".metis")
        t0 = time.perf_counter()
        write_metis(big_path, big)
        t_write = time.perf_counter() - t0
        big_what = f"gnn-vc-torch {big_road} --time 0"
        gnn_sol = os.path.join(tmp, road + ".gnn.sol")
        big_sol = os.path.join(tmp, big_road + ".gnn.sol")
        cli = "gnn_mwvc_tpu_torch.solver.cli"
        texts = run_surfaces([
            ("gnn-vc-torch", cli,
             [paths[road], gnn_sol, t, "-1", "0", "--json"], both),
            (big_what, cli, [big_path, big_sol, "0", "-1", "0", "--json"],
             ("csr_aggregate",))])
        for what, name, graph, sol in (("gnn-vc-torch", road, g, gnn_sol),
                                       (big_what, big_road, big, big_sol)):
            rec = json.loads(texts[what].strip().splitlines()[-1])
            p1 = rec["phase1"]
            check_open_edges(p1, what)
            k1 = SURFACE_LAUNCHES[what].get("csr_aggregate", 0)
            if rec["device"] != "cuda" or p1["rounds"] < 1 or \
                    k1 < 2 * p1["rounds"]:
                fail(f"{what}: K1 launched {k1} times over "
                     f"{p1['rounds']} rounds: {rec}")
            if "rebuilds" in p1["scorer"]:   # a sticky scorer's count
                fail(f"{what}: phase 1 was not scored per snapshot: {p1}")
            cover = read_solution(sol)
            if not is_vertex_cover(graph, cover) or \
                    cover_cost(graph, cover) != rec["cost"]:
                fail(f"{what}: the written cover is invalid or costs "
                     f"{cover_cost(graph, cover)}, not {rec['cost']}")
            print(f"{what} ({name}, n={rec['n']}): per-snapshot phase 1 "
                  f"{rec['time_gnn']:.3f} s (reduce {p1['t_reduce0_s']:.3f}, "
                  f"score {p1['t_score_s']:.3f}, peel {p1['t_peel_s']:.3f}, "
                  f"rounds {p1['rounds']}), K1 {k1} launches; kernel "
                  f"{rec['kernel_size']}; {open_edges(p1)}; cost "
                  f"{rec['cost']}, best seen {rec['best_seen']}, ls_steps "
                  f"{rec['ls_steps']}, {rec['time_total']:.3f} s in all")
        print(f"{big_what}: its METIS file written in {t_write:.3f} s")
        del cover

        out_dir = os.path.join(tmp, "batch")
        rows = [json.loads(ln) for ln in run_surface(
            "mwvc-batch-torch", "gnn_mwvc_tpu_torch.solver.batch",
            [*paths.values(), "--out", out_dir, "--time", t, "--json"],
            need=both).splitlines() if ln.startswith("{")]
        if rows[-1].get("instances") != 2 or any(
                r.get("device") != "cuda" for r in rows[:-1]):
            fail(f"mwvc-batch-torch: rows {rows}")
        checked_cover(rows[0]["solution"], rows[0]["cost"], "mwvc-batch-torch")

        ckpt = os.path.join(tmp, road + ".ckpt.npz")
        first = json.loads(run_surface("solve with a checkpoint", script(
            "ckpt_solve.py",
            "from gnn_mwvc_tpu_torch.solver.pipeline import solve\n"
            "from gnn_mwvc_tpu_torch.solver.checkpoint import load_checkpoint\n"
            f"r = solve(g, time_limit={3 * SURFACE_TIME}, "
            f"checkpoint_path={ckpt!r}, checkpoint_interval=0.0)\n"
            f"c, m = load_checkpoint({ckpt!r}, g)\n"
            "print(json.dumps({'cost': r.cost, 'checkpoint_cost': m['cost'], "
            "'assist': r.assist_stats}))\n"), [], need=both
        ).strip().splitlines()[-1])
        if first["checkpoint_cost"] < first["cost"] or not first["assist"]:
            fail(f"solve with a checkpoint: {first}")
        # resume_solve is the host local search alone: no kernel to launch
        second = json.loads(run_surface("resume_solve", script(
            "resume.py",
            "from gnn_mwvc_tpu_torch.solver.checkpoint import resume_solve\n"
            f"b, c, s = resume_solve(g, {ckpt!r}, 3.0)\n"
            "print(json.dumps({'cost': c}))\n"), []
        ).strip().splitlines()[-1])
        if second["cost"] > first["checkpoint_cost"]:
            fail(f"resume_solve: cost {second['cost']} worse than the "
                 f"checkpoint's {first['checkpoint_cost']}")

        # on the road graph, where a kernel is left for the GNN and phase 2
        (row,) = json.loads(run_surface(
            "mwvc-bench-torch", "gnn_mwvc_tpu_torch.solver.benchmark",
            [paths[road], "--time", t, "--json", "--solvers",
             "gnn,quick,approx,fastwvc,ref:GNN_VC"], need=both
        ).strip().splitlines()[-1])
        if any(not row.get(s) for s in ("gnn", "quick", "approx", "fastwvc")):
            fail(f"mwvc-bench-torch: row {row}")

        out = run_surface("mwvc-tools-torch vc-validate",
                          "gnn_mwvc_tpu_torch.graphio.cli",
                          ["vc-validate", paths[road], sol_path])
        if f"cost {quick_cost}" not in out:
            fail(f"mwvc-tools-torch vc-validate: {out.strip()}")
    print(f"surfaces: quick cost {quick_cost}; batch costs "
          f"{[r['cost'] for r in rows[:-1]]}; checkpoint {first}, resumed "
          f"{second}; bench {json.dumps(row)}")


SHARD_COUNTS = (2, 4)       # phase 10's shards on the one card
DIST_SIDE = 300             # phase 10d's road-like graph over 2 gloo ranks
DIST_TIMEOUT = 600          # seconds for a process-group world to finish


def recorded(module, fn):
    """Run fn with ``module.csr_aggregate`` recording each call: returns
    fn's result, the outputs and the (args, kwargs) of every call."""
    kernel = module.csr_aggregate
    outs, calls = [], []

    def record(*args, **kw):
        outs.append(kernel(*args, **kw))
        calls.append((args, kw))
        return outs[-1]

    module.csr_aggregate = record
    try:
        return fn(), outs, calls
    finally:
        module.csr_aggregate = kernel


def check_block_against_plain(torch, call, out, what):
    """K1's output on a shard's block against the plain version on the same
    inputs: within 1e-5 on the card (its index_add_ adds in another order)
    and bitwise on CPU copies (CSR order, as K1); returns the card's
    largest |diff|."""
    from gnn_mwvc_tpu_torch.ops.aggregate import csr_aggregate_plain

    x, indptr, indices, m = call[:4]
    want = csr_aggregate_plain(x, indptr, indices, m)
    err = float((out - want).abs().max())
    if not torch.allclose(out, want, rtol=1e-5, atol=1e-5):
        fail(f"{what}: K1 differs from the plain version by {err}")
    cpu = csr_aggregate_plain(*(None if t is None else t.cpu()
                                for t in (x, indptr, indices, m)))
    if not torch.equal(out.cpu(), cpu):
        fail(f"{what}: K1 not bitwise equal to the CPU plain version (max "
             f"|diff| {float((out.cpu() - cpu).abs().max())})")
    return err


def one_card(parts):
    """Phase 10's layout: every shard on cuda:0."""
    return ["cuda:0"] * parts


def per_card(parts):
    """Phase 14's layout: shard i on cuda:i."""
    return [f"cuda:{i}" for i in range(parts)]


def k1_by_card(fn):
    """Run fn with every K1 launch (forward and backward) counted by the
    card it ran on: returns fn's result and {"<counter>@cuda:i": n}.  The
    wrappers' own counts (``_build.launches``) are by name alone."""
    import collections
    import threading

    import gnn_mwvc_tpu_torch.ops.aggregate as agg

    kernel, counts = agg._aggregate, collections.Counter()
    lock = threading.Lock()   # autograd's per-card threads launch backwards

    def record(x, indptr, indices, mask, counter):
        out = kernel(x, indptr, indices, mask, counter)
        if out.device.type == "cuda":
            with lock:
                counts[f"{counter}@{out.device}"] += 1
        return out

    agg._aggregate = record
    try:
        return fn(), dict(sorted(counts.items()))
    finally:
        agg._aggregate = kernel


def check_every_card(by_card, counter, devices, least, what):
    """Fail unless K1's ``counter`` ran at least ``least`` times on each
    CUDA device of ``devices``."""
    for d in dict.fromkeys(str(d) for d in devices):
        if by_card.get(f"{counter}@{d}", 0) < least:
            fail(f"{what}: {counter} ran {by_card.get(f'{counter}@{d}', 0)} "
                 f"times on {d}, want {least} or more ({by_card})")


def phase_sharded_forward(torch, g, rng, layouts, counts=SHARD_COUNTS):
    """10a / 14a: partitions at each P of ``counts`` (``layouts``: name ->
    the devices of P shards) and one masked forward each, every shard's K1
    output on its shard's card and bitwise equal to its rows of the
    single-device K1's and to the plain version on its own block; ms of
    each with every card synchronised, beside the single device's."""
    import numpy as np

    import gnn_mwvc_tpu_torch.models.gnn as gnn_mod
    import gnn_mwvc_tpu_torch.parallel.sharded as sharded_mod
    from gnn_mwvc_tpu_torch.graph import DeviceGraph
    from gnn_mwvc_tpu_torch.models import pretrained_model
    from gnn_mwvc_tpu_torch.ops import _build
    from gnn_mwvc_tpu_torch.ops.aggregate import csr_aggregate
    from gnn_mwvc_tpu_torch.parallel import (ShardedGraph, gather_scores,
                                             make_mesh, make_sharded_forward,
                                             make_sticky_sharded_forward,
                                             mesh_seconds_per_call,
                                             partition_device_graph,
                                             synchronize)
    from gnn_mwvc_tpu_torch.tools._common import graph_ms, hbm_bound_ms

    dg = DeviceGraph.from_graph(g, "cuda:0")
    model = pretrained_model("cuda:0")
    ws = float(g.weights.max())
    alive = rng.random(g.n) < 0.7
    mask = torch.from_numpy(alive.astype(np.float32)).cuda()

    def single():
        x = (dg.weights / ws * mask).reshape(-1, 1)
        with torch.no_grad():
            return model(x, dg, ws, x_is_node_weights=True,
                         source_mask=mask)[:, 0]

    want, want_aggs, _calls = recorded(gnn_mod, single)
    single_ms = mesh_seconds_per_call(single, ["cuda:0"], 10) * 1e3
    rows = {}
    for parts in counts:
        rows[parts] = {}
        for layout, place in layouts.items():
            mesh = make_mesh(parts, devices=place(parts))
            synchronize(mesh.devices)
            t0 = time.perf_counter()
            sg = partition_device_graph(dg, parts, devices=mesh)
            synchronize(mesh.devices)
            part_s = time.perf_counter() - t0
            n_loc = sg.n_loc
            live = torch.zeros(4, parts * n_loc, device="cuda:0")
            live[:, :g.n] = torch.stack([dg.weights, dg.nw, dg.degrees, mask])
            bufs = [b.to(d).contiguous()
                    for b, d in zip(live.split(n_loc, dim=1), mesh.devices)]
            del live
            fwd = make_sticky_sharded_forward(model, mesh)
            _build.launches.clear()
            (got, aggs, calls), by_card = k1_by_card(
                lambda: recorded(sharded_mod, lambda: fwd(sg, bufs, ws)))
            synchronize(mesh.devices)
            k1 = _build.launches["csr_aggregate"]
            if k1 != 2 * parts or len(aggs) != 2 * parts:
                fail(f"sharded forward P={parts} ({layout}): {k1} K1 "
                     f"launches, want {2 * parts}")
            check_every_card(by_card, "csr_aggregate", mesh.devices,
                             2 * parts // len(set(mesh.devices)),
                             f"sharded forward P={parts} ({layout})")
            plain_err = 0.0
            for layer in range(2):
                for p in range(parts):
                    real = int(sg.shards[p].node_mask.sum())
                    lo = p * n_loc
                    a = aggs[layer * parts + p]
                    if a.device != mesh.devices[p]:
                        fail(f"sharded forward P={parts} ({layout}): shard "
                             f"{p}'s K1 ran on {a.device}, not "
                             f"{mesh.devices[p]}")
                    ref = want_aggs[layer][lo:lo + real]
                    if not torch.equal(a[:real].to(ref.device), ref):
                        diff = float((a[:real].to(ref.device) - ref)
                                     .abs().max())
                        fail(f"sharded forward P={parts} ({layout}): shard "
                             f"{p}'s K1 output of graph layer {layer + 2} "
                             f"differs from the single-device K1's rows "
                             f"(max |diff| {diff})")
                    plain_err = max(plain_err, check_block_against_plain(
                        torch, calls[layer * parts + p][0], a,
                        f"sharded forward P={parts} ({layout}), shard {p}, "
                        f"graph layer {layer + 2}"))
            scores = torch.from_numpy(gather_scores(sg, got))
            err = float((scores - want.cpu())[torch.from_numpy(alive)]
                        .abs().max())
            if not bool(torch.isfinite(scores).all()) or err > 1e-5:
                fail(f"sharded forward P={parts} ({layout}): scores differ "
                     f"by {err}")
            ms = mesh_seconds_per_call(lambda: fwd(sg, bufs, ws),
                                       mesh.devices, 10) * 1e3
            # the unmasked forward of parallel.dryrun dist, for its ranks
            plain_fwd = make_sharded_forward(model, mesh,
                                             x_is_node_weights=True)
            unmasked_ms = mesh_seconds_per_call(lambda: plain_fwd(sg, ws),
                                                mesh.devices, 10) * 1e3
            # K1 alone on one inner shard's block (graph layer 2's call),
            # on that shard's card
            shard = min(1, parts - 1)
            x, indptr, indices, m = calls[shard][0][:4]
            with torch.cuda.device(x.device):
                block_ms = cuda_ms(
                    lambda: csr_aggregate(x, indptr, indices, m, block=True),
                    20)
                block_device_ms = graph_ms(
                    lambda: csr_aggregate(x, indptr, indices, m, block=True),
                    20)
            block_bound = hbm_bound_ms(indptr, indices, x, m, aggs[shard])
            full = ShardedGraph(n=g.n, n_loc=n_loc, parts=parts, h_max=0,
                                shards=[]).halo_bytes_per_chip(16)
            row = rows[parts][layout] = {
                "devices": [str(d) for d in mesh.devices],
                "partition_s": part_s, "h_max": sg.h_max,
                "halo_bytes": sg.halo_bytes_per_chip(16),
                "full_gather_bytes": full, "max_abs_err": err,
                "k1_vs_plain_max_abs_err": plain_err, "ms": ms,
                "unmasked_ms": unmasked_ms, "k1_launches": k1,
                "k1_by_card": by_card, "block_ms": block_ms,
                "block_device_ms": block_device_ms,
                "block_bound_ms": block_bound,
                "block": f"{indptr.numel() - 1} x {x.shape[0]} rows, "
                         f"{indices.numel()} edges, on {x.device}"}
            print(f"sharded forward P={parts} on {layout} "
                  f"({', '.join(row['devices'])}), n={g.n}, n_loc={n_loc}: "
                  f"partition {part_s:.3f} s, h_max {sg.h_max}, halo "
                  f"{row['halo_bytes']} bytes per shard per layer (full "
                  f"gather {full}); every shard's K1 output on its shard's "
                  f"card, bitwise equal to its rows of the single-device K1's "
                  f"(2 graph layers), to the CPU plain version on its block, "
                  f"and within {plain_err:.3g} of the plain version on the "
                  f"card (rtol 1e-5, atol 1e-5); scores within {err:.3g} of "
                  f"the single-device forward; {k1} K1 launches {by_card}; "
                  f"{ms:.4f} ms per sharded forward ({unmasked_ms:.4f} ms "
                  f"unmasked) vs {single_ms:.4f} ms on one device (host "
                  f"clock between synchronises of every card); K1 on shard "
                  f"{shard}'s block ({row['block']}, masked) {block_ms:.4f} "
                  f"ms eager, {block_device_ms:.4f} ms on the device, HBM "
                  f"bound {block_bound:.4f} ms")
            del sg, bufs
    return {"single_ms": single_ms, "by_parts": rows,
            "k1_launches": rows[counts[-1]][layout]["k1_launches"]}


def phase_sharded_solve(torch, g, layouts, parts=SHARD_COUNTS[-1]):
    """10b / 14b: solve() at time_limit=0 through ShardedGnnScorer over
    ``parts`` shards of each layout, beside the single-device phase-1 solve; returns
    the launch counts of the last layout's solve and its K1 launches by
    card."""
    from gnn_mwvc_tpu_torch.graphio import cover_cost, is_vertex_cover
    from gnn_mwvc_tpu_torch.ops import _build
    from gnn_mwvc_tpu_torch.parallel import make_mesh
    from gnn_mwvc_tpu_torch.solver.pipeline import solve
    from gnn_mwvc_tpu_torch.solver.sharded_score import ShardedGnnScorer

    runs = {}
    for layout, place in layouts.items():
        mesh = make_mesh(parts, devices=place(parts))
        scorer = ShardedGnnScorer(mesh=mesh)
        _build.launches.clear()
        res, by_card = k1_by_card(lambda: solve(
            g, time_limit=0, scorer=scorer, device="cuda:0",
            device_assist=False))
        launches = dict(_build.launches)
        if not is_vertex_cover(g, res.solution) or \
                cover_cost(g, res.solution) != res.cost:
            fail(f"sharded solve ({layout}): the cover is invalid")
        check_open_edges(res.phase1, f"sharded solve ({layout})")
        mesh_rounds = scorer.stats["rounds"]
        k1 = launches.get("csr_aggregate", 0)
        if mesh_rounds < 1 or k1 < 2 * parts * mesh_rounds:
            fail(f"sharded solve ({layout}): K1 launched {k1} times over "
                 f"{mesh_rounds} mesh rounds")
        check_every_card(by_card, "csr_aggregate", mesh.devices,
                         2 * mesh_rounds, f"sharded solve ({layout})")
        runs[layout] = (res, mesh_rounds, launches, by_card, scorer.stats)
    one = solve(g, time_limit=0, device="cuda:0", device_assist=False)
    q1 = one.phase1
    for layout, (res, mesh_rounds, launches, by_card, stats) in runs.items():
        p1 = res.phase1
        print(f"sharded solve P={parts} on {layout}, time_limit=0: valid "
              f"cover of cost {res.cost} in {res.time_gnn:.3f} s (reduce "
              f"{p1['t_reduce0_s']:.3f}, score {p1['t_score_s']:.3f}, peel "
              f"{p1['t_peel_s']:.3f}), {p1['rounds']} rounds ({mesh_rounds} "
              f"on the mesh), {open_edges(p1)}; single-device phase 1: cost "
              f"{one.cost} ({open_edges(q1)}) in "
              f"{one.time_gnn:.3f} s (score {q1['t_score_s']:.3f}), "
              f"{q1['rounds']} rounds; difference {res.cost - one.cost}; "
              f"launches {launches}, K1 by card {by_card}; scorer "
              f"{json.dumps(stats)}")
    return launches, by_card


def phase_sharded_train(torch, g, rng, place, parts=SHARD_COUNTS[-1]):
    """10c / 14c: 2 sharded train steps of ``parts`` shards on
    ``place(parts)`` with the labels of ``parallel.dryrun dist``
    (``train_labels``); the first step's gradients against the
    single-device full-batch MSE's.  Returns the launch counts of the first
    step, its K1 launches by card and its loss."""
    import numpy as np

    import gnn_mwvc_tpu_torch.parallel.sharded as sharded_mod
    from gnn_mwvc_tpu_torch.graph import DeviceGraph
    from gnn_mwvc_tpu_torch.models import pretrained_model
    from gnn_mwvc_tpu_torch.ops import _build
    from gnn_mwvc_tpu_torch.ops.aggregate import (csr_aggregate,
                                                  csr_aggregate_plain)
    from gnn_mwvc_tpu_torch.parallel import (make_mesh, make_sharded_train_step,
                                             mesh_seconds_per_call,
                                             partition_device_graph,
                                             synchronize)
    from gnn_mwvc_tpu_torch.parallel.dryrun import train_labels

    ws = float(g.weights.max())
    dg = DeviceGraph.from_graph(g, "cuda:0")
    mesh = make_mesh(parts, devices=place(parts))
    sg = partition_device_graph(dg, parts, devices=mesh)
    y = train_labels(sg)
    ref = pretrained_model("cuda:0")
    out = ref((dg.weights / ws).reshape(-1, 1), dg, ws)[:, 0]
    labels = torch.from_numpy(y.reshape(-1)[:g.n]).cuda()
    ((out - labels) ** 2).mean().backward()
    del out, labels
    model = pretrained_model("cuda:0")
    step, _opt = make_sharded_train_step(model, mesh)
    _build.launches.clear()
    (loss1, _outs, calls), by_card = k1_by_card(
        lambda: recorded(sharded_mod, lambda: step(sg, y, ws)))
    synchronize(mesh.devices)
    launches = dict(_build.launches)
    # K1's backward on one inner shard's transposed block (the first call
    # whose input needs a gradient: graph layer 2's), against the plain
    # version's autograd on the same inputs
    shard = min(1, parts - 1)
    args, kw = next(c for i, c in enumerate(calls)
                    if i % parts == shard and c[1]["transposed"] is not None)
    x = args[0].detach()
    up = torch.from_numpy(rng.standard_normal(
        (args[1].numel() - 1, x.shape[1])).astype(np.float32)).to(x.device)
    grads = []
    for fn in (lambda v: csr_aggregate(v, *args[1:4], **kw),
               lambda v: csr_aggregate_plain(v, *args[1:4])):
        v = x.clone().requires_grad_()
        grads.append(torch.autograd.grad(fn(v), v, up)[0])
    back_err = float((grads[0] - grads[1]).abs().max())
    if not torch.allclose(grads[0], grads[1], rtol=1e-5, atol=1e-5):
        fail(f"sharded train step: K1 backward on the transposed block differs "
             f"from the plain version's autograd by {back_err}")
    v = x.cpu().requires_grad_()
    (want,) = torch.autograd.grad(
        csr_aggregate(v, *(t.cpu() for t in args[1:3]), block=True,
                      transposed=tuple(t.cpu() for t in kw["transposed"])),
        v, up.cpu())
    if not torch.equal(grads[0].cpu(), want):
        fail("sharded train step: K1 backward on the transposed block not "
             "bitwise equal to the CPU plain version (max |diff| "
             f"{float((grads[0].cpu() - want).abs().max())})")
    block = (f"{x.shape[0]} rows over {args[1].numel() - 1}, "
             f"{args[2].numel()} edges, w={x.shape[1]}, on {x.device}")
    del x, up, grads, v, want, calls, _outs
    worst = 0.0
    for (name, p), q in zip(model.named_parameters(), ref.parameters()):
        scale = float(q.grad.abs().max())
        rel = float((p.grad - q.grad).abs().max()) / scale if scale else 1.0
        if not bool(torch.isfinite(p.grad).all()) or rel > 1e-4:
            fail(f"sharded train step: gradient {name} differs by {rel:.3g} of "
                 "its largest entry from the single-device MSE's")
        worst = max(worst, rel)
    back = launches.get("csr_aggregate_backward", 0)
    if back != 2 * parts:   # graph layers 2 and 3 on every shard
        fail(f"sharded train step: K1 backward launched {back} times, want "
             f"{2 * parts}")
    check_every_card(by_card, "csr_aggregate_backward", mesh.devices,
                     2 * parts // len(set(mesh.devices)),
                     "sharded train step")
    loss2 = step(sg, y, ws)
    if not (np.isfinite(loss1) and np.isfinite(loss2) and loss2 < loss1):
        fail(f"sharded train step: losses {loss1}, {loss2}")
    ms = mesh_seconds_per_call(lambda: step(sg, y, ws), mesh.devices, 3) * 1e3
    print(f"sharded train step P={parts} on "
          f"{', '.join(str(d) for d in mesh.devices)}, n={g.n}: losses "
          f"{loss1:.6f}, "
          f"{loss2:.6f}; first-step gradients within {worst:.3g} of each "
          f"tensor's largest entry of the single-device MSE's (limit 1e-4); "
          f"K1 backward on shard {shard}'s transposed block "
          f"({block}) within {back_err:.3g} of the plain version's autograd "
          f"on the card (rtol 1e-5, atol 1e-5) and bitwise equal to the CPU "
          f"plain version; launches per step {launches}, K1 by card "
          f"{by_card}; {ms:.4f} ms per step (host clock between "
          "synchronises of every card)")
    return launches, by_card, loss1


def phase_sharded_dist(torch, k=1, backend="gloo", world=2,
                       rank_device=lambda rank: "cuda:0", side=None,
                       want_loss=None):
    """A process-group world of ``parallel.dryrun dist`` ranks of k shards
    each on road``side`` (default ``DIST_SIDE``), rank r's shards on
    ``rank_device(r)`` (one device or a comma list of k).  10d (k = 1) and
    10f (k = 2): two gloo ranks on cuda:0, for k > 1 the train step's loss
    held against a local mesh of 2k shards of cuda:0; 14d and 14e: NCCL
    ranks on cards of their own, the loss held against ``want_loss`` (the
    local mesh's of phase 14c)."""
    import socket

    side = side or DIST_SIDE
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    init = f"tcp://127.0.0.1:{sock.getsockname()[1]}"
    sock.close()
    what = f"{backend} world of {world} ranks x {k} shards"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "gnn_mwvc_tpu_torch.parallel.dryrun", "dist",
         str(rank), str(world), init, "--backend", backend, "--device",
         rank_device(rank), "--road", str(side), "--shards-per-rank", str(k)],
        cwd=HERE, env=dict(os.environ, PYTHONPATH=HERE), text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for rank in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=DIST_TIMEOUT))
    except subprocess.TimeoutExpired:
        fail(f"{what}: a rank did not finish in {DIST_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            fail(f"{what}: rank {rank} exit {p.returncode}\n{out[-2000:]}\n"
                 f"{err[-3000:]}")
        r = json.loads(out.strip().splitlines()[-1])
        cards = sorted(set(r["devices"]))
        if not r["ok"] or r["max_abs_err"] > 1e-5 or \
                r["launches"].get("csr_aggregate", 0) < 2 * k or \
                r["shard_ids"] != list(range(rank * k, rank * k + k)) or \
                r["devices"] != rank_device(rank).split(",") * (
                    k // len(rank_device(rank).split(","))) or \
                r["cuda_devices_used"] != cards:
            fail(f"{what}: rank {rank}: {r}")
        results.append(r)
    if any(r["loss"] != results[0]["loss"] for r in results):
        fail(f"{what}: the ranks' losses differ: {results}")
    local = want_loss
    if local is None and k > 1:
        from gnn_mwvc_tpu_torch.graph import DeviceGraph, build_road_graph
        from gnn_mwvc_tpu_torch.models import pretrained_model
        from gnn_mwvc_tpu_torch.parallel import (make_mesh,
                                                 make_sharded_train_step,
                                                 partition_device_graph)
        from gnn_mwvc_tpu_torch.parallel.dryrun import train_labels

        g = build_road_graph(side)
        mesh = make_mesh(world * k, devices=one_card(world * k))
        sg = partition_device_graph(DeviceGraph.from_graph(g, "cuda:0"),
                                    world * k, devices=mesh)
        step, _opt = make_sharded_train_step(pretrained_model("cuda:0"), mesh)
        local = step(sg, train_labels(sg), float(g.weights.max()))
    if local is not None and \
            abs(local - results[0]["loss"]) > 1e-5 * abs(local):
        fail(f"{what}: loss {results[0]['loss']} against the local mesh's "
             f"{local}")
    for r in results:
        print(f"{backend} rank {r['rank']} of {world}, shards "
              f"{r['shard_ids']} on {', '.join(r['devices'])} "
              f"({r['transport']}), road{side} n={r['n']}, n_loc "
              f"{r['n_loc']}, h_max {r['h_max']}, halo "
              f"{r['halo_bytes_per_shard']} B per shard per layer: exit 0, "
              f"within {r['max_abs_err']:.3g} of the single-device forward; "
              f"{r['forward_ms']:.4f} ms per forward (host clock "
              f"between synchronises of the rank's cards); train step loss "
              f"{r['loss']:.6f}" + ("" if local is None else
                                    f" (local {world * k}-shard mesh "
                                    f"{local:.6f})")
              + f"; launches {r['launches']}; CUDA devices allocated on "
              f"{r['cuda_devices_used']}")
    return results


def phase_shards_cli(seed):
    """10e: gnn-vc-torch --shards 1 on the road-like side-300 instance."""
    import tempfile

    from gnn_mwvc_tpu_torch.graph import build_road_graph
    from gnn_mwvc_tpu_torch.graphio import (cover_cost, is_vertex_cover,
                                            read_solution, write_metis)

    g = build_road_graph(SURFACE_SIDE, seed=seed)
    with tempfile.TemporaryDirectory(prefix="mwvc_shards_") as tmp:
        path = os.path.join(tmp, f"road{SURFACE_SIDE}.metis")
        sol = os.path.join(tmp, f"road{SURFACE_SIDE}.sol")
        write_metis(path, g)
        run_surface("gnn-vc-torch --shards 1", "gnn_mwvc_tpu_torch.solver.cli",
                    [path, sol, SURFACE_TIME, "-1", "0", "--shards", "1"],
                    need=("csr_aggregate", "small_mwvc_mitm"))
        cover = read_solution(sol)
    if not is_vertex_cover(g, cover):
        fail("gnn-vc-torch --shards 1: the written cover is invalid")
    print(f"gnn-vc-torch --shards 1: valid cover of cost {cover_cost(g, cover)}")
    return SURFACE_LAUNCHES["gnn-vc-torch --shards 1"]


def phase_sharded(torch, g, seed):
    """Phase 10; returns the launch counts of its paths."""
    import numpy as np

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 10)
    fwd = phase_sharded_forward(torch, g, rng, {"cuda:0": one_card})
    torch.cuda.empty_cache()
    solve_launches, _ = phase_sharded_solve(torch, g, {"cuda:0": one_card})
    torch.cuda.empty_cache()
    train_launches, _, _ = phase_sharded_train(torch, g, rng, one_card)
    torch.cuda.empty_cache()
    dist = phase_sharded_dist(torch)
    dist2 = phase_sharded_dist(torch, k=2)
    cli = phase_shards_cli(seed)
    print("phase 10 keeps every shard on cuda:0 and its ranks on gloo; NCCL "
          "and copies between cards are phase 14's")
    print(f"phase 10: {time.perf_counter() - t0:.3f} s")
    return {"sharded_forward": {"csr_aggregate": fwd["k1_launches"]},
            "sharded_solve": solve_launches,
            "sharded_train_step": train_launches,
            "gloo_forward": {"csr_aggregate": sum(
                r["launches"].get("csr_aggregate", 0) for r in dist)},
            "gloo_2x2_forward": {"csr_aggregate": sum(
                r["launches"].get("csr_aggregate", 0) for r in dist2)},
            "shards_1_cli": cli}


TOOLS_AB_TIME = 10.0        # phase 11b's budget per A/B variant, seconds
TOOLS_CANONICAL = "road300"  # phase 11c's instance (90,000 nodes)
TOOLS_CANONICAL_TIME = 5.0
TOOLS_ER_N = 200_000        # phase 11e's ER graph: n at degree 16
TOOLS_SCALE_N = 50_000      # phase 11f's random graph for scale_bench
TOOLS_SCALE_SIDE = 200      # phase 11f's road-like graph for scaling_weak
TOOLS_REDUCE_SIDE = 450     # phase 11g's road-like graph (202,500 nodes)


def json_lines(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def phase_tools(side):
    """Phase 11: every port tool as a subprocess on the card.  Returns the
    launch counts of each run, by tool."""
    import tempfile

    t0 = time.perf_counter()
    k1, k4 = "csr_aggregate", "small_mwvc_mitm"
    mod = "gnn_mwvc_tpu_torch.tools."
    with tempfile.TemporaryDirectory(prefix="mwvc_tools_") as tmp:
        def out(name):
            return ["--out", os.path.join(tmp, name)]

        # (a) the phase-1 kernel of the full road-like graph
        npz = os.path.join(tmp, f"kernel_road{side}.npz")
        (dump,) = json_lines(run_surface(
            "dump_kernel", mod + "dump_kernel", [f"road{side}", "--out", npz],
            need=(k1,)))
        print(f"dump_kernel road{side}: kernel n={dump['n']} m={dump['m']} "
              f"initial_cost={dump['initial_cost']} cover cost "
              f"{dump['cover_cost']}, gnn_peel {dump['t_gnn_peel']:.3f} s "
              f"({json.dumps(dump['phase1'])}), t_phase1 {dump['t_phase1']:.3f} s")

        # (b) the four phase-2 variants at equal budget from that kernel
        rows = json_lines(run_surface(
            "assist_ab", mod + "assist_ab",
            [npz, "--time", TOOLS_AB_TIME, "--seeds", "1", *out("ab.json")],
            need=(k4,)))
        if [r["variant"] for r in rows] != ["plain", "guided", "regions",
                                             "full"]:
            fail(f"assist_ab: rows {rows}")
        for r in rows:
            n_k4 = r["launches"].get(k4, 0)
            region = r["variant"] in ("regions", "full")
            if (n_k4 > 0) != region or r["total_with_init"] > dump["cover_cost"]:
                fail(f"assist_ab {r['variant']}: K4 launched {n_k4} times, "
                     f"total {r['total_with_init']}: {r}")
            st = r["assist"] or {}
            print(f"assist_ab {r['variant']} ({TOOLS_AB_TIME:g} s, seed 1): "
                  f"total_with_init {r['total_with_init']}, best_seen "
                  f"{r['best_seen'] + dump['initial_cost']}, steps "
                  f"{r['steps']}, kicks {r['kicks']}, t_best {r['t_best']}; "
                  f"K4 launches {n_k4}, batches {st.get('batches')}, patches "
                  f"{st.get('patches')}, gain {st.get('gain')}, t_host_s "
                  f"{st.get('t_host_s')}, t_device_s {st.get('t_device_s')}")

        # (c)-(g) share one process
        texts = run_surfaces([
            ("canonical", mod + "canonical",
             [TOOLS_CANONICAL, "--time", TOOLS_CANONICAL_TIME,
              *out("canonical.json")], (k1, k4)),
            # --device cuda:0: all P shards on the one card, which the tools'
            # default (one shard per card) would refuse or skip there
            ("sharded_solve", mod + "sharded_solve",
             [TOOLS_CANONICAL, "--parts", 4, "--device", "cuda:0",
              *out("sharded.json")], (k1,)),
            ("er_slice_bench", mod + "er_slice_bench",
             ["--n", TOOLS_ER_N, "--deg", 16, "--parts", "1,4",
              *out("er.json")], (k1,)),
            ("scale_bench", mod + "scale_bench",
             ["--n", TOOLS_SCALE_N, "--deg", 12, "--parts", "1,2,4",
              "--device", "cuda:0"], (k1,)),
            ("scaling_weak", mod + "scaling_weak",
             ["--side", TOOLS_SCALE_SIDE, "--er-n", TOOLS_SCALE_N,
              "--parts", "1,2,4", "--device", "cuda:0", *out("weak.json")],
             (k1,)),
            ("reduce_scale", mod + "reduce_scale",
             ["--side", TOOLS_REDUCE_SIDE, *out("reduce.json")], ()),
        ])

        # (c) the canonical protocol, cut to a few seconds
        text = texts["canonical"]
        csv = [ln for ln in text.splitlines()
               if ln.startswith(TOOLS_CANONICAL + ",")]
        rec = json_lines(text)[-1]
        if not csv or csv[-1].split(",")[1] != str(rec["written"]):
            fail(f"canonical: no CSV line for record {rec}")
        print(f"canonical: {csv[-1]} (t_gnn {rec['t_gnn']} s, assist "
              f"batches {(rec['assist'] or {}).get('batches')})")

        # (d) the sharded scorer's cover against one device's
        (rec,) = json_lines(texts["sharded_solve"])
        if not rec["identical_covers"] or rec["cost_mesh"] != rec["cost_single"]:
            fail(f"sharded_solve: {rec}")
        print(f"sharded_solve {TOOLS_CANONICAL} P=4: identical covers, cost "
              f"{rec['cost_mesh']}; phase 1 {rec['t_phase1_mesh_s']} s sharded "
              f"vs {rec['t_phase1_single_s']} s single; h_max {rec['h_max']}, "
              f"{rec['halo_bytes_per_shard_per_layer']} B per shard per layer")

        # (e) K1 and the forward on ER slices: a graph without locality
        er = json_lines(texts["er_slice_bench"])
        for r in er:
            if r["k1_max_abs_err"] > 1e-4:
                fail(f"er_slice_bench: K1 differs from its plain version: {r}")
            print(f"er_slice_bench P={r['parts']} (n={r['n_slice']}, "
                  f"e={r['e_slice']}): forward {r['t_iter_ms']:.4f} ms; K1 "
                  f"masked {r['k1_device_ms']:.4f} ms on the device (bound "
                  f"{r['k1_bound_ms']:.4f} ms, {r['k1_bound_frac']:.1%}), "
                  f"unmasked {r['k1_unmasked_device_ms']:.4f} ms (bound "
                  f"{r['k1_unmasked_bound_ms']:.4f}), torch.sparse.mm "
                  f"{r['sparse_mm_device_ms']:.4f} ms; K1 max |diff| "
                  f"{r['k1_max_abs_err']:.3g}")

        # (f) the sharded forward over P shards of the card
        scale = json.loads(texts["scale_bench"].strip().splitlines()[-1])
        weak = json_lines(texts["scaling_weak"])[-1]
        errs = [r["max_abs_err_vs_single"] for r in scale] + [
            c["max_err_vs_single"] for v in weak.values() for c in v["configs"]]
        if max(errs) > 1e-5:
            fail(f"scale_bench / scaling_weak: error {max(errs)} vs one device")
        print("scale_bench: " + "; ".join(
            f"P={r['parts']} {r['ms']:.4f} ms, h_max {r['h_max']}, partition "
            f"{r['t_partition_s']:.3f} s" for r in scale)
            + f"; scaling_weak: max error vs one device {max(errs):.3g}")

        # (g) the host reduce against the device prepass
        text = texts["reduce_scale"]
        winner = json_lines(text)[-1]
        sides = {ln.split(":")[0]: json.loads(ln.split(":", 1)[1])
                 for ln in text.splitlines()
                 if ln.startswith(("host:", "device:"))}
        print(f"reduce_scale side {TOOLS_REDUCE_SIDE}: host kernel "
              f"{sides['host']['kernel']} in {sides['host']['t_reduce']} s; "
              f"device prepass {sides['device']['t_prepass']} s + "
              f"{sides['device']['t_reduce']} s, kernel "
              f"{sides['device']['kernel']}; winner {winner['winner']}")
    print(f"phase 11: {time.perf_counter() - t0:.3f} s")
    names = ("dump_kernel", "assist_ab", "canonical", "sharded_solve",
             "er_slice_bench", "scale_bench", "scaling_weak", "reduce_scale")
    return {name: SURFACE_LAUNCHES[name] for name in names}


STUDY_EPOCHS = 2            # phase 12b's training epochs
STUDY_BUDGET = 0.5          # phase 12b's label and evaluation budgets, s
STUDY_ITERS = 5             # phase 12a's timed forwards per batch (2 batches)
STUDY_BURSTS = 2            # phase 12c's bursts of 5 calls

# phase 12b: train_quality on 4 of its corpus graphs and 2 held-out ones
TRAIN_QUALITY_CUT = (
    "import sys\n"
    "from gnn_mwvc_tpu_torch.tools import train_quality as tq\n"
    "corpus, heldout = tq.corpus, tq.heldout\n"
    "tq.corpus = lambda rng=None: [c for c in corpus(rng)\n"
    "                              if c[0] in ('er0', 'pl0', 'grid0', 'grid1')]\n"
    "tq.heldout = lambda: [h for h in heldout() if h[0] in ('er12k', 'grid110')]\n"
    "sys.exit(tq.main(sys.argv[1:]))\n")


def phase_study_tools(side):
    """Phase 12: precision_study (road side, as the bench scores it),
    train_quality on a cut-down corpus, and smallsolve_bench, which holds
    K4 against its plain version before timing it; one subprocess on the
    card, each tool's launches counted from 0."""
    import tempfile

    t0 = time.perf_counter()
    k1, k4 = "csr_aggregate", "small_mwvc_mitm"
    mod = "gnn_mwvc_tpu_torch.tools."
    with tempfile.TemporaryDirectory(prefix="mwvc_study_") as tmp:
        script = os.path.join(tmp, "train_quality_cut.py")
        with open(script, "w") as f:
            f.write(TRAIN_QUALITY_CUT)

        def out(name):
            return ["--out", os.path.join(tmp, name)]

        texts = run_surfaces([
            ("precision_study", mod + "precision_study",
             ["--side", side, "--iters", STUDY_ITERS, "--batches", 2,
              *out("precision.json")], (k1,)),
            ("train_quality", script,
             ["--epochs", STUDY_EPOCHS, "--label-budget", STUDY_BUDGET,
              "--eval-budget", STUDY_BUDGET, "--workdir",
              os.path.join(tmp, "tq"), *out("tq.json")], (k1,)),
            ("smallsolve_bench", mod + "smallsolve_bench",
             ["--bursts", STUDY_BURSTS, *out("smallsolve.json")], (k4,)),
        ])
        with open(os.path.join(tmp, "tq.json")) as f:
            tq = json.load(f)
    rep = json_lines(texts["precision_study"])[-1]
    for tag in ("highest", "mixed", "default"):
        r = rep[tag]
        print(f"precision_study road{side} {tag} ({r['what']}): "
              f"{r['ms_per_forward']:.4f} ms per forward, {r['edges_per_s']:,} "
              f"edges/s; vs the CPU fp32 forward max |err| "
              f"{r['max_abs_err']:.3g}, mean {r['mean_abs_err']:.3g}, share "
              f"over 2e-5 {r['frac_gt_2e-5']:.4g}")
    if rep["highest"]["max_abs_err"] > 2e-5 or \
            rep["mixed"]["max_abs_err"] > 2e-5:
        fail(f"precision_study: the fp32 forward differs from the CPU's by "
             f"{rep['highest']['max_abs_err']}")
    if len(tq["rows"]) != 2 or tq["samples"] < 2:
        fail(f"train_quality: {tq}")
    for r in tq["rows"]:
        print(f"train_quality (cut: corpus {tq['samples']} graphs, "
              f"{tq['epochs']} epochs, {STUDY_BUDGET:g} s budgets) {r['name']} "
              f"n={r['n']}: phase 1 published {r['published']['phase1']} / "
              f"trained {r['trained']['phase1']} ({r['delta_phase1_pct']:+.4f}"
              f"%), final {r['published']['final']} / {r['trained']['final']} "
              f"({r['delta_final_pct']:+.4f}%)")
    print(f"train_quality: corpus {tq['t_corpus_s']:.3f} s, training "
          f"{tq['t_train_s']:.3f} s")
    sb = json_lines(texts["smallsolve_bench"])[-1]
    print(f"smallsolve_bench B={sb['batch']}: {sb['parity_n16']} (n=16), "
          f"{sb['parity_n20']} (n=20); n=16 K4 {sb['k4_n16_ms']:.4f} ms "
          f"({sb['k4_16_regions_per_s']:,.0f} regions/s), enumeration "
          f"{sb['enum_n16_ms']:.4f} ms ({sb['enum_regions_per_s']:,.0f} "
          f"regions/s, K4 {sb['speedup_n16']:.1f}x); n=20 K4 "
          f"{sb['k4_n20_ms']:.4f} ms ({sb['k4_20_regions_per_s']:,.0f} "
          "regions/s); eager calls between CUDA events")
    print(f"phase 12: {time.perf_counter() - t0:.3f} s")
    return {name: SURFACE_LAUNCHES[name] for name in
            ("precision_study", "train_quality", "smallsolve_bench")}


LAST_DUMP_SIDE = 300        # phase 13e's kernel_dump instance (cut from road900)
LAST_LS_TIME = 10.0         # phase 13e's ls_run budget, seconds (perturb)


class TimedSnapshotScorer:
    """Phase 13d: the sticky scorer's per-snapshot scorer on the card, which
    also runs the native CPU forward on each snapshot; it returns the
    card's scores, so the peel is the card's.  ``rows``: per round
    (nodes, directed edges, card s, native s, max |diff|)."""

    def __init__(self, card_scorer):
        self.card = card_scorer
        self.device = card_scorer.device
        self.rows = []

    def score_core(self, core, weight_scale):
        snap = core.snapshot()
        return snap.ids, self(snap, weight_scale), snap.weights, snap.deg

    def __call__(self, snap, weight_scale):
        import torch

        from gnn_mwvc_tpu_torch.core import cpu_forward_native

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prob = self.card(snap, weight_scale)
        t1 = time.perf_counter()
        native = cpu_forward_native(snap, self.card.model, weight_scale)
        t2 = time.perf_counter()
        diff = float(abs(prob - native).max()) if snap.n else 0.0
        self.rows.append((int(snap.n), int(snap.indptr[-1]), t1 - t0,
                          t2 - t1, diff))
        return prob


def phase_last_surfaces(torch, g):
    """Phase 13: the bench line, entry(), the native relabel, the card's
    per-snapshot rounds beside the native CPU forward, and the kernel-dump
    / local-search tools.  Returns the launch counts by entry point."""
    import tempfile

    import numpy as np

    from gnn_mwvc_tpu_torch import entry as port_entry
    from gnn_mwvc_tpu_torch.core import cluster_order
    from gnn_mwvc_tpu_torch.graph import DeviceGraph, reorder_plain
    from gnn_mwvc_tpu_torch.graphio import cover_cost, is_vertex_cover
    from gnn_mwvc_tpu_torch.models import pretrained_model
    from gnn_mwvc_tpu_torch.ops import _build
    from gnn_mwvc_tpu_torch.parallel.dryrun import synthetic_graph
    from gnn_mwvc_tpu_torch.solver.pipeline import GnnScorer, solve
    from gnn_mwvc_tpu_torch.solver.static_score import StickyGnnScorer

    t_phase = time.perf_counter()
    k1 = "csr_aggregate"
    mod = "gnn_mwvc_tpu_torch."
    counts = {}
    # (a) bench and (e) kernel_dump + ls_run, one subprocess
    with tempfile.TemporaryDirectory(prefix="mwvc_last_") as tmp:
        stem = os.path.join(tmp, f"k_road{LAST_DUMP_SIDE}")
        texts = run_surfaces([
            ("bench", mod + "bench", [], (k1,)),
            ("kernel_dump", mod + "tools.kernel_dump",
             ["--instance", f"road{LAST_DUMP_SIDE}", "--out", stem], (k1,)),
            ("ls_run", mod + "tools.ls_run",
             [stem + ".kern", "--time", LAST_LS_TIME, "--variant", "perturb"],
             ()),
        ])
    lines = texts["bench"].strip().splitlines()
    rec = json.loads(lines[-1]) if lines else {}
    if len(lines) != 1 or list(rec) != ["metric", "value", "unit",
                                        "vs_baseline"] \
            or rec["metric"] != "gnn_score_edges_per_s" or rec["value"] <= 0:
        fail(f"bench: want one JSON line with the bench keys: {lines}")
    print(f"bench (road1200 cluster_order, unmasked forward, highest, best of "
          f"4 x 5 chained calls): {rec['value']:,} edges/s, vs_baseline "
          f"{rec['vs_baseline']}; K1 launches "
          f"{SURFACE_LAUNCHES['bench'].get(k1)}")
    (dump,) = json_lines(texts["kernel_dump"])
    ls = [ln.split(",") for ln in texts["ls_run"].strip().splitlines()]
    init, final = ls[0], ls[-1]
    if init[0] != "init" or final[0] != "final" or \
            int(final[3]) > int(init[3]) or int(final[1]) < 1:
        fail(f"ls_run: init {init}, final {final}, dump {dump}")
    print(f"kernel_dump road{LAST_DUMP_SIDE}: kernel n={dump['n']} "
          f"m={dump['m']}, initial_cost {dump['initial_cost']}, cost after "
          f"the peel {dump['cost_after_peel']}, phase 1 {dump['t_phase1']:.3f}"
          f" s in {dump['rounds']} rounds; ls_run perturb {LAST_LS_TIME:g} s: "
          f"{final[1]} steps, best {final[3]} (from {init[3]}), best_seen "
          f"{final[4]}, {final[5]} steps/s, "
          f"{sum(r[0] == 'div' for r in ls)} kicks")

    # (b) entry() on the card against the plain forward on CPU copies
    fn, (model, dg, ws) = port_entry.entry("cuda:0")
    _build.launches.clear()
    out = fn(model, dg, ws)
    torch.cuda.synchronize()
    counts["entry"] = dict(_build.launches)
    g_cpu = synthetic_graph()
    plain = fn(pretrained_model("cpu"), DeviceGraph.from_graph(g_cpu, "cpu"),
               ws)
    err = float((out.cpu() - plain).abs().max())
    if counts["entry"].get(k1, 0) < 2 or err > 2e-5 or \
            not bool(torch.isfinite(out).all()):
        fail(f"entry: K1 launches {counts['entry']}, max |diff| {err}")
    print(f"entry (cuda:0, 4096 nodes, degree 16): max |diff| vs the plain "
          f"forward on CPU copies {err:.3g}; launches {counts['entry']}")

    # (c) the native relabel against the numpy one, road1200
    t0 = time.perf_counter()
    perm = cluster_order(g.indptr, g.indices)
    t1 = time.perf_counter()
    native = g.reorder(perm)
    t2 = time.perf_counter()
    plain_g = reorder_plain(g, perm)
    t3 = time.perf_counter()
    if not (np.array_equal(native.indptr, plain_g.indptr)
            and np.array_equal(native.indices, plain_g.indices)
            and np.array_equal(native.weights, plain_g.weights)):
        fail("reorder: the native relabel's CSR differs from the numpy one")
    print(f"reorder road{ROAD_SIDE} (n={g.n}, {len(g.indices)} directed "
          f"edges): cluster_order {t1 - t0:.3f} s, native relabel "
          f"{t2 - t1:.3f} s, numpy relabel {t3 - t2:.3f} s; CSRs equal")
    del native, plain_g

    # (d) each per-snapshot round of a road1200 phase 1: the card's
    # GnnScorer beside the native CPU forward on the same snapshot
    scorer = StickyGnnScorer(device="cuda")
    timed = TimedSnapshotScorer(GnnScorer(scorer.model, "cuda"))
    scorer._snapshot_scorer = timed
    _build.launches.clear()
    res = solve(g, time_limit=0, device="cuda", scorer=scorer,
                device_assist=False)
    counts["solve_split"] = dict(_build.launches)
    if not is_vertex_cover(g, res.solution) or \
            cover_cost(g, res.solution) != res.cost:
        fail("per-snapshot split: solve() wrote an invalid cover")
    check_open_edges(res.phase1, "per-snapshot split")
    rows = timed.rows
    if not rows or len(rows) != scorer.stats["legacy_rounds"]:
        fail(f"per-snapshot split: {len(rows)} rows for "
             f"{scorer.stats['legacy_rounds']} per-snapshot rounds")
    worst = max(r[4] for r in rows)
    if worst > 2e-5:
        fail(f"per-snapshot split: the card and the native forward differ "
             f"by {worst}")
    card_wins = [r[1] for r in rows if r[2] < r[3]]
    native_wins = [r[1] for r in rows if r[3] <= r[2]]
    for n, e, tc, tn, d in sorted(rows, key=lambda r: -r[1]):
        print(f"  snapshot n={n} e={e}: card GnnScorer {tc * 1e3:.3f} ms, "
              f"native CPU forward {tn * 1e3:.3f} ms, max |diff| {d:.3g}")
    print(f"per-snapshot rounds of road{ROAD_SIDE} phase 1 (time 0, cost "
          f"{res.cost}, {scorer.stats['rounds']} sticky + {len(rows)} per "
          f"snapshot; {open_edges(res.phase1)}): card "
          f"{sum(r[2] for r in rows):.3f} s, native "
          f"{sum(r[3] for r in rows):.3f} s in all ({os.cpu_count()} host "
          f"threads); max |diff| {worst:.3g}; the card is faster from "
          f"{min(card_wins) if card_wins else None} directed edges, the "
          f"native forward up to {max(native_wins) if native_wins else None}")
    print(f"phase 13: {time.perf_counter() - t_phase:.3f} s")
    return {"bench": SURFACE_LAUNCHES["bench"],
            "kernel_dump": SURFACE_LAUNCHES["kernel_dump"],
            "ls_run": SURFACE_LAUNCHES["ls_run"], **counts}


def phase_multi_card_tools(seed, parts):
    """14f: as subprocesses, each on cards of their own, launches counted
    from 0: gnn-vc-torch --shards P on road300 (K1 and K4), sharded_solve,
    scale_bench, scaling_weak with --device cuda (one shard per card) and
    entry multichip P.  Returns the launch counts of each run."""
    import tempfile

    from gnn_mwvc_tpu_torch.graph import build_road_graph
    from gnn_mwvc_tpu_torch.graphio import (cover_cost, is_vertex_cover,
                                            read_solution, write_metis)

    k1, k4 = "csr_aggregate", "small_mwvc_mitm"
    mod = "gnn_mwvc_tpu_torch.tools."
    scale_parts = [1] + [p for p in SHARD_COUNTS if p <= parts]
    plist = ",".join(map(str, scale_parts))
    cli = f"gnn-vc-torch --shards {parts}"
    names = {cli: cli, "sharded_solve": f"sharded_solve --parts {parts} "
             "--device cuda", "scale_bench": "scale_bench --device cuda",
             "scaling_weak": "scaling_weak --device cuda",
             "entry": f"entry multichip {parts}"}
    g = build_road_graph(SURFACE_SIDE, seed=seed)
    with tempfile.TemporaryDirectory(prefix="mwvc_multicard_") as tmp:
        path = os.path.join(tmp, f"road{SURFACE_SIDE}.metis")
        sol = os.path.join(tmp, f"road{SURFACE_SIDE}.sol")
        write_metis(path, g)
        texts = run_surfaces([
            (names[cli], "gnn_mwvc_tpu_torch.solver.cli",
             [path, sol, SURFACE_TIME, "-1", "0", "--shards", parts],
             (k1, k4)),
            (names["sharded_solve"], mod + "sharded_solve",
             [TOOLS_CANONICAL, "--parts", parts, "--device", "cuda", "--out",
              os.path.join(tmp, "sharded.json")], (k1,)),
            (names["scale_bench"], mod + "scale_bench",
             ["--n", TOOLS_SCALE_N, "--deg", 12, "--parts", plist,
              "--device", "cuda"], (k1,)),
            (names["scaling_weak"], mod + "scaling_weak",
             ["--side", TOOLS_SCALE_SIDE, "--er-n", TOOLS_SCALE_N, "--parts",
              plist, "--device", "cuda", "--out",
              os.path.join(tmp, "weak.json")], (k1,)),
            (names["entry"], "gnn_mwvc_tpu_torch.entry",
             ["multichip", parts], (k1,)),
        ])
        cover = read_solution(sol)
    if not is_vertex_cover(g, cover):
        fail(f"{cli}: the written cover is invalid")
    print(f"{cli} road{SURFACE_SIDE}: valid cover of cost "
          f"{cover_cost(g, cover)}")

    (rec,) = json_lines(texts[names["sharded_solve"]])
    if not rec["identical_covers"] or rec["cost_mesh"] != rec["cost_single"] \
            or rec["devices"] != per_card(parts):
        fail(f"{names['sharded_solve']}: {rec}")
    print(f"sharded_solve {TOOLS_CANONICAL} P={parts} on {rec['devices']}: "
          f"identical covers, cost {rec['cost_mesh']}; phase 1 "
          f"{rec['t_phase1_mesh_s']} s sharded vs {rec['t_phase1_single_s']} "
          f"s single; h_max {rec['h_max']}")

    scale = json.loads(texts[names["scale_bench"]].strip().splitlines()[-1])
    weak = json_lines(texts[names["scaling_weak"]])[-1]
    rows = [(f"scale_bench n={TOOLS_SCALE_N}", r["parts"], r["devices"],
             r["ms"], r["max_abs_err_vs_single"]) for r in scale]
    for name, v in weak.items():
        rows += [(f"scaling_weak {name}", c["parts"], c["devices"],
                  c["t_forward_s"] * 1e3, c["max_err_vs_single"])
                 for c in v["configs"]]
    for what, p, devices, _ms, err in rows:
        if devices != per_card(p) or err > 1e-5:
            fail(f"{what} P={p}: on {devices}, error {err} vs one device")
    if [r["parts"] for r in scale] != scale_parts or any(
            [c["parts"] for c in v["configs"]] != scale_parts
            for v in weak.values()):
        fail(f"scale_bench / scaling_weak: parts {scale}, {weak}")
    print("one shard per card: " + "; ".join(
        f"{what} P={p} {ms:.4f} ms (error {err:.3g})"
        for what, p, _d, ms, err in rows) + "; single-device forward: "
        + "; ".join(f"scaling_weak {name} {v['t_single_forward_s'] * 1e3:.4f}"
                    f" ms" for name, v in weak.items()))
    if f"dryrun_multichip({parts})" not in texts[names["entry"]]:
        fail(f"{names['entry']}: {texts[names['entry']][-500:]}")
    return {name: SURFACE_LAUNCHES[name] for name in names.values()}


def phase_multi_card(torch, g, side, seed):
    """Phase 14: the multi-device path with a card for each shard (P = 2
    and 4, up to the card count); returns the launch counts of its paths."""
    import numpy as np

    t0 = time.perf_counter()
    cards = torch.cuda.device_count()
    counts = [p for p in SHARD_COUNTS if p <= cards]
    parts = counts[-1]
    both = {"cuda:0": one_card, "a card per shard": per_card}
    rng = np.random.default_rng(seed + 14)
    # (a) the sharded forward, one card and a card per shard
    fwd = phase_sharded_forward(torch, g, rng, both, counts)
    torch.cuda.empty_cache()
    for p in counts:
        one, own = (fwd["by_parts"][p][k]["ms"] for k in both)
        print(f"sharded forward P={p}: {own:.4f} ms on {p} cards, {one:.4f} "
              f"ms on cuda:0, {fwd['single_ms']:.4f} ms single: speed-up "
              f"{fwd['single_ms'] / own:.3f} over one device, "
              f"{one / own:.3f} over {p} shards of one card")
    # (b) a sharded phase 1
    solve_launches, solve_by_card = phase_sharded_solve(torch, g, both, parts)
    torch.cuda.empty_cache()
    # (c) the train step
    train_launches, train_by_card, loss1 = phase_sharded_train(
        torch, g, rng, per_card, parts)
    torch.cuda.empty_cache()
    # (d) NCCL, a rank per card; (e) 2 ranks of 2 cards each
    nccl = phase_sharded_dist(torch, backend="nccl", world=parts,
                              rank_device=lambda r: f"cuda:{r}", side=side,
                              want_loss=loss1)
    by_path = {
        "sharded_forward": {"csr_aggregate": fwd["k1_launches"]},
        "sharded_forward_k1_by_card": fwd["by_parts"][parts][
            "a card per shard"]["k1_by_card"],
        "sharded_solve": solve_launches,
        "sharded_solve_k1_by_card": solve_by_card,
        "sharded_train_step": train_launches,
        "sharded_train_step_k1_by_card": train_by_card,
        f"nccl_{parts}x1_forward": {"csr_aggregate": sum(
            r["launches"].get("csr_aggregate", 0) for r in nccl)}}
    if parts == 4:
        nccl2 = phase_sharded_dist(
            torch, k=2, backend="nccl", world=2,
            rank_device=lambda r: f"cuda:{2 * r},cuda:{2 * r + 1}",
            side=side, want_loss=loss1)
        by_path["nccl_2x2_forward"] = {"csr_aggregate": sum(
            r["launches"].get("csr_aggregate", 0) for r in nccl2)}
    else:
        print(f"NCCL 2 ranks x 2 cards: not run: {cards} cards")
    own = fwd["by_parts"][parts]["a card per shard"]["unmasked_ms"]
    print(f"peer copies vs NCCL, P={parts}, the unmasked forward: "
          f"{own:.4f} ms in one process; NCCL ranks "
          + ", ".join(f"{r['forward_ms']:.4f}" for r in nccl) + " ms")
    # (f) the entry points and tools, one shard per card
    by_path.update(phase_multi_card_tools(seed, parts))
    print(f"phase 14: {time.perf_counter() - t0:.3f} s")
    return by_path


SCALE_ROAD = 1600           # phase 15's instance: 2,560,000 nodes
SCALE_TIME = 120.0          # phase 15's canonical budget, seconds
SCALE_SEED = 2              # the seed of the JAX package's road1600 record


def phase_scale():
    """Phase 15: the port's canonical tool on road1600 as a subprocess on the
    card, from a copy of the port that stands alone: the copy builds its
    core and its kernels from its own sources.  Returns its launch
    counts."""
    import re
    import shutil
    import tempfile

    t0 = time.perf_counter()
    k1, k4 = "csr_aggregate", "small_mwvc_mitm"
    road = f"road{SCALE_ROAD}"
    with tempfile.TemporaryDirectory(prefix="mwvc_scale_") as tmp:
        port = os.path.join(tmp, "gnn_mwvc_tpu_torch")
        shutil.copytree(os.path.join(HERE, "gnn_mwvc_tpu_torch"), port,
                        ignore=shutil.ignore_patterns("_build",
                                                      "__pycache__"))
        path = os.path.join(tmp, "canonical.json")
        text = run_surface(
            "scale", "gnn_mwvc_tpu_torch.tools.canonical",
            [road, "--time", SCALE_TIME, "--seed", SCALE_SEED, "--out", path],
            need=(k1, k4), timeout=900, root=tmp)
        with open(path) as f:
            saved = json.load(f)
        built = sorted(os.listdir(os.path.join(port, "_build")))
        for lib in ("libmwvc_core.so", "libgnn_mwvc_kernels.so"):
            if lib not in built:
                fail(f"scale: the copy built no {lib} (its _build/: {built})")
    lines = text.splitlines()
    rec = json_lines(text)[-1]
    csv = [ln for ln in lines if ln.startswith(road + ",")]
    want = f"{road},{rec['written']},{rec['best']},{rec['t_best']:.1f}"
    if saved != rec or not csv or csv[-1] != want:
        fail(f"scale: CSV line {csv[-1:]} or the saved record does not "
             f"match the record {rec}")
    size = re.search(r"^instance \S+: n=(\d+) m=(\d+)$", text, re.M)
    done = re.search(r"^GNN-VC done in \S+s, cost: (\d+)$", text, re.M)
    run = [json.loads(ln[len("run: "):]) for ln in lines
           if ln.startswith("run: ")]
    if not (size and done and run):
        fail(f"scale: no size, phase-1 or run line in\n{text[-2000:]}")
    n, m = int(size.group(1)), int(size.group(2))
    phase1_cost, run = int(done.group(1)), run[-1]
    sc, st = rec["scorer"], rec["assist"] or {}
    launches = SURFACE_LAUNCHES["scale"]
    n_k1, n_k4 = launches.get(k1, 0), launches.get(k4, 0)
    if n != SCALE_ROAD ** 2 or rec["written"] > phase1_cost:
        fail(f"scale: n={n}, written {rec['written']} over the phase-1 "
             f"cover's {phase1_cost}")
    if sc["rounds"] < 1 or n_k1 < 2 * sc["rounds"]:
        fail(f"scale: K1 launched {n_k1} times over {sc['rounds']} phase-1 "
             "rounds")
    if st.get("batches", 0) < 1 or n_k4 < st["batches"]:
        fail(f"scale: K4 launched {n_k4} times, assist {st}")
    check_open_edges(sc, "scale")
    t_p1 = rec["t_gnn"]
    parts = {k: sc.get(k, 0.0) for k in ("t_reduce0_s", "t_score_s",
                                         "t_peel_s")}
    parts["relabel_s"] = sc["spans"].get("relabel", {}).get("seconds", 0.0)
    phase2 = rec["wall"] - t_p1
    print(f"scale {road} (--time {SCALE_TIME:g} --seed {SCALE_SEED}): "
          f"n={n} m={m}, kernel {run['kernel_size']}; phase 1 {t_p1} s (relabel "
          f"{parts['relabel_s']:.3f}, reduce {parts['t_reduce0_s']:.3f}, "
          f"score {parts['t_score_s']:.3f}, peel {parts['t_peel_s']:.3f}, "
          f"rest {t_p1 - sum(parts.values()):.3f}), cost {phase1_cost}; "
          f"rounds {sc['rounds'] - sc['legacy_rounds']} sticky + "
          f"{sc['legacy_rounds']} per snapshot; {open_edges(sc)}")
    print(f"scale {road}: {csv[-1]}; ls_steps {rec['ls_steps']}; assist "
          f"batches {st['batches']}, patches {st['patches']}, gain "
          f"{st['gain']}, t_host_s {st['t_host_s']:.3f} "
          f"({st['t_host_s'] / phase2:.1%} of phase 2's {phase2:.1f} s), "
          f"t_device_s {st['t_device_s']:.3f}, wide_patches "
          f"{st['wide_patches']}; launches {launches}; peak card allocation "
          f"{run['peak_device_bytes']} B (torch.cuda.max_memory_allocated)")
    print(f"scale: run from a copy of the port alone ({built} built there "
          "from its core/src and csrc/)")
    print(f"phase 15: {time.perf_counter() - t0:.3f} s")
    return launches


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--time", type=float, default=100.0,
                    help="solve() time limit on the road-like graph")
    ap.add_argument("--side", type=int, default=ROAD_SIDE,
                    help="road-like graph side (side^2 nodes)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--multi-card", action="store_true",
                    help="phases 1, 2 and 14 alone (needs 2 or more cards)")
    args = ap.parse_args()
    t_start = time.perf_counter()

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
    from gnn_mwvc_tpu_torch.tools._common import HBM_BYTES_PER_S

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

    from gnn_mwvc_tpu_torch.graph import (DeviceGraph, build_road_graph,
                                          neighbour_weight_sum)

    cards = torch.cuda.device_count()
    if args.multi_card:
        if cards < 2:
            fail(f"--multi-card needs 2 or more CUDA cards, found {cards}")
        by_path = {"multi_card": phase_multi_card(
            torch, build_road_graph(args.side), args.side, args.seed)}
        print(f"smoke: phases 1, 2 and 14 in "
              f"{time.perf_counter() - t_start:.3f} s")
        print(json.dumps({"launches_by_path": by_path}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": cards}}))
        return 0

    rng = np.random.default_rng(args.seed)
    # 3. K4
    k4_err, enum_op = phase_k4(torch, rng, int_ops_per_s)

    # 4. K1 and 5. forward on the road-like graph
    t0 = time.perf_counter()
    g = build_road_graph(args.side)
    t1 = time.perf_counter()
    dg = DeviceGraph.from_graph(g, "cuda")
    t2 = time.perf_counter()
    neighbour_weight_sum(g.weights.astype(np.float32), g.row_ids(), g.indices)
    t_nw = time.perf_counter() - t2
    print(f"graph: road side {args.side}, n={g.n}, m={g.m}, "
          f"generated in {t1 - t0:.3f} s, DeviceGraph built in {t2 - t1:.3f} "
          f"s (of which its NW sum in CSR order, np.add.at, {t_nw:.3f} s)")
    k1 = phase_k1(torch, dg, rng)
    phase_forward(torch, g, dg, rng)
    k1_back = phase_backward(torch, dg, rng, args.seed)
    del dg
    torch.cuda.empty_cache()

    # 6. solve, then K4 on regions of its cover
    launches, cover = phase_solve(torch, g, args.time)
    k4_road = phase_regions(torch, g, cover, int_ops_per_s)
    del cover

    # 7. train
    train_launches = phase_train(torch, args.seed)

    # 8. the rule prepass on the full road-like graph
    if args.side != ROAD_SIDE:
        g = build_road_graph(ROAD_SIDE)
    device_ops = phase_prepass(torch, g, int_ops_per_s) + [enum_op]

    # 9. the remaining single-device surfaces
    phase_surfaces(args.seed, g)

    # 10. the multi-device path on the one card
    by_path = phase_sharded(torch, g, args.seed)
    torch.cuda.empty_cache()

    # 11. the port's tools
    by_path["tools"] = phase_tools(args.side)

    # 12. the precision, training-quality and small-solve studies
    by_path["study_tools"] = phase_study_tools(args.side)

    # 13. the bench line, entry(), the native relabel and forward, and the
    # kernel-dump / local-search tools
    by_path["last_surfaces"] = phase_last_surfaces(torch, g)

    # 14. the multi-device path with a card for each shard
    if cards >= 2:
        if args.side != ROAD_SIDE:
            g = build_road_graph(args.side)
        by_path["multi_card"] = phase_multi_card(torch, g, args.side,
                                                 args.seed)
    else:
        print(f"phase 14 (multi-card): not run: {cards} CUDA card, it needs "
              "2 or more")
    del g
    torch.cuda.empty_cache()

    # 15. the canonical protocol on road1600, the largest recorded instance
    by_path["scale"] = phase_scale()

    timing = ("ms, plain_ms, library_ms: eager calls between CUDA events; "
              "device_ms, library_device_ms: a CUDA graph of 20 calls")
    by_path = {"solve": launches, "train": train_launches, **by_path}
    print(f"smoke: phases 1-{14 if cards >= 2 else 13} and 15 in "
          f"{time.perf_counter() - t_start:.3f} s")
    print(json.dumps({"launches_by_path": by_path}))
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
    print(json.dumps({"device_ops": device_ops}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
