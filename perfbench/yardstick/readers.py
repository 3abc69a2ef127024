"""Arithmetic that several metric readers share.  Each returns None where
the run gave it nothing to read (no solve, no trace, no launch), so the
metric is left out of the line rather than read as 0."""

from __future__ import annotations

from perfbench.yardstick import trace as tr
from perfbench.yardstick.counts import (FP32_FLOPS_PER_S, HBM_BYTES_PER_S,
                                        SEA2022_AGG_WIDTHS, forward_flops,
                                        k1_bytes, k4_bytes, train_pass_flops)

__all__ = ["K1_KERNEL", "K4_KERNEL", "phase1_mean", "score_seconds",
           "device_idle",
           "k1_solve_roofline", "k4_roofline", "train_mfu",
           "k1_train_roofline"]

K1_KERNEL = "csr_aggregate"      # K1's device name (forward and backward)
K4_KERNEL = "small_mwvc_mitm"    # K4's device name


def phase1_mean(ctx, key):
    solves = ctx["counters"]["solves"]
    if not solves:
        return None
    return sum(s["phase1"].get(key, 0.0) for s in solves) / len(solves)


def score_seconds(solve):
    """The program's scoring timer ``t_score_s`` less the benchmark's own
    work inside it (the check's snapshots, ``check_s``)."""
    return solve["phase1"].get("t_score_s", 0.0) - solve.get("check_s", 0.0)


def device_idle(ctx):
    s = ctx["trace"]
    if s is None or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_seconds(s) / s.window_s)


def _roofline(ctx, kernel, bytes_):
    s = ctx["trace"]
    if s is None:
        return None
    secs = tr.device_seconds(s, kernel)
    if secs <= 0 or bytes_ <= 0:
        return None
    return 100.0 * bytes_ / HBM_BYTES_PER_S / secs


def k1_solve_roofline(ctx):
    """K1 in phase 1: every scorer call's launches, at its shapes."""
    launches = [k for s in ctx["counters"]["solves"] for c in s["calls"]
                for k in c["k1"]]
    return _roofline(ctx, K1_KERNEL, sum(k1_bytes(*k) for k in launches))


def k4_roofline(ctx):
    """K4: one batch of the traffic's batch size and width per launch in
    the trace."""
    s = ctx["trace"]
    if s is None:
        return None
    args = ctx["traffic"]["solve"]
    batch = args.get("assist_batch", 1024)
    width = 16 if args.get("assist_rmax", 20) <= 16 else 20
    count = tr.device_count(s, K4_KERNEL)
    return _roofline(ctx, K4_KERNEL, count * k4_bytes(batch, width))


def _passes(ctx):
    return sum(c["passes"] for c in ctx["counters"]["calls"])


def train_mfu(ctx):
    p = ctx["counters"]["per_pass"]
    flops = (sum(train_pass_flops(n, e) for n, e in p["train_graphs"])
             + sum(forward_flops(n, e) for n, e in p["eval_graphs"]))
    passes = _passes(ctx)
    if not passes or ctx["window_s"] <= 0:
        return None
    return 100.0 * passes * flops / (ctx["window_s"] * FP32_FLOPS_PER_S)


def k1_train_roofline(ctx):
    """K1 in training: per pass, each training graph's two forward and two
    backward sums and each evaluated graph's two forward sums, unmasked."""
    p = ctx["counters"]["per_pass"]
    per_pass = sum(2 * k1_bytes(n, n, e, w) for n, e in p["train_graphs"]
                   for w in SEA2022_AGG_WIDTHS)
    per_pass += sum(k1_bytes(n, n, e, w) for n, e in p["eval_graphs"]
                    for w in SEA2022_AGG_WIDTHS)
    return _roofline(ctx, K1_KERNEL, _passes(ctx) * per_pass)
