"""score_mfu: the model FLOPs of the scored rounds' live vertices and
directed edges (the benchmark's span around each scorer call) over the
program's scoring seconds (less the check's snapshots) at the float32
peak, in percent."""

from perfbench.yardstick.counts import FP32_FLOPS_PER_S, forward_flops
from perfbench.yardstick.readers import score_seconds


def read(ctx):
    solves = ctx["counters"]["solves"]
    secs = sum(score_seconds(s) for s in solves)
    flops = sum(forward_flops(c["n"], c["nnz"]) for s in solves
                for c in s["calls"])
    if secs <= 0 or not flops:
        return None
    return 100.0 * flops / (secs * FP32_FLOPS_PER_S)
