"""Run one cell of the benchmark once and print its result line.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json``.  Everything
that belongs to one configuration, traffic mix or metric is a file found by
name: ``perfbench/configs/<config>.json`` (through the configuration's
``file``), ``perfbench/traffic/<traffic>.json`` (whose ``entry`` names the
module ``perfbench/entries/<entry>.py`` that drives the program) and
``perfbench/metrics/<metric>.py``.

A run: set-up (instances from the seed, the program loaded and warmed up),
then a window of ``--seconds`` that drives the program's entry point, then
the program's memory peak, then the reference's judgement of what the
window produced.  With ``--trace 1`` the window runs under the profiler
(``perfbench.yardstick.trace.Tracer``: the device's activity and the
benchmark's spans, not the host's operators) and the line carries the
per-layer metrics; with ``--trace 0`` the end-to-end ones.  The last line
of standard output is one JSON object; the numbers judged, each with its
limit, are the last lines of standard error and the last key of that
object.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()  # the set-up's clock starts here

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "gnn_mwvc_tpu")

# the program's and the libraries' build caches stay in the checkout, at
# fixed paths, so only a checkout's first run builds
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton")):
    os.environ[_var] = os.path.join(ROOT, ".perfbench_cache", _sub)


class NoDevice(RuntimeError):
    """The machine lacks the cards the cell asks for."""


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str, root: str = ROOT):
    """``perfbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(root, "perfbench", kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def resolve_cell(bench: dict, workload: str, root: str = ROOT):
    """(cell, config dict, traffic dict) of a workload name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    cfgs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(root, cfgs[cell["config"]]["file"]))
    traffic = load_json(os.path.join(root, "perfbench", "traffic",
                                     cell["traffic"] + ".json"))
    return cell, config, traffic


def metrics_of(bench: dict, cell_name: str, trace: bool) -> list:
    """The metric entries a cell reports: end-to-end without a trace,
    per-layer with one; a metric with ``workloads`` only in those cells."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if "workloads" not in m or cell_name in m["workloads"]]


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


class Spans:
    """``spans(name)``: the benchmark's host span ``perfbench.<name>`` in
    the trace, or nothing when the run is not traced (``spans.on``)."""

    def __init__(self, on: bool):
        self.on = on

    def __call__(self, name: str):
        import contextlib

        import torch

        return (torch.profiler.record_function("perfbench." + name)
                if self.on else contextlib.nullcontext())


def power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", bench: dict | None = None,
             scale: dict | None = None, traffic_over: dict | None = None,
             control: bool = False, root: str = ROOT) -> dict:
    """One run of a cell; returns the result object.  ``device="cpu"``,
    ``scale`` and ``traffic_over`` (configuration and traffic keys
    replaced, such as a smaller ``side``) and ``control`` (the numbers
    also judged with each of the entry's ``CONTROLS`` in the program's
    place, under ``"control"``) serve the tests and the limits' readings;
    a benchmark run uses none of them.  ``root``: the checkout whose
    ``BENCHMARK.json`` and ``perfbench/`` files define the cell."""
    import torch

    stamps = {"import_torch_s": time.perf_counter() - T_PROCESS}
    if bench is None:
        bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cell, config, traffic = resolve_cell(bench, workload, root)
    config = {**config, **(scale or {})}
    traffic = {**traffic, **(traffic_over or {})}
    if device == "cuda":
        if not torch.cuda.is_available():
            raise NoDevice("CUDA is not available")
        if torch.cuda.device_count() < cell["chips"]:
            raise NoDevice(f"{torch.cuda.device_count()} cards, the cell "
                           f"needs {cell['chips']}")
    entry = load_module("entries", traffic["entry"], root)
    dev = torch.device(device)

    stamps["before_prepare_s"] = time.perf_counter() - T_PROCESS
    state = entry.prepare(config, traffic, seed, seconds, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - T_PROCESS

    from perfbench.yardstick import trace as tr

    tracer = tr.Tracer(dev.type == "cuda") if trace else None
    if tracer is not None:
        tracer.start()
    spans = Spans(trace)
    with spans("window"):
        t0 = time.perf_counter()
        entry.window(state, seconds, spans)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        window_s = time.perf_counter() - t0
    summary = tracer.stop() if tracer is not None else None

    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    entry.release(state)
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    checks = entry.judge(state)
    attempted, failed = entry.attempts(state)
    correct = attempted > 0 and failed == 0 and all(
        c["value"] <= c["limit"] for c in checks.values())

    ctx = {"setup_s": setup_s, "window_s": window_s, "trace": summary,
           "counters": entry.counters(state), "config": config,
           "traffic": traffic, "cell": cell}
    metrics, other = {}, {}
    for group, on in ((metrics, trace), (other, not trace)):
        for m in metrics_of(bench, workload, on):
            value = load_module("metrics", m["name"], root).read(ctx)
            if value is not None:
                group[m["name"]] = {"value": value, "unit": m["unit"]}

    out = {"correct": bool(correct), "attempted": attempted,
           "failed": failed, "metrics": metrics,
           "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                      "kind": (torch.cuda.get_device_name(dev)
                               if dev.type == "cuda" else "cpu"),
                      "count": cell["chips"], "memory_peak_bytes": peak}}
    if dev.type == "cuda":
        out["device"]["power_limit"] = power_limit()
    if summary is not None:
        out["device"]["busy_s"] = tr.busy_seconds(summary)
        out["device"]["window_s"] = summary.window_s
        out["breakdown"] = {"device_ops": tr.top_ops(summary),
                            "idle_gaps": tr.idle_gaps(summary)}
    if control:
        out["control"] = {}
        for name in entry.CONTROLS:
            ctl = entry.judge(state, control=name)
            out["control"][name] = {"checks": ctl, "correct": all(
                c["value"] <= c["limit"] for c in ctl.values())}
    out["checks"] = checks
    found = forbidden_modules()
    if found:
        raise ImportError("the run loaded " + ", ".join(found))
    # for comparison, not for the result: the other group's metrics where
    # this run can read them (a traced run's end-to-end ones show what the
    # trace costs), and where the set-up's seconds went
    print("perfbench: other metrics " + json.dumps(
        {k: v["value"] for k, v in other.items()}), file=sys.stderr)
    print("perfbench: set-up " + json.dumps(
        {**stamps, **state.get("setup_parts", {}), "setup_s": setup_s}),
        file=sys.stderr)
    print("perfbench: counters " + json.dumps(
        _brief(ctx["counters"]), default=str)[:6000], file=sys.stderr)
    return out


def _brief(obj):
    """The counters without their per-round and per-call lists."""
    if isinstance(obj, dict):
        return {k: _brief(v) for k, v in obj.items()
                if k not in ("rounds", "calls", "train_graphs",
                             "eval_graphs")}
    if isinstance(obj, list):
        return [_brief(v) for v in obj]
    return obj


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        out = run_cell(args.workload, args.seed, args.seconds,
                       bool(args.trace))
    except NoDevice as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    except ImportError as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 3
    except Exception:  # the run's boundary: report and fail, no result
        traceback.print_exc()
        return 1
    for name, c in out["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
