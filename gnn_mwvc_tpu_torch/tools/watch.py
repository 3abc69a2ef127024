"""Run one command and sample its memory while it runs: the resident set
of the process and its descendants, and the memory in use on each card.
The full-size studies (a 1000 s canonical run, the side-3600 reduce, the
full training-quality study) run under it, so a run that grows over its
budget shows in the samples.

Usage:
    python -m gnn_mwvc_tpu_torch.tools.watch [--every 30] [--out PATH]
        [--log PATH] -- COMMAND [ARGS...]

Prints the card's name and power limit (``nvidia-smi``; "none" without
one), then the command's output as it comes (also written to ``--log``),
then as the last line a JSON record: the command, its exit code and wall
seconds, the samples ``[seconds, host RSS bytes, [MiB used per card]]``
and their peaks.  Exits with the command's code.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time


def smi(query: str):
    """``nvidia-smi --query-gpu=<query>`` lines, or None without the tool."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (FileNotFoundError, subprocess.TimeoutExpired):
        return None
    if out.returncode != 0:
        return None
    return [ln.strip() for ln in out.stdout.strip().splitlines()]


def card_mib():
    """MiB in use on each card, or None without ``nvidia-smi``."""
    lines = smi("memory.used")
    return None if lines is None else [int(ln.split()[0]) for ln in lines]


def tree_rss(pid: int) -> int:
    """Resident bytes of ``pid`` and its descendants (0 once it is gone)."""
    total, todo = 0, [pid]
    while todo:
        p = todo.pop()
        try:
            with open(f"/proc/{p}/status") as f:
                for ln in f:
                    if ln.startswith("VmRSS:"):
                        total += int(ln.split()[1]) * 1024
            for tid in os.listdir(f"/proc/{p}/task"):
                with open(f"/proc/{p}/task/{tid}/children") as f:
                    todo.extend(int(c) for c in f.read().split())
        except (FileNotFoundError, ProcessLookupError):
            continue
    return total


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--every", type=float, default=30.0,
                    help="seconds between samples")
    ap.add_argument("--out", default=None,
                    help="JSON record (default: watch.json in the temporary "
                         "directory)")
    ap.add_argument("--log", default=None,
                    help="a copy of the command's output")
    ap.add_argument("command", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    cmd = args.command[1:] if args.command[:1] == ["--"] else args.command
    if not cmd:
        ap.error("no command")

    card = smi("name,power.limit")
    print("card: " + ("; ".join(card) if card else "none"), flush=True)
    log = open(args.log, "w") if args.log else None
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, bufsize=1)

    def copy():
        for ln in proc.stdout:
            sys.stdout.write(ln)
            sys.stdout.flush()
            if log is not None:
                log.write(ln)
                log.flush()

    reader = threading.Thread(target=copy, daemon=True)
    reader.start()
    samples = []
    while True:
        samples.append([round(time.perf_counter() - t0, 1),
                        tree_rss(proc.pid), card_mib()])
        try:
            proc.wait(timeout=args.every)
            break
        except subprocess.TimeoutExpired:
            pass
    wall = time.perf_counter() - t0
    reader.join()
    if log is not None:
        log.close()
    cards = [s[2] for s in samples if s[2] is not None]
    rec = {"command": cmd, "rc": proc.returncode, "wall_s": round(wall, 1),
           "card": card, "every_s": args.every, "samples": samples,
           "peak_rss_bytes": max(s[1] for s in samples),
           "peak_card_mib": [max(c) for c in zip(*cards)] if cards else None}
    with open(args.out or os.path.join(tempfile.gettempdir(), "watch.json"),
              "w") as f:
        json.dump(rec, f)
    print(json.dumps(rec), flush=True)
    return proc.returncode


if __name__ == "__main__":
    raise SystemExit(main())
