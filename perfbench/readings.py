"""The readings that each correctness limit is set from: a cell run on many
seeds in one process, each run's numbers judged for the program and for
each stand-in of the entry's ``CONTROLS``: the control (the reference
with TF32 products in the program's place) and, for training, the fault
"half of the batch left out" planted in the reference.

    python3 -m perfbench.readings --workload <cell> --seconds <s> --seeds 1,2,3

Prints one JSON line per seed.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

from perfbench.run import run_cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        out = run_cell(args.workload, seed, args.seconds, trace=False,
                       control=True)
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "correct": out["correct"], "attempted": out["attempted"],
            "program": {k: c["value"] for k, c in out["checks"].items()},
            "control": {name: {k: c["value"] for k, c in ctl["checks"].items()}
                        for name, ctl in out["control"].items()},
            "metrics": {k: m["value"] for k, m in out["metrics"].items()},
            "kind": out["device"]["kind"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
