"""The readings the check's limits are set from (``check.py``), on the card
at a cell's own size; the benchmark's runs do not run this.

    python3 -m slam_bench.control --workload <cell> --seconds <s> \\
        --seeds <n> ... [--fault-seeds <n> ...] [--faults <name> ...] [--out <file>]

For each of ``--seeds``, a sound run (``harness.execute``) in this one
process, its check readings and the control's: the reference under bfloat16
autocast put in the program's place for the step checks.  For each of
``--fault-seeds`` and each of ``--faults`` (``faults.FAULTS``), a run with
that fault planted under the timed path.  One JSON line a run, on standard
output and appended to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import harness
from .faults import FAULTS


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m slam_bench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=sorted(FAULTS), choices=sorted(FAULTS))
    ap.add_argument("--out")
    ap.add_argument("--dump", help="a directory for each run's truth-check inputs (.npz)")
    a = ap.parse_args(argv)
    jobs = [(s, ()) for s in a.seeds] + [(s, (f,)) for s in a.fault_seeds for f in a.faults]
    for seed, faults in jobs:
        t = time.perf_counter()
        dump = (None if a.dump is None else
                f"{a.dump}/{a.workload}.{seed}.{'-'.join(faults) or 'sound'}.npz")
        res, _ = harness.execute(a.workload, seed, a.seconds, False, faults=faults,
                                 control=not faults, t_start=t, dump=dump)
        row = {"workload": a.workload, "seed": seed, "faults": list(faults),
               "seconds": a.seconds, "correct": res["correct"], "failed": res["failed"],
               "attempted": res["attempted"],
               "readings": {n: c["value"] for n, c in res["checks"].items()},
               "control": res.get("control"), "metrics": res["metrics"],
               "window": res["window"]}
        line = json.dumps(row)
        print(line, flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
