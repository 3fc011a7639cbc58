"""Run a cell for a fixed number of window frames and print its check
readings, one JSON line a seed, to compare two trees on the same frames.

    python3 <tree>/slam_bench/probe.py --workload <cell> --frames <n> --seeds <n> ...

A run whose window ends by the clock reads the truth checks' map after as
many mapping rounds as the host ran by then, so two trees of different
speed read different maps; this one ends the window after ``--frames``
frames, on every tree alike.  It imports the ``slam_bench`` of the working
directory, so one copy of this file drives another tree's harness too.  The
window ends by an exception, so ``correct`` reads false by design; the
readings are what counts.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


class Stop(Exception):
    """Ends the window after the frames asked for."""


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python3 slam_bench/probe.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--frames", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    a = ap.parse_args(argv)
    root = os.getcwd()
    sys.path.insert(0, root)
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(root, "build", "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(root, "build", "triton")
    from slam_bench import harness, stream

    orig = stream.Stream.frame

    def frame(self, k):
        if k >= self.warmup_frames + a.frames:
            raise Stop()
        return orig(self, k)

    stream.Stream.frame = frame
    for seed in a.seeds:
        res, _ = harness.execute(a.workload, seed, 1e9, False, t_start=time.perf_counter())
        print(json.dumps({"tree": root, "workload": a.workload, "seed": seed,
                          "frames": res["window"]["frames"], "readings": res["readings"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
