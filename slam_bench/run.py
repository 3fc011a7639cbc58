"""Entry point of the benchmark:

    python3 -m slam_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON line as the last line of standard output.  Needs a CUDA
card: without one it exits with code 2 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m slam_bench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every build and kernel cache inside the checkout, at fixed paths (the
    # fused matcher's nvcc output goes to build/ by itself)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    from . import harness

    return harness.main(args, T_START)


if __name__ == "__main__":
    sys.exit(main())
