"""Statistical repetition driver: N independent runs ->
experiment_results.csv (the counterpart of ``examples/repeat_experiment.py``;
the reference's scripts/repeat.sh + export_results.py — SLAM is
RANSAC-nondeterministic, so distributions are the pass signal).

Usage:
  python -m rumi_slam_tpu_torch.examples.repeat_experiment --repeats 10 \\
      --out results/exp1 [--frames 110] [--lost 45 55] [--no-rumination] [--device cpu]

Runs the synthetic sequence by default; pass --data <tum_dir> to repeat over
a TUM sequence.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=10)
    ap.add_argument("--out", default="results/experiment")
    ap.add_argument("--frames", type=int, default=110)
    ap.add_argument("--lost", type=int, nargs=2, default=None)
    ap.add_argument("--data", default=None, help="TUM dir (default synthetic)")
    ap.add_argument("--no-rumination", action="store_true")
    ap.add_argument("--device", default="cuda", help="where the system runs (cuda or cpu)")
    args = ap.parse_args(argv)

    from ..config import tiny_config
    from ..evaluation import harness

    if args.data:
        from ..io.datasets import TumSequence

        def seq_factory(r):
            return TumSequence(args.data)
    else:
        from ..io.synthetic import SyntheticSequence

        def seq_factory(r):
            return SyntheticSequence(
                n_frames=args.frames, width=320, height=240, n_points=2000,
                seed=10 + r, patch=3, lost_span=tuple(args.lost) if args.lost else None,
                device=args.device,
            )

    rows = harness.repeat_experiment(
        seq_factory, tiny_config(), repeats=args.repeats, out_dir=args.out,
        enable_rumination=not args.no_rumination, device=args.device,
    )
    print(json.dumps(harness.summarize(rows), indent=2))


if __name__ == "__main__":
    main()
