"""Real-trajectory validation: the ATE distribution over repeated runs (the
counterpart of ``examples/ate_experiment.py``).

Drives the synthetic renderer along a TUM mocap trajectory
(``io/real_trajectory.GroundtruthSequence``: the reference's vendored
``groundtruth/slam-tum/<seq>/groundtruth.txt``), with forced loss gaps so the
rumination path engages, repeats over independent seeds (world + RANSAC),
and writes the DISTRIBUTION (reference repeat.sh + experiment_results.csv
protocol: median/mean/min/max ATE, completion rate, merge counts; compare
BASELINE.md fr1_floor: median 0.0166 m over 189 runs, rate ~0.93).

Protocol (the JAX driver's):
  * the full sequence by default (``--duration`` truncates);
  * a sweep of gap placements (``--gap-starts``); rows carry their placement;
  * ``--control`` runs the no-loss distribution (no gap, no rumination);
  * gaps are rendered degraded (blur + contrast collapse) by default, so the
    optical-flow sampler has signal;
  * every row records merge result codes and association forensics.

``--seq`` is an absolute path to a groundtruth.txt, or a sequence directory
under ``--gt-root``.  The results go to ``--out`` (relative to the working
directory; by default ``ate_experiment_torch.json``, or
``ate_experiment_control_torch.json`` with ``--control``); the JAX package's
``ATE_r05*.json`` names are refused.

Usage:
  python -m rumi_slam_tpu_torch.examples.ate_experiment --gt-root DIR \\
      [--seq rgbd_dataset_freiburg1_floor] [--control] [--pace 1.0] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def experiment_config(tiny=True):
    import dataclasses

    from ..config import tiny_config

    cfg = tiny_config()
    # short reloc window forces genuine LOSS at the gap (the rumination
    # path, not PnP relocalization, must stitch the run); bundle budgets
    # closer to the reference's 40/40 so the backend has enough back-head
    # context to rebuild and weld the far side of the gap
    return dataclasses.replace(
        cfg,
        tracking=dataclasses.replace(cfg.tracking, reloc_window_s=0.1),
        sampler=dataclasses.replace(cfg.sampler, n_track_last=16,
                                    n_new_track_first=12, min_time_s=0.4,
                                    min_bundle=10),
        # capacity for the live maps PLUS the imported cloud map over a
        # full-length run at ~3-4 KF/s (dropping cloud KFs silently would
        # sabotage the merge)
        mapping=dataclasses.replace(cfg.mapping, max_kf=384, max_pt=16384))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=10,
                    help="seeds per gap placement")
    ap.add_argument("--duration", type=float, default=None,
                    help="truncate the sequence (default: FULL length)")
    ap.add_argument("--gap-starts", type=float, nargs="*",
                    default=(8.0, 16.0, 24.0, 34.0),
                    help="gap start times (s); seeds are distributed "
                         "round-robin over placements")
    ap.add_argument("--gap-len", type=float, default=3.0,
                    help="gap length (s); >=3 s gives the PD sampler the "
                         "flow history the reference assumes "
                         "(sampler_new_kf_min_time=3.0, main.launch:32)")
    ap.add_argument("--gap-mode", default="degraded",
                    choices=("degraded", "featureless"))
    ap.add_argument("--control", action="store_true",
                    help="no-loss control: no gap, no rumination — the "
                         "rendering-domain + tracking floor")
    ap.add_argument("--seq", default="rgbd_dataset_freiburg1_floor",
                    help="a sequence directory under --gt-root, or an "
                         "absolute path to a groundtruth.txt")
    ap.add_argument("--gt-root", default=None,
                    help="the directory holding <seq>/groundtruth.txt")
    ap.add_argument("--out", default=None)
    ap.add_argument("--no-rumination", action="store_true")
    ap.add_argument("--no-gba", action="store_true",
                    help="A/B: disable the post-merge global BA relaunch")
    ap.add_argument("--pace", type=float, default=0.0,
                    help="realtime pace factor (0 = offline)")
    ap.add_argument("--start-repeat", type=int, default=0,
                    help="skip the first N repeats (resume a killed run)")
    ap.add_argument("--repeat-list", type=int, nargs="*", default=None,
                    help="run exactly these repeat indices (split the seed "
                         "set over parallel worker processes)")
    ap.add_argument("--device", default="cuda", help="where the system runs (cuda or cpu)")
    args = ap.parse_args(argv)
    if args.out is None:
        args.out = ("ate_experiment_control_torch.json" if args.control
                    else "ate_experiment_torch.json")
    if os.path.basename(args.out).startswith("ATE_r05"):
        ap.error(f"--out {args.out}: ATE_r05*.json hold the JAX package's results")

    from ..evaluation import harness
    from ..io.real_trajectory import GroundtruthSequence

    cfg = experiment_config()
    if args.no_gba:
        import dataclasses

        cfg = dataclasses.replace(
            cfg, merge=dataclasses.replace(cfg.merge, run_gba=False))

    def seq_factory(r):
        if args.control:
            gap = None
        else:
            start = args.gap_starts[r % len(args.gap_starts)]
            gap = (start, start + args.gap_len)
        return GroundtruthSequence(
            args.seq, gt_root=args.gt_root, duration_s=args.duration, seed=100 + r,
            lost_span_s=gap, gap_mode=args.gap_mode, device=args.device), gap

    path = os.path.abspath(args.out)
    rows = []
    if args.start_repeat and os.path.exists(path):
        rows = [r for r in json.load(open(path))["rows"]
                if r["repeat"] < args.start_repeat]
    todo = (list(args.repeat_list) if args.repeat_list is not None
            else list(range(args.start_repeat, args.repeats)))
    for r in todo:
        seq, gap = seq_factory(r)
        row = harness.run_once(
            seq, cfg, seed=r,
            enable_rumination=not (args.no_rumination or args.control),
            realtime_pace=args.pace, warmup=args.pace > 0, device=args.device)
        row["repeat"] = r
        row["gap"] = list(gap) if gap else None
        rows.append(row)
        print(f"[repeat {r}] gap={gap} ate={row['ate']:.4f} "
              f"rate={row['rate']:.3f} merges={row['n_merges']} "
              f"sampled={row.get('n_lost_sampled', 0)}/"
              f"{row.get('n_lost_raw', 0)} t={row['runtime_s']:.0f}s",
              file=sys.stderr, flush=True)
        # written after every repeat: partial distributions survive a killed run
        _write(path, rows, args, complete=(r == todo[-1]))
    print("written:", path)


ROW_KEYS = (
    "repeat", "gap", "ate", "ate_frame", "err_p50", "err_p90", "err_max",
    "rate", "n_kf", "n_loops", "loop_best_score", "loop_verify_inliers",
    "n_reloc",
    "n_loss_events", "n_maps", "n_merges",
    "upload_mb", "upload_mb_raw", "n_lost_sampled", "n_lost_raw",
    "runtime_s", "drops", "n_tracked", "merge_results",
)


def _write(path, rows, args, *, complete):
    """The JAX driver's JSON layout (a copy of its ``_write``)."""
    import numpy as np

    ates = np.asarray([r["ate"] for r in rows])
    finite = ates[np.isfinite(ates)]
    up = [r["upload_mb"] for r in rows if r.get("upload_mb")]
    upr = [r["upload_mb_raw"] for r in rows if r.get("upload_mb_raw")]
    out = {
        "metric": "ate_rmse_real_trajectory",
        "trajectory": args.seq + " (vendored mocap groundtruth, synthetic "
                      "rendering — real images unavailable: zero egress)",
        "duration_s": args.duration if args.duration else "full",
        "control": args.control,
        "gap_starts": list(args.gap_starts) if not args.control else [],
        "gap_len_s": args.gap_len if not args.control else 0.0,
        "gap_mode": args.gap_mode,
        "realtime_pace": args.pace,
        "repeats_planned": args.repeats,
        "repeats_done": len(rows),
        "complete": complete,
        "rumination": not (args.no_rumination or args.control),
        "ate_m": {
            "median": float(np.median(finite)) if len(finite) else None,
            "mean": float(np.mean(finite)) if len(finite) else None,
            "min": float(np.min(finite)) if len(finite) else None,
            "max": float(np.max(finite)) if len(finite) else None,
            "n_finite": int(len(finite)),
        },
        "rate_mean": float(np.mean([r["rate"] for r in rows])),
        "n_merges_total": int(sum(r["n_merges"] for r in rows)),
        "merged_runs": int(sum(1 for r in rows if r["n_merges"] > 0)),
        "upload_mb_mean": float(np.mean(up)) if up else 0.0,
        "upload_mb_raw_mean": float(np.mean(upr)) if upr else 0.0,
        "reference_baseline": {
            "sequence": "fr1_floor (real images, real cloud server)",
            "ate_median_m": 0.0166, "ate_mean_m": 0.0196,
            "rate": 0.93, "n_runs": 189,
            "source": "BASELINE.md / scripts/experiment_results.csv",
        } if "floor" in args.seq else {
            "sequence": "fr2_pioneer_slam (real images, real cloud server)",
            "ate_median_m": 0.1554, "ate_mean_m": 0.3062, "n_runs": 160,
            "source": "BASELINE.md / scripts/experiment_results_2.csv",
        },
        "rows": [
            {k: (None if isinstance(v, float) and not np.isfinite(v) else v)
             for k, v in r.items() if k in ROW_KEYS}
            for r in rows
        ],
    }
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: out[k] for k in
                      ("ate_m", "rate_mean", "merged_runs")}, indent=1),
          flush=True)


if __name__ == "__main__":
    main()
