"""Experiment harness: per-run result.csv + statistical repetition driver
(port of ``rumi_slam_tpu/evaluation/harness.py``).

Reproduces the reference's metric schema and repeat protocol: the per-run
``result.csv`` writer (cloud_edge_main.cpp:350-382 — ate, rate, duration,
front/back cloud match counts, lost/new-map timestamps, upload sizes) and
the 30x repetition harness (scripts/repeat.sh + export_results.py harvesting
into experiment_results.csv — SLAM is RANSAC-nondeterministic, so
distributions, not single runs, are the pass signal).
"""

from __future__ import annotations

import csv
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

RESULT_COLUMNS = [
    "dataset", "ate", "ate_frame", "rate", "duration", "runtime_s",
    "front_cloud_match_num", "back_cloud_match_num",
    "lost_timestamp", "new_map_timestamp",
    "n_kf", "n_points", "n_maps", "n_merges", "merge_inlier_ratio",
    "bundle_frames", "upload_mb", "upload_mb_raw", "drops", "n_tracked",
    "rss_mb",
]


def _numpy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def run_once(seq, config, *, seed: int = 0, enable_rumination: bool = True,
             realtime_pace: float = 0.0, warmup: bool = False, device="cuda") -> dict:
    """Run the full system over a sequence on ``device`` (the card unless
    the caller asks for the CPU); return a result-row dict.

    ``seed`` seeds the system's RANSAC draw generator (the JAX package seeds
    its PRNG key), so a row is reproducible per package, not across them.

    ``realtime_pace`` > 0 replays at pace x real time with the reference's
    drop semantics (cloud_edge_main.cpp:597-610: the replay clock never
    waits): a frame whose timestamp has already passed by more than one
    frame interval when the tracker gets to it is DROPPED, counted in the
    ``drops`` column, and the completion ``rate`` degrades accordingly.

    ``warmup`` first runs the whole sequence offline through a scratch
    system (same configuration, seed and device) and discards it, so the
    process's one-time costs land before the replay clock starts: the
    matcher's nvcc build on the first frame tracked on the card, and the
    first load of the card's solver library (seconds, at the first
    rumination merge).  Without it both fall inside ``runtime_s`` and, under
    pacing, expire frames."""
    from ..evaluation import ate as ate_mod
    from ..runtime import native
    from ..rumination.coordinator import RuminationCoordinator
    from ..system import SlamSystem

    if warmup:
        run_once(seq, config, seed=seed, enable_rumination=enable_rumination,
                 realtime_pace=0.0, device=device)

    slam = SlamSystem(config, device=device)
    slam._gen = torch.Generator().manual_seed(seed)
    coord = RuminationCoordinator(slam, config) if enable_rumination else None

    drops = 0
    tb = float(seq.times[0]) if len(seq) else 0.0
    slack = (
        float(np.median(np.diff(np.asarray(seq.times))))
        if len(seq) > 2 else 0.033
    )
    # under pacing, materialize the dataset BEFORE the replay clock starts:
    # the reference replays images read off disk (RunTxt,
    # cloud_edge_main.cpp:577-620) — the synthetic renderer's per-frame host
    # cost is dataset *preparation*, not tracker latency, and charging it to
    # the replay clock would drop frames the reference never pays for
    frames = ([seq.frame(i) for i in range(len(seq))]
              if realtime_pace > 0 else None)
    t_start = time.perf_counter()
    for i in range(len(seq)):
        if realtime_pace > 0:
            due = (float(seq.times[i]) - tb) / realtime_pace
            elapsed = time.perf_counter() - t_start
            if elapsed > due + slack:
                drops += 1      # tracker fell behind; frame expired
                continue
            if due > elapsed:
                time.sleep(due - elapsed)
        img, t = frames[i] if frames is not None else seq.frame(i)
        slam.track_monocular(img, t)
        if coord is not None:
            coord.maybe_ruminate()
    if slam.device.type == "cuda":
        torch.cuda.synchronize(slam.device)
    runtime = time.perf_counter() - t_start

    gt_t = np.asarray(seq.times)
    gt_p = np.stack([_numpy(p) for p in seq.poses_gt])
    # the reference's oracle scores the KEYFRAME trajectory exported after
    # all optimizations (CloudSaveKeyFrameTrajectoryTUM,
    # cloud_edge_main.cpp:319-324; evo_node.py:182-206) — KF poses carry
    # the retroactive LBA/GBA/merge corrections the frame-time log never
    # sees; the frame log is kept as a diagnostic column
    times, poses = slam.keyframe_trajectory()
    m = ate_mod.evaluate_trajectory(times, poses, gt_t, gt_p)
    ft, fp = slam.trajectory_of_map()
    mf = ate_mod.evaluate_trajectory(ft, fp, gt_t, gt_p)

    history = coord.history if coord else []
    merges = [h for h in history if h.get("result") == "merged"]
    lost_ts = [t for t, _, _, s in slam.trajectory if s == "RECENTLY_LOST"]
    n_tracked = sum(1 for _, _, _, s in slam.trajectory if s == "OK")
    rss = native.rss_bytes()
    rss_mb = rss / 1e6 if rss >= 0 else -1.0

    ms = slam.ms
    return {
        "dataset": getattr(seq, "name", "synthetic"),
        "ate": m["ate"],
        "ate_frame": mf["ate"],
        "err_p50": m.get("err_p50"),
        "err_p90": m.get("err_p90"),
        "err_max": m.get("err_max"),
        "rate": m["rate"],
        "duration": float(gt_t[-1] - gt_t[0]) if len(gt_t) > 1 else 0.0,
        "runtime_s": runtime,
        "front_cloud_match_num": merges[0]["cloud_merge"]["n_pt_pairs"] if merges else 0,
        "back_cloud_match_num": merges[0]["back_merge"]["n_pt_pairs"] if merges else 0,
        "lost_timestamp": lost_ts[0] if lost_ts else -1.0,
        "new_map_timestamp": -1.0 if slam.stats["n_new_maps"] == 0 else lost_ts[-1] if lost_ts else -1.0,
        "n_kf": slam.stats["n_kf"],
        "n_loops": slam.stats.get("n_loops", 0),
        "n_reloc": slam.stats.get("n_reloc", 0),
        "n_loss_events": slam.stats.get("n_loss_events", 0),
        "loop_best_score": slam.stats.get("loop_best_score", 0),
        "loop_verify_inliers": slam.stats.get("loop_verify_inliers", 0),
        "n_points": int(ms.pt_valid.sum()),
        "n_maps": int(ms.n_maps),
        "n_merges": len(merges),
        "merge_inlier_ratio": merges[0]["cloud_merge"].get("inlier_ratio", 0.0) if merges else 0.0,
        "bundle_frames": merges[0].get("bundle_size", 0) if merges else 0,
        "upload_mb": sum(h.get("upload_mb", 0.0) for h in history),
        "upload_mb_raw": sum(h.get("upload_mb_raw", 0.0) for h in history),
        "n_lost_sampled": max((h.get("n_lost_sampled", 0) for h in history), default=0),
        "n_lost_raw": max((h.get("n_lost_raw", 0) for h in history), default=0),
        # merge forensics: every attempt's outcome + the association
        # evidence behind it, so failed runs explain themselves
        "merge_results": [
            {"result": h.get("result"),
             "n_cloud_kf": h.get("n_cloud_kf"),
             "cloud": _merge_brief(h.get("cloud_merge")),
             "back": _merge_brief(h.get("back_merge")),
             "weld": h.get("backend_weld"),
             "gba": h.get("gba")}
            for h in history
            if h.get("result") != "bundle_too_small"
        ],
        "drops": drops,
        "n_tracked": n_tracked,
        "rss_mb": rss_mb,
    }


def _merge_brief(i):
    if not isinstance(i, dict):
        return None
    keep = ("n_kf_matches", "n_pt_pairs", "inlier_ratio", "reason", "retried")
    return {k: (round(v, 4) if isinstance(v, float) else v)
            for k, v in i.items() if k in keep}


def write_result_csv(row: dict, path) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=RESULT_COLUMNS)
        w.writeheader()
        w.writerow({k: row.get(k, "") for k in RESULT_COLUMNS})


def repeat_experiment(seq_factory, config, *, repeats: int = 5,
                      out_dir: Optional[str] = None,
                      enable_rumination: bool = True, device="cuda") -> list[dict]:
    """Reference repeat.sh equivalent: N independent runs, aggregate CSV."""
    import sys

    rows = []
    for r in range(repeats):
        seq = seq_factory(r)
        row = run_once(seq, config, seed=r, enable_rumination=enable_rumination,
                       device=device)
        row["repeat"] = r
        rows.append(row)
        print(f"[repeat {r}] ate={row['ate']:.4f} rate={row['rate']:.3f} "
              f"merges={row['n_merges']} kf={row['n_kf']} "
              f"t={row['runtime_s']:.0f}s", file=sys.stderr, flush=True)
        if out_dir:
            write_result_csv(row, Path(out_dir) / f"run_{r:03d}" / "result.csv")
    if out_dir:
        agg = Path(out_dir) / "experiment_results.csv"
        with open(agg, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=["repeat"] + RESULT_COLUMNS)
            w.writeheader()
            for row in rows:
                w.writerow({k: row.get(k, "") for k in ["repeat"] + RESULT_COLUMNS})
    return rows


def summarize(rows: list[dict]) -> dict:
    ates = [r["ate"] for r in rows if np.isfinite(r["ate"])]
    return {
        "n": len(rows),
        "n_finite": len(ates),
        "ate_median": float(np.median(ates)) if ates else float("inf"),
        "ate_mean": float(np.mean(ates)) if ates else float("inf"),
        "rate_mean": float(np.mean([r["rate"] for r in rows])),
    }
