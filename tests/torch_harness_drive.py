"""``evaluation.harness.run_once`` in the JAX package or in the port, on a
``GroundtruthSequence`` rendered along a trajectory written to a
``groundtruth.txt`` by the port's ``io/trajectory.save_tum``.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_harness_drive.py
        [--port] [--tiny] [--lost] [--frames N] [--seed N] [--record]

* default: ``Config()`` widths (640x480, 8 levels, 1024 features, ``max_kf``
  256, ``max_pt`` 16384) with synchronous mapping, 60 frames of a handheld
  sweep (``io.synthetic.sweep_trajectory(seed=11)``, written at 30 Hz), 2000
  landmarks, the sequence rendered with the configuration's intrinsics,
  rumination on (the coordinator is attached; without a loss it never
  builds).  ``GroundtruthSequence`` places its landmarks along the
  trajectory, so their density grows as the trajectory shortens: its
  default 2500 over a 2 s trajectory at 320x240 fills every pixel and
  tracking is lost within ten frames in both packages.  ``chip_smoke.py``
  phase 12 (b) drives this scenario on the card and holds it to JAX's row.
* ``--tiny``: ``tiny_config()`` (320x240), 30 frames and 300 landmarks, the
  scale of the CPU parity test ``tests/test_torch_harness.py``.
* ``--lost``: 60 frames with 0.8-1.0 s (frames 24-29) motion-degraded
  (``GroundtruthSequence``'s ``gap_mode="degraded"``) and ``reloc_window_s``
  0.1, so the system loses track, opens a new submap, and the coordinator
  ruminates and merges (the package's own backend; with ``--tiny`` JAX
  merges with 9 / 902 cloud and 5 / 194 back matches, and 3 maps remain
  counted).  The harness test holds the port's rumination columns to it.
* ``--port``: the port on the CPU instead of the JAX package.
* ``--record``: write JAX's row into ``tests/torch_harness_floor.json`` under
  ``"full"`` or ``"tiny"`` (``"tiny_lost"`` with ``--lost``; the card host has
  no JAX).

It prints the row as one JSON object (the numeric columns and ``merge_results``).
The module imports neither package at the top, so ``chip_smoke.py`` can load
it where JAX is absent.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import tempfile
import time
from pathlib import Path

import numpy as np

GT_SEED = 11
FRAMES, POINTS = 60, 2000
TINY_FRAMES, TINY_POINTS = 30, 300
LOST_FRAMES, LOST_SPAN_S = 60, (0.8, 1.0)
FLOOR = Path(__file__).resolve().parent / "torch_harness_floor.json"


def write_groundtruth(path, frames: int, seed: int = GT_SEED):
    """A handheld sweep as TUM groundtruth (camera-to-world rows at 30 Hz),
    written by the port's ``save_tum``; the same bytes on every host."""
    import torch

    from rumi_slam_tpu_torch.io import synthetic, trajectory

    poses, times = synthetic.sweep_trajectory(frames, seed=seed)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    trajectory.save_tum(path, 1305031102.0 + times, torch.stack(poses).numpy())
    return str(path)


def scenario_config(cfg_mod, tiny: bool, lost=False):
    """``tiny_config()``, or ``Config()`` with synchronous mapping; with
    ``lost``, ``reloc_window_s=0.1`` so that a loss opens a new submap."""
    if tiny:
        cfg = cfg_mod.tiny_config()
    else:
        cfg = cfg_mod.Config()
        cfg = dataclasses.replace(cfg, mapping=dataclasses.replace(cfg.mapping,
                                                                   overlapped=False))
    if lost:
        cfg = dataclasses.replace(cfg, tracking=dataclasses.replace(cfg.tracking,
                                                                    reloc_window_s=0.1))
    return cfg


def make_sequence(rt_mod, cfg, gt_path, n_points, **kw):
    """The scenario's ``GroundtruthSequence`` (no loss gap) in either
    package (``rt_mod`` is its ``io.real_trajectory``)."""
    c = cfg.camera
    K = [c.fx, c.fy, c.cx, c.cy]
    return rt_mod.GroundtruthSequence(os.path.abspath(gt_path), width=c.width, height=c.height,
                                      K=np.asarray(K, np.float32), n_points=n_points,
                                      seed=GT_SEED, **kw)


ROW_KEYS = ("ate", "ate_frame", "rate", "duration", "n_kf", "n_points", "n_maps",
            "n_merges", "n_tracked", "drops", "lost_timestamp", "new_map_timestamp",
            "n_reloc", "n_loss_events", "front_cloud_match_num", "back_cloud_match_num",
            "merge_inlier_ratio", "bundle_frames", "upload_mb", "upload_mb_raw",
            "merge_results", "runtime_s", "rss_mb")


def row_summary(row: dict, frames: int) -> dict:
    out = {k: row.get(k) for k in ROW_KEYS}
    out["frames"] = frames
    out["ok_share"] = row["n_tracked"] / frames
    return out


def run(package="rumi_slam_tpu", *, tiny=False, lost=False, frames=None, seed=0,
        device="cpu", gt_dir=None):
    """``run_once`` of ``package`` over the scenario; returns the summary."""
    port = package.endswith("_torch")
    frames = frames or (LOST_FRAMES if lost else TINY_FRAMES if tiny else FRAMES)
    mod = lambda name: importlib.import_module(f"{package}.{name}")
    cfg = scenario_config(mod("config"), tiny, lost)
    harness, rt = mod("evaluation.harness"), mod("io.real_trajectory")
    with tempfile.TemporaryDirectory() as tmp:
        gt = write_groundtruth(Path(gt_dir or tmp) / "sweep" / "groundtruth.txt", frames)
        dev_kw = {"device": device} if port else {}
        seq = make_sequence(rt, cfg, gt, TINY_POINTS if tiny else POINTS,
                            lost_span_s=LOST_SPAN_S if lost else None, **dev_kw)
        row = harness.run_once(seq, cfg, seed=seed, enable_rumination=True, **dev_kw)
    return row_summary(row, len(seq))


def _jsonable(x):
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, (np.floating, np.integer)):
        return x.item()
    if hasattr(x, "tolist"):
        return x.tolist()
    return x


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--port", action="store_true", help="the port on the CPU")
    ap.add_argument("--tiny", action="store_true", help="tiny_config(), 30 frames")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lost", action="store_true", help="frames 24-29 degraded")
    ap.add_argument("--record", action="store_true",
                    help="write JAX's row into tests/torch_harness_floor.json")
    a = ap.parse_args()
    t0 = time.perf_counter()
    res = run("rumi_slam_tpu_torch" if a.port else "rumi_slam_tpu", tiny=a.tiny,
              lost=a.lost, frames=a.frames, seed=a.seed)
    res["seconds"] = time.perf_counter() - t0
    res = _jsonable(res)
    print(json.dumps(res), flush=True)
    if a.record and not a.port:
        floor = json.loads(FLOOR.read_text()) if FLOOR.exists() else {}
        floor[("tiny" if a.tiny else "full") + ("_lost" if a.lost else "")] = res
        FLOOR.write_text(json.dumps(floor, indent=1) + "\n")
