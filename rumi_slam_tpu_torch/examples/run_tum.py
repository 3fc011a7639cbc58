"""Run the port's full SLAM system over a TUM RGB-D sequence directory (the
counterpart of ``examples/run_tum.py``).

The reference's dataset driver (cloud_edge_main.cpp: main :183 +
Grabber::RunTxt :550): replay rgb.txt at the recorded cadence, track every
frame, poll the rumination coordinator, and at the end export the trajectory,
score ATE against groundtruth, and write result.csv + traj.png into a
timestamped results directory (:252-388).

Usage:
  python -m rumi_slam_tpu_torch.examples.run_tum --data /path/to/rgbd_dataset_freiburg3_xyz \\
      --preset tum3 [--rgbd] [--pace 1.0] [--out results/] [--device cpu]

The system runs on the card unless ``--device cpu`` is given.  With --pace > 0
(monocular) frames flow through the native C++ SPSC frame ring
(``runtime/edge_runtime.cpp`` FrameQueue, drop-OLDEST when full): a producer
paces frames at pace x real time — the fully-native tum_start_replay thread
when the dataset is PGM/PPM, a Python decode thread otherwise — and the
tracking loop pops.  Frames the tracker cannot keep up with are dropped by
the ring and counted in result.csv's ``drops`` column, the reference's
realtime semantics (cloud_edge_main.cpp:597-610).  --pace 0 (default)
replays offline, every frame tracked.  RGB-D mode paces by sleeping only
(no ring, no drops).  PIL decodes PNG frames and matplotlib draws the
plots; both are imported only where they are used.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import threading
import time
from pathlib import Path

import numpy as np

PNM = (".pgm", ".ppm", ".pnm")


def run_paced(slam, coord, seq, data_root: str, pace: float):
    """Realtime monocular replay through the native SPSC frame ring
    (reference cloud_edge_main.cpp:597-610: the replay clock never waits for
    the tracker; frames it cannot keep up with are lost).

    Producer: the C++ tum_start_replay thread when every frame is PGM/PPM
    (fully native decode and pace; the frame shape comes from the native
    reader), else a Python decode thread pacing into the same native ring.
    Consumer: this loop, popping whatever survived the drop-oldest policy.
    Raises when the native runtime cannot be built.  Returns (drops,
    n_tracked)."""
    from ..runtime import native

    if not native.available():
        raise RuntimeError(f"--pace needs the native runtime (g++): {native.build_log[-500:]}")
    all_pnm = all(p.lower().endswith(PNM) for p in seq._rgb_paths)
    nd = native.TumDataset(str(data_root)) if all_pnm else None
    try:
        if nd is not None:
            first = nd.read(0)
            if first is None:
                raise RuntimeError(f"cannot decode the first frame of {data_root}")
            H, W = first.shape
        else:
            H, W = np.shape(seq.frame(0)[0])
        q = native.FrameQueue(8, H, W)
    except BaseException:
        if nd is not None:
            nd.close()
        raise
    stop = threading.Event()
    producer = None
    if nd is not None:
        nd.start_replay(q, pace)

        def done():
            return nd.replay_done
    else:
        fin = threading.Event()

        def produce():
            start = time.perf_counter()
            tb = float(seq.times[0])
            try:
                for i in range(len(seq)):
                    if stop.is_set():
                        break
                    img, t = seq.frame(i)
                    lag = (t - tb) / pace - (time.perf_counter() - start)
                    if lag > 0:
                        time.sleep(lag)
                    q.push(t, img)
            finally:
                fin.set()

        producer = threading.Thread(target=produce, daemon=True)
        producer.start()
        done = fin.is_set

    n_tracked = 0
    try:
        while True:
            item = q.pop()
            if item is None:
                if done() and len(q) == 0:
                    break
                time.sleep(0.001)
                continue
            t, img = item
            slam.track_monocular(img, t)
            n_tracked += 1
            if coord is not None:
                coord.maybe_ruminate()
        return int(q.dropped), n_tracked
    finally:
        stop.set()
        if producer is not None:
            producer.join(timeout=10)
        if nd is not None:
            nd.close()
        q.close()


def groundtruth_poses(seq):
    """(times, world->camera poses [N, 7]) from the sequence's TUM
    groundtruth (rows camera-to-world: tx ty tz qx qy qz qw), or None when
    the sequence has none."""
    import torch

    from ..geometry import lie

    try:
        gt_times, gt_xyz, gt_quat = seq.groundtruth()
    except OSError:
        return None
    if gt_quat is None:
        return None
    Twc = np.concatenate([gt_quat[:, 3:4], gt_quat[:, 0:3], gt_xyz], axis=1).astype(np.float32)
    return gt_times, lie.se3_inverse(torch.from_numpy(Twc)).numpy()


def export(slam, coord, seq, out_dir, row: dict, *, plots: bool = True) -> dict:
    """Write the run's artifacts into ``out_dir``: ``whole_map.txt`` (the
    frame trajectory of the map), ``keyframes.txt``, ``result.csv`` (ATE and
    rate against the groundtruth when the sequence has one), and with
    ``plots`` ``traj.png`` and ``map.png``.  Returns the completed row."""
    from ..evaluation import ate as ate_mod
    from ..evaluation import harness
    from ..io import trajectory

    out_dir = Path(out_dir)
    times, poses = slam.trajectory_of_map()
    trajectory.save_tum(out_dir / "whole_map.txt", times, poses)
    kt, kp = slam.keyframe_trajectory()
    trajectory.save_tum(out_dir / "keyframes.txt", kt, kp)
    row = dict(row, n_kf=slam.stats["n_kf"])
    if coord is not None:
        row["upload_mb"] = sum(h.get("upload_mb", 0.0) for h in coord.history)
        row["upload_mb_raw"] = sum(h.get("upload_mb_raw", 0.0) for h in coord.history)
    gt = groundtruth_poses(seq)
    if gt is not None:
        m = ate_mod.evaluate_trajectory(times, poses, *gt)
        row.update(ate=m["ate"], rate=m["rate"], n_matched=m["n_matched"])
    harness.write_result_csv(row, out_dir / "result.csv")
    if plots:
        from ..evaluation import plot

        if gt is not None:
            plot.plot_trajectory(out_dir / "traj.png", times, poses, *gt)
        plot.plot_map(out_dir / "map.png", slam.ms)
    return row


def load_config(preset: str, rgbd: bool):
    """A settings preset name or YAML path; in RGB-D mode depth is read in
    metres (``TumSequence.frame_rgbd`` scales it) and a missing baseline
    defaults to 7.5 cm."""
    from ..io import settings

    cfg = (settings.load_settings(preset) if preset.endswith((".yaml", ".yml"))
           else settings.preset(preset))
    if rgbd:
        cfg = dataclasses.replace(cfg, camera=dataclasses.replace(
            cfg.camera, depth_factor=1.0, baseline=cfg.camera.baseline or 0.075))
    return cfg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", required=True, help="TUM sequence directory")
    ap.add_argument("--preset", default="tum3", help="settings preset or YAML path")
    ap.add_argument("--rgbd", action="store_true", help="use depth.txt for RGB-D tracking")
    ap.add_argument("--pace", type=float, default=0.0,
                    help="realtime pace factor (0 = offline)")
    ap.add_argument("--out", default="results")
    ap.add_argument("--no-rumination", action="store_true")
    ap.add_argument("--async-rumination", action="store_true",
                    help="build cloud submaps on the rumination shard, overlapped with "
                         "tracking (the last card when there are several)")
    ap.add_argument("--viewer", type=int, default=0, metavar="PORT",
                    help="serve the live map viewer on this port")
    ap.add_argument("--device", default="cuda", help="where the system runs (cuda or cpu)")
    args = ap.parse_args(argv)

    from ..io import datasets
    from ..rumination.coordinator import RuminationCoordinator
    from ..system import SlamSystem
    from ..utils.profiling import MemoryMonitor

    cfg = load_config(args.preset, args.rgbd)
    seq = datasets.TumSequence(args.data)
    out_dir = Path(args.out) / time.strftime("%Y%m%d_%H%M%S")
    out_dir.mkdir(parents=True, exist_ok=True)

    slam = SlamSystem(cfg, device=args.device)
    shard = None
    if args.async_rumination and not args.no_rumination:
        from ..rumination.remote import AsyncRuminationShard, pick_rumination_device

        shard = AsyncRuminationShard(cfg, device=pick_rumination_device() or args.device)
    coord = (None if args.no_rumination
             else RuminationCoordinator(slam, cfg, async_shard=shard))

    viewer = None
    if args.viewer:
        from ..evaluation.viewer import LiveViewer

        viewer = LiveViewer(slam, port=args.viewer).start()
        print(f"live viewer: http://localhost:{args.viewer}/")

    drops, n_tracked = 0, 0
    t0 = time.perf_counter()
    try:
        with MemoryMonitor() as mem:
            if args.pace > 0 and not args.rgbd:
                drops, n_tracked = run_paced(slam, coord, seq, args.data, args.pace)
            else:
                for i in range(len(seq)):
                    if args.rgbd:
                        img, depth, t = seq.frame_rgbd(i)
                        slam.track_rgbd(img, depth, t)
                    else:
                        img, t = seq.frame(i)
                        slam.track_monocular(img, t)
                    n_tracked += 1
                    if coord is not None:
                        coord.maybe_ruminate()
                    if args.pace > 0 and i + 1 < len(seq):
                        lag = (seq.times[i + 1] - seq.times[0]) / args.pace - (
                            time.perf_counter() - t0)
                        if lag > 0:
                            time.sleep(lag)
        runtime = time.perf_counter() - t0
        if shard is not None:
            # drain an in-flight cloud build before export (the reference waits
            # for CloudMerger idle at end of run, cloud_edge_main.cpp:613-617)
            deadline = time.perf_counter() + 120.0
            while shard.busy and time.perf_counter() < deadline:
                time.sleep(0.05)
            if coord is not None:
                coord.maybe_ruminate()
        slam.sync_mapping()
    finally:
        if viewer is not None:
            viewer.stop()
        if shard is not None:
            shard.shutdown()
        if slam.mapper is not None:
            slam.mapper.shutdown()

    row = export(slam, coord, seq, out_dir,
                 {"dataset": Path(args.data).name, "runtime_s": runtime,
                  "rss_mb": mem.peak_mb(), "drops": drops, "n_tracked": n_tracked})
    print(json.dumps(row))
    print("stage timings:\n" + slam.timer.report())
    print(f"results in {out_dir}")


if __name__ == "__main__":
    main()
