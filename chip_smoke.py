#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path, the per-frame monocular tracking step
(``rumi_slam_tpu_torch.step``), on the card at the full ``Config()`` size
(640x480, 8 pyramid levels, max_pt 16384) in five phases, each of which
raises on failure:

1. device: name, capability, versions, ``nvidia-smi`` name and power limit;
2. build: ``csrc/fused_match.cu`` with nvcc into ``build/``;
3. kernel = plain: the fused matcher kernel against its plain PyTorch
   version at F=2048 and F=1024 against P=16384 (2048 valid) and at a
   ragged F=1000, P=5000; idx identical, dist equal; times of both;
4. main path: ``build_step`` at 2048 and 1024 features over 32 distinct
   frames: pipelined frames/s, blocking p50/p95 latency, and the split
   between ORB extraction, matching and pose optimisation; the kernel's
   launch count must equal the frames stepped;
5. tracked sequence: a 30-frame synthetic drive from a map seeded by frame
   0's depth, tracked with a constant-velocity prediction; on every frame
   the kernel path on the card and the plain path on the CPU must agree,
   and the median inliers must reach the floor measured with the JAX
   package on the same drive.

Prints one JSON object per result line, the kernels' summary and the card's
``nvidia-smi`` name and power limit on lines before the last, and as the
last line ``{"ok": true, "device": {...}}``.  Exits non-zero, printing no
result, when no CUDA device is present or any phase fails.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

# The JAX package's median inliers per tracked frame on the phase-5 drive is
# 226 (CPU, `JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_slice_drive.py`; the port on
# the CPU gives the same 29 counts).  The floor is 90% of it: the card sums
# the pyramid and blur in another order, which can move the odd keypoint.
INLIER_FLOOR = 203
POSE_ATOL = 1e-4       # kernel path (card) vs plain path (CPU), as the CPU parity tests
TIMING_REPS = 30


def emit(**kw):
    print(json.dumps(kw), flush=True)


def cuda_time_ms(fn, reps=TIMING_REPS, warmup=3):
    """Median device time of ``fn()`` in ms, CUDA events around each call."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    emit(phase="device", name=torch.cuda.get_device_name(0),
         capability=list(torch.cuda.get_device_capability(0)), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0], nvidia_smi=smi,
         count=torch.cuda.device_count())
    return smi


def phase_build():
    from rumi_slam_tpu_torch.ops import fused_matcher

    t0 = time.perf_counter()
    fused_matcher.build_library()
    emit(phase="build", seconds=round(time.perf_counter() - t0, 3),
         nvcc_log=fused_matcher.build_log.strip().splitlines()[-4:])


def matcher_problem(F, P, n_valid, seed, device):
    """Seeded inputs: about 100 query descriptors copied into points, half
    of those within 20 px of their query; 10% invalid queries; points past
    ``n_valid`` invalid, as in the bench map."""
    import torch

    rng = np.random.default_rng(seed)
    dq = rng.integers(0, 2**32, (F, 8), dtype=np.uint32)
    dp = rng.integers(0, 2**32, (P, 8), dtype=np.uint32)
    rows = rng.choice(n_valid, 100, replace=False)
    qrows = rng.choice(F, 100, replace=False)
    dp[rows] = dq[qrows]
    uv_q = rng.uniform([0, 0], [640, 480], (F, 2)).astype(np.float32)
    uv_p = rng.uniform([0, 0], [640, 480], (P, 2)).astype(np.float32)
    uv_p[rows[:50]] = uv_q[qrows[:50]] + rng.uniform(-10, 10, (50, 2))
    valid_q = rng.random(F) > 0.1
    valid_p = np.arange(P) < n_valid
    return [torch.from_numpy(a).to(device) for a in
            (dq.view(np.int32), dp.view(np.int32), uv_q, uv_p, valid_q, valid_p)]


def phase_kernel():
    from rumi_slam_tpu_torch.ops import fused_matcher as fm

    radius = 15.0
    results = []
    for F, P, n_valid in ((2048, 16384, 2048), (1024, 16384, 2048), (1000, 5000, 4500)):
        args = matcher_problem(F, P, n_valid, seed=F + P, device="cuda")
        launches = fm.fused_match.launches
        idx_k, dist_k = fm.fused_match(*args[:4], radius, *args[4:])
        idx_p, dist_p = fm.fused_match_plain(*args[:4], radius, *args[4:])
        if fm.fused_match.launches != launches + 1:
            raise RuntimeError("fused_match did not launch its kernel")
        m = idx_p >= 0
        n_match = int(m.sum())
        if not bool((idx_k == idx_p).all()) or n_match == 0:
            raise RuntimeError(f"kernel idx differs from plain at F={F} P={P} "
                               f"({int((idx_k != idx_p).sum())} rows; {n_match} matches)")
        if not bool((dist_k[m] == dist_p[m]).all()) or not bool(dist_k[~m].isinf().all()):
            raise RuntimeError(f"kernel dist differs from plain at F={F} P={P}")
        err = float((dist_k[m] - dist_p[m]).abs().max())
        # alternate plain and kernel, both at the same inputs
        t_p1 = cuda_time_ms(lambda: fm.fused_match_plain(*args[:4], radius, *args[4:]))
        t_k1 = cuda_time_ms(lambda: fm.fused_match(*args[:4], radius, *args[4:]))
        t_k2 = cuda_time_ms(lambda: fm.fused_match(*args[:4], radius, *args[4:]))
        t_p2 = cuda_time_ms(lambda: fm.fused_match_plain(*args[:4], radius, *args[4:]))
        r = dict(F=F, P=P, valid_points=n_valid, matches=n_match, idx_equal=True,
                 max_abs_err=err, kernel_ms=min(t_k1, t_k2), plain_ms=min(t_p1, t_p2),
                 kernel_ms_runs=[t_k1, t_k2], plain_ms_runs=[t_p1, t_p2])
        emit(phase="kernel", **r)
        results.append(r)
    return results


def phase_main_path():
    import torch

    from rumi_slam_tpu_torch import step as S
    from rumi_slam_tpu_torch.ops import fused_matcher as fm
    from rumi_slam_tpu_torch.optim import pose_opt
    from rumi_slam_tpu_torch.tracking import tracker

    out = {}
    for nf in (2048, 1024):
        step, frames, ms, pose = S.build_step(n_features=nf, device="cuda", n_frames=32)
        c = step.cfg.camera
        n = len(frames)
        step(frames[0], ms, pose)                         # warm-up
        torch.cuda.synchronize()

        # stage split: each stage timed alone on the same 32 frames
        feats = [step.extractor(f) for f in frames]
        t_ext = cuda_time_ms(lambda: [step.extractor(f) for f in frames], reps=5, warmup=1) / n
        m_out = [tracker.match_projected(ms, step.K, f, pose, step.cfg.tracking.match_radius,
                                         img_w=c.width, img_h=c.height) for f in feats]
        t_match = cuda_time_ms(lambda: [tracker.match_projected(
            ms, step.K, f, pose, step.cfg.tracking.match_radius, img_w=c.width,
            img_h=c.height) for f in feats], reps=5, warmup=1) / n
        po_in = [(ms.pt_xyz[idx.clamp_min(0).long()], f.uv, idx >= 0)
                 for (idx, _), f in zip(m_out, feats)]
        t_po = cuda_time_ms(lambda: [pose_opt.pose_optimization(
            step.K, pose, X, uv, ok, n_rounds=3, n_iters=6) for X, uv, ok in po_in],
            reps=5, warmup=1) / n

        # the main path itself: the launch counter starts at 0 here
        fm.fused_match.launches = 0
        t0 = time.perf_counter()
        outs = [step(frames[i % n], ms, pose) for i in range(2 * n)]
        torch.cuda.synchronize()
        fps = 2 * n / (time.perf_counter() - t0)
        lat = []
        for i in range(2 * n):
            t0 = time.perf_counter()
            step(frames[i % n], ms, pose)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
        stepped = 4 * n
        launches = fm.fused_match.launches
        if launches != stepped:
            raise RuntimeError(f"{launches} kernel launches for {stepped} frames stepped")
        inl = [int(k) for _, k in outs]
        for p, _ in outs:
            if not bool(torch.isfinite(p).all()):
                raise RuntimeError("non-finite pose from the step")
        r = dict(n_features=nf, frames_stepped=stepped, launches=launches,
                 pipelined_fps=fps, latency_p50_ms=float(np.percentile(lat, 50)),
                 latency_p95_ms=float(np.percentile(lat, 95)),
                 stage_ms={"orb_extraction": t_ext, "match": t_match, "pose_optimization": t_po},
                 mean_n_inliers=float(np.mean(inl)))
        emit(phase="main_path", **r)
        out[nf] = r
    return out


def phase_tracked_sequence():
    import torch

    from rumi_slam_tpu_torch import step as S
    from rumi_slam_tpu_torch.config import Config
    from rumi_slam_tpu_torch.io.synthetic import SyntheticSequence
    from rumi_slam_tpu_torch.mapstate import map_state as M
    from rumi_slam_tpu_torch.ops import fused_matcher as fm
    from rumi_slam_tpu_torch.ops.orb import Features
    from rumi_slam_tpu_torch.tracking import tracker

    cfg = Config()
    c = cfg.camera
    n_frames = 30
    seq = SyntheticSequence(n_frames=n_frames, width=c.width, height=c.height, seed=7,
                            device="cuda")
    step = S.TrackingStep(cfg, seq.K).to("cuda")
    img0, depth0, _ = seq.frame_rgbd(0)
    ms = S.seed_map_from_depth(step.extractor(img0), depth0, seq.K, seq.poses_gt[0], cfg)
    ms_cpu = M.MapState(*(x.cpu() for x in ms))
    K_cpu = seq.K.cpu()
    poses = [seq.poses_gt[0]]
    inliers, errors = [], []
    launches = fm.fused_match.launches
    for i in range(1, n_frames):
        pred = poses[0] if i == 1 else S.constant_velocity(poses[-1], poses[-2])
        img, _ = seq.frame(i)
        feats = step.extractor(img)
        ms, tr = tracker.track_frame(ms, seq.K, feats, pred, cfg.tracking.match_radius,
                                     img_w=c.width, img_h=c.height)
        ms_cpu, tr_c = tracker.track_frame(ms_cpu, K_cpu, Features(*(x.cpu() for x in feats)),
                                           pred.cpu(), cfg.tracking.match_radius,
                                           img_w=c.width, img_h=c.height)
        diff = torch.nonzero(tr.assoc.cpu() != tr_c.assoc).flatten().tolist()
        if diff or int(tr.n_inliers) != int(tr_c.n_inliers):
            raise RuntimeError(f"frame {i}: kernel path and plain path differ in assoc rows "
                               f"{diff[:20]} (inliers {int(tr.n_inliers)} vs {int(tr_c.n_inliers)})")
        dpose = float((tr.pose.cpu() - tr_c.pose).abs().max())
        if dpose > POSE_ATOL:
            raise RuntimeError(f"frame {i}: pose differs by {dpose} between kernel and plain path")
        poses.append(tr.pose)
        err = float((S.camera_center(tr.pose) - S.camera_center(seq.poses_gt[i])).norm())
        inliers.append(int(tr.n_inliers))
        errors.append(err)
        emit(phase="tracked_frame", frame=i, n_inliers=int(tr.n_inliers),
             center_error_m=err, pose_diff_kernel_vs_plain=dpose)
    if fm.fused_match.launches - launches != n_frames - 1:
        raise RuntimeError("the tracked drive did not launch the kernel once per frame")
    med = float(np.median(inliers))
    emit(phase="tracked_sequence", frames=n_frames - 1, median_n_inliers=med,
         inlier_floor=INLIER_FLOOR, max_center_error_m=max(errors))
    if med < INLIER_FLOOR:
        raise RuntimeError(f"median inliers {med} below the floor {INLIER_FLOOR}")
    return med


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import rumi_slam_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    smi = phase_device()
    phase_build()
    kern = phase_kernel()
    main_path = phase_main_path()
    phase_tracked_sequence()

    bench = kern[0]
    emit(kernels=[{
        "name": "fused_match",
        "route": "cuda",
        "source": "rumi_slam_tpu_torch/csrc/fused_match.cu",
        "replaces": "rumi_slam_tpu/ops/pallas_matcher.py:35",
        "launches": sum(r["launches"] for r in main_path.values()),
        "max_abs_err": max(r["max_abs_err"] for r in kern),
        "ms": bench["kernel_ms"],
        "plain_ms": bench["plain_ms"],
    }])
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
