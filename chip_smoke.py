#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths on the card at the full ``Config()`` size
(640x480, 8 pyramid levels, 1024 features, max_kf 256, max_pt 16384): the
per-frame monocular tracking step (``rumi_slam_tpu_torch.step``) and the
monocular SLAM facade (``rumi_slam_tpu_torch.system.SlamSystem``) with loop
closing, checkpoints and the rumination pipeline
(``rumi_slam_tpu_torch.rumination``), the facade's RGB-D and stereo input,
and the evaluation harness, native edge runtime and inertial solvers around
it, in twelve phases, each of which raises on failure:

1. device: name, capability, versions, ``nvidia-smi`` name and power limit;
2. build: ``csrc/fused_match.cu`` with nvcc into ``build/``;
3. kernel = plain: both instantiations of the fused matcher kernel against
   their plain PyTorch versions, idx identical and dist equal, with the times
   of both, the split of the device time between the partial and the merge
   kernel, and the card's bound for the same work.  Gated (``fused_match``
   against ``fused_match_plain``): F=2048 and F=1024 against P=16384 (2048
   valid), a ragged F=1000, P=5000, F=1024 x P=16384 all valid with
   clustered pixels so that many pairs pass the gate, and a shape with equal
   descriptors in different splits and points exactly on the radius.
   Gate-off (``match_bank`` against ``matcher.match_chunked``, 16 chunks):
   F=1024 against a bank of 262144 rows with 21 x 1024 valid and with every
   row valid, and a ragged F=1000 x 50000;
4. main path: ``build_step`` at 2048 and 1024 features over 16 distinct
   frames: pipelined frames/s, blocking p50/p95 latency, and the split
   between ORB extraction, matching and pose optimisation; the kernel's
   launch count must equal the frames stepped;
5. tracked sequence: a 20-frame synthetic drive from a map seeded by frame
   0's depth, tracked with a constant-velocity prediction; on every frame
   the kernel path on the card and the plain path on the CPU must agree,
   and the median inliers must reach the floor measured with the JAX
   package on the same drive;
6. SLAM drive: ``SlamSystem.track_monocular`` over 60 frames of
   ``SyntheticSequence(seed=4)`` rendered on the card with
   ``K = cfg.intrinsics()``, loop closing off, synchronous mapping: the
   state of each frame, the stats, the per-stage ``StageTimer`` times, the
   kernel's launches and the ATE; the OK share and the ATE must meet the
   bounds from the JAX package's run of the same drive, and the kernel must
   launch at least once per frame tracked in the OK state (the ``track``
   stage; the initialising frame returns OK without being tracked);
7. overlapped mapping: ``tiny_config()`` with the mapping worker thread over
   the 45-frame verify drive (seed 4, patch 3, 320x240): at least one worker
   result adopted, no worker error, OK share > 0.6, ATE < 0.15 m;
8. relocalisation drive: ``SlamSystem`` as in phase 6 over 80 frames of the
   same sequence with a span of featureless frames inside the relocalisation
   window (``RELOC_SPAN``): tracking is lost on the span's first frame and
   the first frame after it runs ``tracker.relocalize_map``, whose match
   against all 256 x 1024 stored observations is the gate-off kernel.  The
   kernel must launch, the system must relocalise (``n_reloc >= 1``, OK again
   within 5 frames of the span's end, no new submap), the OK share and the
   ATE must meet the bounds from the JAX package's run of the same drive, and
   on the frame that relocalises ``relocalize_map`` runs twice more on CPU
   copies of the map and the features with the same RANSAC draws: given the
   6-point pose hypotheses the card solved it must return the same ``assoc``;
   solving them itself it must get the same matcher output bit for bit and,
   where it reaches the inlier gate too, nearly the same pose
   (``RELOC_POSE_ATOL``) with no feature associated with a different point;
9. known answers at full width, each also on CPU copies of the same inputs:
   ``save_map`` -> ``load_map`` of phase 6's map on the card (every field
   equal, digest stable, a flipped payload byte raises); a 256-vertex pose
   graph with 2048 edge slots, a drifted far end and one loop edge (drift
   removed, card within 1e-3 of the CPU); ``verify_loop`` on two keyframes
   holding one frame's 1024 ORB features with the candidate's points moved
   by a known Sim(3) (scale within 0.02, inliers above the loop gate, the
   256 batched 4x4 eigen solves against the CPU's on the same triples);
   ``close_loop`` and the global BA on phase 6's map (finite, the candidate
   held, the reprojection cost not higher); and the merge of that map's own
   copy, moved by a known Sim(3) and brought back as a second submap (``ok``,
   scale within 0.02, no keyframe left in the copy, fewer valid points,
   paired poses within 0.05); and the backend's weld of the same map split in
   two by time, the later half moved by a known Sim(3)
   (``RuminationBackend._weld_submaps``: one ``relocalize_map``, so one
   gate-off launch, per source keyframe tried; scale within
   ``WELD_SCALE_TOL``, every moved keyframe back within ``WELD_POSE_TOL``);
10. rumination end to end: a 110-frame sweep with six featureless frames and
    a 0.1 s relocalisation window, loop closing on: tracking is lost, a second
    submap opens, the coordinator assembles the bundle, a backend builds the
    back submap, and the double merge plus a dense global BA leave one map.
    Four runs: the clear-view backend inline (bundle images swapped for
    clean renderings before the package's ``build()``), the same through
    ``AsyncRuminationShard`` (``last_error`` must stay None), the shard again
    with the live system's local mapping on its worker thread (``Config()``'s
    own setting; its result depends on the threads' timing: it must merge
    into one finite map across the gap, keep the JAX package's keyframe
    counts in the same setting less ``OVL_KF_SLACK`` and meet
    ``OVL_ATE_MAX_M``),
    and the package's own backend, which must fail as it does in the JAX package
    (the synthetic loss is a flat image).  The states up to the new submap,
    the OK share and the keyframe ATE are held to the JAX package's run of
    the same drive; the gated kernel must launch at least once per frame
    tracked in OK by the live and the offline system, the gate-off kernel
    once per ``relocalize_map`` call;
11. depth modes at full width (``DEPTH_RUNS``; phase 6's configuration with an
    8 cm baseline, ``tests/torch_system_drive.py::drive``): (a)
    ``track_rgbd`` and (b) ``track_stereo`` over phase 6's 60 frames, (c)
    ``track_rgbd`` over 70 frames with frames 40-45 featureless and a 0.1 s
    relocalisation window, where the system gives the map up, opens submap 1
    and initialises it from depth on the first textured frame.  Each run: the
    states, keyframes and maps, the ATE with and without scale, the time per
    stage and the launches; held to the JAX package's OK share and ATE
    without scale, to metric scale, to a gated launch per frame tracked in
    OK, and (c) to JAX's new-submap frame give or take one; (b) also times
    ``match_stereo`` at 1024 x 1024.  Then the camera models on the card:
    ``_extract`` under TUM1's radtan camera and a KB8 camera against the
    CPU's on the rows whose raw keypoint is the same on both, and
    ``undistort_points`` / ``kb8.unproject`` on 1024 seeded points;
12. the harness, the runtime and the inertial solvers (``phase_harness``;
    PIL and matplotlib stay off this path): (a) phase 6's 60 frames written
    as 8-bit PGM in TUM layout with a settings YAML, replayed by
    ``examples/run_tum.run_paced`` through the native TUM reader and frame
    ring (built with g++ into ``build/``) at twice phase 6's measured time a
    frame, then the driver's export: every frame tracked or counted as
    dropped, phase 6's OK share and ATE over the tracked frames,
    ``result.csv`` with ``RESULT_COLUMNS``, a gated launch per frame tracked
    in OK; (a') the first 30 frames at real time, which the tracker cannot
    keep up with: frames must drop and be counted; (b) ``harness.run_once``
    over ``tests/torch_harness_drive.py``'s 60-frame ``GroundtruthSequence``
    at full width with rumination on, held to the JAX package's row, with
    ``rss_mb`` from the native runtime; (c) ``tests/torch_inertial_window.py``'s
    visual-inertial window (10 keyframes, 9 x 50 IMU samples, 2000 points
    with 8 observations each, 1024 points for the pose solve): preintegration
    and the three solvers on the card and on the CPU, which must agree, with
    the costs not rising, and the card's time of one call of each.

``python3 chip_smoke.py --sweep-blocks-per-sm`` runs phases 1-2 and then
times both instantiations with the grid planned for 2 to 64 blocks an SM
(the readings behind ``fused_matcher.BLOCKS_PER_SM``), and stops.

Prints one JSON object per result line, the kernels' summary and the card's
``nvidia-smi`` name and power limit on lines before the last, and as the
last line ``{"ok": true, "device": {...}}``.  Exits non-zero, printing no
result, when no CUDA device is present or any phase fails.
"""

from __future__ import annotations

import json
import os
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
# relocalize_map on the card vs on the CPU with the same draws: the matcher's
# output must be equal bit for bit, and so the candidate matches.  Behind it
# PnP solves each 6-point hypothesis with a float32 eigen decomposition
# (``pnp._dlt_pose``) that differs in the last digits between the card's
# solver and the CPU's, and keeps the consensus set of the best raw
# hypothesis, a noisy subset of the true matches under a tight pixel gate.
# That this is the only cause is shown by handing the card's hypotheses to
# the CPU run: from there on ``assoc`` must be identical and the pose within
# POSE_ATOL.  With its own solves the CPU run came out, on an H100, at 132,
# 159, 155 and 53 inliers against the card's 154, 125, 130 and 59 of about
# 380 candidates, sharing 132, 90, 91 and none, with poses 4.5e-4 to 3.8e-3
# apart: two disjoint consensus sets still give one pose, so no shared share
# is required (it is printed).  It is held to: recovery, no feature
# associated with two different points, and a pose within RELOC_POSE_ATOL
# (2.7 x the largest gap seen).
RELOC_POSE_ATOL = 1e-2
TIMING_REPS = 30

# The JAX package on the phase-6 drive (CPU, `JAX_PLATFORMS=cpu PYTHONPATH=.
# python tests/torch_system_drive.py`): 59 of 60 frames OK, 21 keyframes,
# frame-trajectory ATE 0.005328 m.  Phase 6 holds the port to an OK share of
# at least this less 0.05 and an ATE of at most 1.5 x this + 0.01 m.
JAX_DRIVE_OK_SHARE = 59 / 60
JAX_DRIVE_ATE_M = 0.005328

# The phase-8 drive: RELOC_FRAMES frames, those of RELOC_SPAN featureless.
# The JAX package on it (CPU, `JAX_PLATFORMS=cpu PYTHONPATH=. python
# tests/torch_system_drive.py --frames 80 --lost-span 20 22`): 77 of 80
# frames OK, 1 relocalisation on frame 22, 27 keyframes, ATE 0.005767 m.
# Phase 8 holds the port to the same margins as phase 6.  A span of ten
# frames, or one later in the drive, is not used: the JAX package itself then
# stays RECENTLY_LOST to the end of the drive.
RELOC_FRAMES = 80
RELOC_SPAN = (20, 22)
JAX_RELOC_OK_SHARE = 77 / 80
JAX_RELOC_ATE_M = 0.005767

# Peak rates of one H100 SXM for the kernels' bounds (NVIDIA's data sheet):
# 67 TFLOP/s float32 outside the tensor cores is 33.5e12 lane instructions a
# second (an FMA counts as two operations; the gate uses none), 128 lanes a
# clock on each of 132 SMs.  __popc runs on 16 lanes a clock an SM (NVIDIA's
# table of arithmetic instruction throughput, compute capability 9.0), an
# eighth of that.
PEAK_FP32_LANE_PER_S = 33.5e12
PEAK_POPC_PER_S = PEAK_FP32_LANE_PER_S / 8
# The TPU kernel computed the Hamming distance as a product of +-1 vectors on
# the matrix unit.  The same product in int8 on this card's tensor cores (1979
# TOP/s dense) bounds the gate-off mode far lower than the popcount pipe does;
# the kernel does not use them, and ``bound_ms_tensor`` says what that costs.
PEAK_INT8_TENSOR_PER_S = 1.979e15
PEAK_BYTES_PER_S = 3.35e12


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


GRAPH_CALLS = 20


def cuda_graph_ms(fn, reps=TIMING_REPS):
    """Device time of one ``fn()`` in ms with no host in between:
    ``GRAPH_CALLS`` calls captured into one CUDA graph, the median over
    ``reps`` replays, divided by the calls.  ``cuda_time_ms`` around a single
    call cannot go below the host time of the call."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_CALLS):
            fn()
    return cuda_time_ms(graph.replay, reps=reps) / GRAPH_CALLS


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
    # per kernel: registers, spills and shared memory, as ptxas reports them
    log = [ln.strip() for ln in fused_matcher.build_log.splitlines()
           if "Compiling entry" in ln or "spill" in ln or "Used" in ln]
    emit(phase="build", seconds=round(time.perf_counter() - t0, 3), nvcc_log=log)


def matcher_problem(F, P, n_valid, seed, device, cluster_px=None, ties=False):
    """Seeded inputs: about 100 query descriptors copied into points, half
    of those within 20 px of their query; 10% invalid queries; points past
    ``n_valid`` invalid, as in the bench map.  ``cluster_px``: every pixel
    inside a square of that side, so that many pairs pass the gate.
    ``ties``: 64 more queries get their descriptor, one bit flipped, at two
    or three points a quarter of the points apart (different splits of the
    kernel's grid), at the query's pixel, and 64 more get a copy at a point
    exactly 15 px away (offset 9, 12)."""
    import torch

    rng = np.random.default_rng(seed)
    dq = rng.integers(0, 2**32, (F, 8), dtype=np.uint32)
    dp = rng.integers(0, 2**32, (P, 8), dtype=np.uint32)
    rows = rng.choice(n_valid, 100, replace=False)
    qrows = rng.choice(F, 100, replace=False)
    dp[rows] = dq[qrows]
    hi = [cluster_px, cluster_px] if cluster_px else [640, 480]
    uv_q = rng.uniform([0, 0], hi, (F, 2)).astype(np.float32)
    uv_p = rng.uniform([0, 0], hi, (P, 2)).astype(np.float32)
    uv_p[rows[:50]] = uv_q[qrows[:50]] + rng.uniform(-10, 10, (50, 2))
    valid_q = rng.random(F) > 0.1
    valid_p = np.arange(P) < n_valid
    if ties:
        q = rng.choice(F, 128, replace=False)
        valid_q[q] = True
        uv_q[q] = np.round(uv_q[q])           # integer pixels: the offsets below are exact
        base = rng.choice(n_valid // 4, 128, replace=False)
        for k in range(3):
            at = base[:64] + k * (n_valid // 4)
            at = at[: 64 if k < 2 else 32]    # half of the ties are threefold
            dp[at] = dq[q[: len(at)]] ^ np.uint32(1)
            uv_p[at] = uv_q[q[: len(at)]]
        at = base[64:] + 3 * (n_valid // 4)
        dp[at] = dq[q[64:]]
        uv_p[at] = uv_q[q[64:]] + np.float32([9.0, 12.0])
    return [torch.from_numpy(a).to(device) for a in
            (dq.view(np.int32), dp.view(np.int32), uv_q, uv_p, valid_q, valid_p)]


def bank_problem(Na, Nb, n_valid, seed, device):
    """Seeded query and bank descriptors; the bank's first ``n_valid`` rows
    valid, as the observation bank's keyframes fill from the front, less a
    random third (features without a map point); 200 bank rows copy a query,
    a third of them twice (ties) and a third with a one-bit neighbour."""
    import torch

    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2**32, (Na, 8), dtype=np.uint32)
    b = rng.integers(0, 2**32, (Nb, 8), dtype=np.uint32)
    rows = rng.choice(n_valid, 400, replace=False)
    qrows = rng.choice(Na, 200, replace=False)
    b[rows[:200]] = a[qrows]
    b[rows[200:266]] = a[qrows[:66]]
    b[rows[266:332]] = a[qrows[-66:]] ^ np.uint32(1)
    valid_a = rng.random(Na) > 0.1
    valid_b = (np.arange(Nb) < n_valid) & ((rng.random(Nb) > 1 / 3) | (n_valid == Nb))
    return [torch.from_numpy(x).to(device) for x in
            (a.view(np.int32), valid_a, b.view(np.int32), valid_b)]


def bound_ms(n_fp32_lane, n_popc, n_bytes):
    """The least time the card could take: the larger of the operations over
    their peak rate (the float32 and the popcount pipes run side by side) and
    the bytes over the memory rate.  Returns (ms, which bounds it)."""
    ops = max(n_fp32_lane / PEAK_FP32_LANE_PER_S, n_popc / PEAK_POPC_PER_S)
    byts = n_bytes / PEAK_BYTES_PER_S
    return 1e3 * max(ops, byts), "operations" if ops >= byts else "bytes"


def tiles_skipped(valid_p):
    """(point tiles the kernel skips because none of their points is valid,
    point tiles in all)."""
    import torch

    from rumi_slam_tpu_torch.ops.fused_matcher import POINTS_PER_TILE as T

    n = valid_p.shape[0]
    pad = torch.zeros(-n % T, dtype=torch.bool, device=valid_p.device)
    tiles = torch.cat([valid_p, pad]).reshape(-1, T).any(dim=1)
    return int((~tiles).sum()), int(tiles.numel())


def kernel_split_us(fn, calls=20):
    """Mean device time in us of the partial and of the merge kernel in one
    ``fn()``, from ``torch.profiler`` over ``calls`` calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    sums = {"partial": 0.0, "merge": 0.0}
    for e in prof.events():
        for k in sums:
            if e.device_type == DeviceType.CUDA and f"match_{k}_kernel" in e.name:
                sums[k] += e.time_range.end - e.time_range.start
    if not all(sums.values()):
        raise RuntimeError(f"the profiler saw no partial or no merge kernel: {sums}")
    return {k: v / calls for k, v in sums.items()}


def compare_and_time(name, shape, kernel, plain, counter):
    """Hold ``kernel()`` against ``plain()`` (idx identical, dist equal on
    matched rows and inf elsewhere), then time both in turns: CUDA events
    around single calls (``kernel_ms``, ``plain_ms``: what a caller of the
    wrapper waits, host time included) and replayed from a CUDA graph
    (``*_graph_ms``: the device's time alone), and split the kernel's device
    time between its two kernels."""
    import torch

    launches = counter.launches
    idx_k, dist_k = kernel()
    torch.cuda.synchronize()
    if counter.launches != launches + 1:
        raise RuntimeError(f"{name} did not launch its kernel")
    idx_p, dist_p = plain()
    m = idx_p >= 0
    n_match = int(m.sum())
    if not bool((idx_k == idx_p).all()) or n_match == 0:
        raise RuntimeError(f"{name}: kernel idx differs from plain at {shape} "
                           f"({int((idx_k != idx_p).sum())} rows; {n_match} matches)")
    if not bool((dist_k[m] == dist_p[m]).all()) or not bool(dist_k[~m].isinf().all()):
        raise RuntimeError(f"{name}: kernel dist differs from plain at {shape}")
    err = float((dist_k[m] - dist_p[m]).abs().max())
    # alternate plain and kernel, both at the same inputs
    t_p1, t_k1 = cuda_time_ms(plain), cuda_time_ms(kernel)
    t_k2, t_p2 = cuda_time_ms(kernel), cuda_time_ms(plain)
    # the same two turns with the host out of the way; the capture launches
    # the kernel GRAPH_CALLS times, which the caller's count must not see
    launches = counter.launches
    t_pg1, t_kg1 = cuda_graph_ms(plain), cuda_graph_ms(kernel)
    t_kg2, t_pg2 = cuda_graph_ms(kernel), cuda_graph_ms(plain)
    split = kernel_split_us(kernel)
    counter.launches = launches
    return dict(matches=n_match, idx_equal=True, max_abs_err=err,
                kernel_ms=min(t_k1, t_k2), plain_ms=min(t_p1, t_p2),
                kernel_ms_runs=[t_k1, t_k2], plain_ms_runs=[t_p1, t_p2],
                kernel_graph_ms=min(t_kg1, t_kg2), plain_graph_ms=min(t_pg1, t_pg2),
                kernel_graph_ms_runs=[t_kg1, t_kg2], plain_graph_ms_runs=[t_pg1, t_pg2],
                partial_kernel_us=split["partial"], merge_kernel_us=split["merge"])


def phase_kernel():
    """Returns (gated results, gate-off results), one dict per shape."""
    import torch

    from rumi_slam_tpu_torch.ops import fused_matcher as fm
    from rumi_slam_tpu_torch.ops import matcher

    radius = 15.0
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    gated = []
    for F, P, n_valid, kw in ((2048, 16384, 2048, {}), (1024, 16384, 2048, {}),
                              (1000, 5000, 4500, {}),
                              (1024, 16384, 16384, dict(cluster_px=160.0)),
                              (1024, 16384, 16384, dict(ties=True))):
        args = matcher_problem(F, P, n_valid, seed=F + P + len(kw), device="cuda", **kw)
        dq, dp, uv_q, uv_p, vq, vp = args
        r = compare_and_time(
            "fused_match", f"F={F} P={P}",
            lambda: fm.fused_match(*args[:4], radius, *args[4:]),
            lambda: fm.fused_match_plain(*args[:4], radius, *args[4:]), fm.fused_match)
        if kw.get("ties"):
            # ratio above 1 lets a tie through, so that its index is compared
            for ratio in (0.9, 1.01):
                i_k, d_k = fm.fused_match(*args[:4], radius, *args[4:], ratio=ratio)
                i_p, d_p = fm.fused_match_plain(*args[:4], radius, *args[4:], ratio=ratio)
                if not (torch.equal(i_k, i_p) and torch.equal(d_k, d_p)):
                    i_s, _ = fm.fused_match_plain_split(
                        *args[:4], radius, *args[4:], ratio=ratio,
                        n_splits=fm.split_plan(F, P, n_sm)[0])
                    raise RuntimeError(
                        f"ties: kernel differs from plain in {int((i_k != i_p).sum())} rows at "
                        f"ratio {ratio}; the plain split model differs from plain in "
                        f"{int((i_s != i_p).sum())}")
            r["tie_matches_at_ratio_1.01"] = int((i_k >= 0).sum())
        n_pairs = int(vq.sum()) * int(vp.sum())
        n_pass = int((matcher.radius_mask(uv_q, uv_p, radius) & vq[:, None] & vp[None, :]).sum())
        b_ms, b_by = bound_ms(6 * n_pairs, 8 * n_pass, 41 * (F + P) + 8 * F)
        skipped, tiles = tiles_skipped(vp)
        r = dict(kernel="fused_match", F=F, P=P, valid_points=n_valid, **kw, **r,
                 valid_pairs=n_pairs, pairs_in_gate=n_pass, bound_ms=b_ms, bound_by=b_by,
                 grid=[-(-F // fm.QUERIES_PER_BLOCK), fm.split_plan(F, P, n_sm)[0]],
                 tiles_skipped=skipped, tiles=tiles)
        emit(phase="kernel", **r)
        gated.append(r)

    bank = []
    for Na, Nb, n_valid in ((1024, 262144, 21 * 1024), (1024, 262144, 262144),
                            (1000, 50000, 50000)):
        a, va, b, vb = bank_problem(Na, Nb, n_valid, seed=Na + n_valid, device="cuda")
        kw = dict(max_dist=80.0, ratio=0.9)
        r = compare_and_time(
            "match_bank", f"Na={Na} Nb={Nb} ({n_valid} rows in use)",
            lambda: fm.match_bank(a, va, b, vb, n_chunks=16, **kw),
            lambda: matcher.match_chunked(a, va, b, vb, n_chunks=16, **kw), fm.match_bank)
        n_pairs = int(va.sum()) * int(vb.sum())
        b_ms, b_by = bound_ms(0, 8 * n_pairs, 33 * (Na + Nb) + 8 * Na)
        # the same distances as a 256-long int8 product on the tensor cores
        b_tensor = 1e3 * max(2 * 256 * n_pairs / PEAK_INT8_TENSOR_PER_S,
                             (33 * (Na + Nb) + 8 * Na) / PEAK_BYTES_PER_S)
        skipped, tiles = tiles_skipped(vb)
        r = dict(kernel="match_bank", F=Na, P=Nb, valid_points=int(vb.sum()), **r,
                 valid_pairs=n_pairs, bound_ms=b_ms, bound_by=b_by, bound_ms_tensor=b_tensor,
                 grid=[-(-Na // fm.QUERIES_PER_BLOCK), fm.split_plan(Na, Nb, n_sm)[0]],
                 tiles_skipped=skipped, tiles=tiles)
        emit(phase="kernel", **r)
        bank.append(r)
    return gated, bank


def phase_main_path():
    import torch

    from rumi_slam_tpu_torch import step as S
    from rumi_slam_tpu_torch.ops import fused_matcher as fm
    from rumi_slam_tpu_torch.optim import pose_opt
    from rumi_slam_tpu_torch.tracking import tracker

    out = {}
    for nf in (2048, 1024):
        step, frames, ms, pose = S.build_step(n_features=nf, device="cuda", n_frames=16)
        c = step.cfg.camera
        n = len(frames)
        step(frames[0], ms, pose)                         # warm-up
        torch.cuda.synchronize()

        # stage split: each stage timed alone on the same 16 frames
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
        fm.match_bank.launches = 0
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
                 launches_match_bank=fm.match_bank.launches,
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
    n_frames = 20
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


def slam_drive(cfg, seq, device):
    """``SlamSystem.track_monocular`` over ``seq``: (system, states, ATE)."""
    import torch

    from rumi_slam_tpu_torch.evaluation import ate
    from rumi_slam_tpu_torch.system import SlamSystem

    slam = SlamSystem(cfg, device=device)
    states = [slam.track_monocular(*seq.frame(i)).name for i in range(len(seq))]
    slam.sync_mapping()
    times, poses = slam.trajectory_of_map()
    if not np.isfinite(poses).all():
        raise RuntimeError("non-finite pose in the trajectory")
    gt = torch.stack(seq.poses_gt).cpu().numpy()
    return slam, states, ate.evaluate_trajectory(times, poses, seq.times, gt)


def tracked_in_ok(slam):
    """Frames that went through ``_track_ok`` (its ``track`` timer stage)."""
    return len(slam.timer.samples.get("track", []))


def phase_slam_drive():
    import dataclasses

    from rumi_slam_tpu_torch.config import Config
    from rumi_slam_tpu_torch.io.synthetic import SyntheticSequence
    from rumi_slam_tpu_torch.ops import fused_matcher as fm

    cfg = Config()
    cfg = dataclasses.replace(cfg, mapping=dataclasses.replace(
        cfg.mapping, loop_closing=False, overlapped=False))
    c = cfg.camera
    seq = SyntheticSequence(n_frames=60, width=c.width, height=c.height,
                            K=cfg.intrinsics("cuda"), seed=4, device="cuda")
    # the main path: the launch counters start at 0 here
    fm.fused_match.launches = 0
    fm.match_bank.launches = 0
    t0 = time.perf_counter()
    slam, states, m = slam_drive(cfg, seq, "cuda")
    wall = time.perf_counter() - t0
    launches = fm.fused_match.launches
    ok = states.count("OK")
    tracked = tracked_in_ok(slam)
    r = dict(frames=len(states), ok_frames=ok, ok_share=ok / len(states),
             tracked_in_ok=tracked, n_kf=slam.stats["n_kf"], ate_m=m["ate"],
             n_matched=m["n_matched"], launches=launches,
             launches_match_bank=fm.match_bank.launches, wall_s=wall, stats=slam.stats,
             states=states,
             stage_ms=slam.timer.stats(),
             bounds=dict(ok_share_min=JAX_DRIVE_OK_SHARE - 0.05,
                         ate_max_m=1.5 * JAX_DRIVE_ATE_M + 0.01))
    emit(phase="slam_drive", **r)
    if slam.stats["n_kf"] < 2 or "OK" not in states:
        raise RuntimeError("the SLAM drive did not initialise")
    if r["ok_share"] < r["bounds"]["ok_share_min"]:
        raise RuntimeError(f"OK share {r['ok_share']} below {r['bounds']['ok_share_min']}")
    if not m["ate"] <= r["bounds"]["ate_max_m"]:
        raise RuntimeError(f"ATE {m['ate']} m above {r['bounds']['ate_max_m']} m")
    if launches < tracked:
        raise RuntimeError(f"{launches} kernel launches for {tracked} frames tracked in OK")
    return r, slam


def phase_overlapped_mapping():
    import dataclasses

    from rumi_slam_tpu_torch.config import tiny_config
    from rumi_slam_tpu_torch.io.synthetic import SyntheticSequence
    from rumi_slam_tpu_torch.ops import fused_matcher as fm

    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, mapping=dataclasses.replace(
        cfg.mapping, overlapped=True, loop_closing=False))
    seq = SyntheticSequence(n_frames=45, width=320, height=240, n_points=1500, seed=4,
                            patch=3, device="cuda")
    fm.fused_match.launches = 0
    fm.match_bank.launches = 0
    t0 = time.perf_counter()
    slam, states, m = slam_drive(cfg, seq, "cuda")
    wall = time.perf_counter() - t0
    slam.mapper.shutdown()
    ok = states.count("OK")
    adopted = slam.stats.get("n_adopted", 0)
    r = dict(frames=len(states), ok_frames=ok, ok_share=ok / len(states),
             tracked_in_ok=tracked_in_ok(slam), n_kf=slam.stats["n_kf"], adopted=adopted,
             ate_m=m["ate"], launches=fm.fused_match.launches,
             launches_match_bank=fm.match_bank.launches, wall_s=wall,
             stats=slam.stats, stage_ms=slam.timer.stats())
    emit(phase="overlapped_mapping", **r)
    if adopted < 1:
        raise RuntimeError("no mapping-worker result was adopted")
    if not r["ok_share"] > 0.6 or not m["ate"] < 0.15:
        raise RuntimeError(f"overlapped drive: OK share {r['ok_share']}, ATE {m['ate']} m")
    if r["launches"] < r["tracked_in_ok"]:
        raise RuntimeError(f"{r['launches']} kernel launches for {r['tracked_in_ok']} "
                           "frames tracked in OK")
    return r


def phase_reloc_drive():
    import dataclasses

    from rumi_slam_tpu_torch.config import Config
    from rumi_slam_tpu_torch.io.synthetic import SyntheticSequence
    from rumi_slam_tpu_torch.mapstate import map_state as M
    from rumi_slam_tpu_torch.ops import fused_matcher as fm
    from rumi_slam_tpu_torch.ops.orb import Features
    from rumi_slam_tpu_torch.optim import pnp
    from rumi_slam_tpu_torch.tracking import tracker

    cfg = Config()
    cfg = dataclasses.replace(cfg, mapping=dataclasses.replace(
        cfg.mapping, loop_closing=False, overlapped=False))
    c = cfg.camera
    seq = SyntheticSequence(n_frames=RELOC_FRAMES, width=c.width, height=c.height,
                            K=cfg.intrinsics("cuda"), seed=4, lost_span=RELOC_SPAN,
                            device="cuda")
    calls, last, matched = [], {}, []
    relocalize_map, match_bank = tracker.relocalize_map, tracker.match_bank
    dlt_pose = pnp._dlt_pose

    def recorded_match(*a, **kw):
        matched.append(match_bank(*a, **kw))
        return matched[-1]

    def recorded(draw, ms, K, feats, **kw):
        """``relocalize_map`` on the card, keeping its inputs, the index
        sets it drew and the pose hypotheses it solved from them."""
        drawn, solved = [], []

        def recording(logits, shape):
            drawn.append(draw(logits, shape))
            return drawn[-1]

        def recording_dlt(X, rays):
            solved.append(dlt_pose(X, rays))
            return solved[-1]

        pnp._dlt_pose = recording_dlt
        try:
            tr, ref = relocalize_map(recording, ms, K, feats, **kw)
        finally:
            pnp._dlt_pose = dlt_pose
        calls.append(dict(n_inliers=int(tr.n_inliers), n_candidates=int(tr.n_candidates),
                          bank_rows_in_use=int(ms.kf_valid.sum()) * ms.max_feat))
        last.update(drawn=drawn, solved=solved, ms=ms, K=K, feats=feats, kw=kw, tr=tr, ref=ref)
        return tr, ref

    # the main path: the launch counters start at 0 here
    fm.fused_match.launches = 0
    fm.match_bank.launches = 0
    tracker.relocalize_map, tracker.match_bank = recorded, recorded_match
    try:
        t0 = time.perf_counter()
        slam, states, m = slam_drive(cfg, seq, "cuda")
        wall = time.perf_counter() - t0
        launches = {"fused_match": fm.fused_match.launches,
                    "match_bank": fm.match_bank.launches}
        if not calls:
            raise RuntimeError(f"relocalize_map was never called; states {states}")
        # the frame that relocalised made the last call: the same call on CPU
        # copies of its inputs, with the index sets the card's run drew; once
        # with the pose hypotheses the card solved from them, once solving them
        cpu_in = (M.MapState(*(x.cpu() for x in last["ms"])), last["K"].cpu(),
                  Features(*(x.cpu() for x in last["feats"])))
        replay, solved = iter(last["drawn"]), iter(last["solved"])
        pnp._dlt_pose = lambda X, rays: next(solved).cpu()
        try:
            tr_h, ref_h = relocalize_map(lambda logits, shape: next(replay), *cpu_in,
                                         **last["kw"])
        finally:
            pnp._dlt_pose = dlt_pose
        replay = iter(last["drawn"])
        tr_c, ref_c = relocalize_map(lambda logits, shape: next(replay), *cpu_in, **last["kw"])
    finally:
        tracker.relocalize_map, tracker.match_bank = relocalize_map, match_bank
    tr = last["tr"]
    assoc = tr.assoc.cpu()
    (idx_g, dist_g), (idx_h, dist_h), (idx_c, dist_c) = matched[-3:]
    shared = int(((assoc >= 0) & (tr_c.assoc >= 0)).sum())
    on_cpu = dict(matcher_output_equal=bool((idx_g.cpu() == idx_c).all()
                                            and (dist_g.cpu() == dist_c).all()
                                            and (idx_h == idx_c).all()
                                            and (dist_h == dist_c).all()),
                  n_candidates=[int(tr.n_candidates), int(tr_c.n_candidates)],
                  given_card_hypotheses=dict(
                      assoc_rows_differing=int((assoc != tr_h.assoc).sum()),
                      n_inliers=int(tr_h.n_inliers), ref_kf=int(ref_h),
                      pose_diff=float((tr.pose.cpu() - tr_h.pose).abs().max())),
                  assoc_rows_differing=int((assoc != tr_c.assoc).sum()),
                  assoc_rows_conflicting=int(((assoc != tr_c.assoc)
                                              & (assoc >= 0) & (tr_c.assoc >= 0)).sum()),
                  shared_inliers=shared,
                  shared_share=shared / max(1, min(int(tr.n_inliers), int(tr_c.n_inliers))),
                  n_inliers=[int(tr.n_inliers), int(tr_c.n_inliers)],
                  ref_kf=[int(last["ref"]), int(ref_c)],
                  pose_diff=float((tr.pose.cpu() - tr_c.pose).abs().max()))
    gate = cfg.tracking.min_track_inliers
    on_cpu["own_hypotheses_recovered"] = on_cpu["n_inliers"][1] >= gate
    ok = states.count("OK")
    end = RELOC_SPAN[1]
    r = dict(frames=len(states), lost_span=list(RELOC_SPAN), ok_frames=ok,
             ok_share=ok / len(states), n_kf=slam.stats["n_kf"], ate_m=m["ate"],
             n_matched=m["n_matched"], launches_fused_match=launches["fused_match"],
             launches_match_bank=launches["match_bank"], wall_s=wall, stats=slam.stats,
             states=states, relocalize_map_calls=calls, last_call_card_vs_cpu=on_cpu,
             stage_ms=slam.timer.stats(),
             relocalize_stage_ms=slam.timer.stats().get("relocalize"),
             bounds=dict(ok_share_min=JAX_RELOC_OK_SHARE - 0.05,
                         ate_max_m=1.5 * JAX_RELOC_ATE_M + 0.01))
    emit(phase="reloc_drive", **r)
    if states[RELOC_SPAN[0]] != "RECENTLY_LOST" or "OK" not in states[:RELOC_SPAN[0]]:
        raise RuntimeError("the drive did not lose track on the span's first frame")
    if launches["match_bank"] < 1 or launches["match_bank"] != len(calls):
        raise RuntimeError(f"{launches['match_bank']} launches of the gate-off kernel for "
                           f"{len(calls)} calls of relocalize_map")
    if slam.stats["n_reloc"] < 1 or "OK" not in states[end:end + 5]:
        raise RuntimeError(f"no relocalisation within 5 frames of the span: "
                           f"{states[end:end + 5]}, n_reloc {slam.stats['n_reloc']}")
    if slam.stats["n_new_maps"] != 0 or "LOST" in states:
        raise RuntimeError("the drive gave the map up instead of relocalising")
    # PnP keeps the consensus of its best raw 6-point hypothesis, and about four
    # candidates in ten are inliers here: whether one of the hypotheses is clean
    # turns on the last digits of the float32 eigen solves, which differ between
    # the card's solver and LAPACK.  Solving its own, the CPU run can therefore
    # miss the consensus the card found (8 inliers against the card's 30 seen);
    # it is held to the card's pose when it reaches the inlier gate itself.
    if (not on_cpu["matcher_output_equal"]
            or on_cpu["n_candidates"][0] != on_cpu["n_candidates"][1]
            or on_cpu["n_inliers"][0] < gate
            or on_cpu["given_card_hypotheses"]["n_inliers"] != on_cpu["n_inliers"][0]
            or on_cpu["given_card_hypotheses"]["assoc_rows_differing"]
            or on_cpu["given_card_hypotheses"]["pose_diff"] > POSE_ATOL
            or on_cpu["given_card_hypotheses"]["ref_kf"] != on_cpu["ref_kf"][0]
            or (on_cpu["own_hypotheses_recovered"]
                and (on_cpu["assoc_rows_conflicting"]
                     or on_cpu["pose_diff"] > RELOC_POSE_ATOL))):
        raise RuntimeError(f"relocalize_map on the card and on the CPU differ: {on_cpu}")
    if r["ok_share"] < r["bounds"]["ok_share_min"]:
        raise RuntimeError(f"OK share {r['ok_share']} below {r['bounds']['ok_share_min']}")
    if not m["ate"] <= r["bounds"]["ate_max_m"]:
        raise RuntimeError(f"ATE {m['ate']} m above {r['bounds']['ate_max_m']} m")
    if launches["fused_match"] < tracked_in_ok(slam):
        raise RuntimeError(f"{launches['fused_match']} kernel launches for "
                           f"{tracked_in_ok(slam)} frames tracked in OK")
    return r


def _ms(fn):
    """(result, host ms of ``fn()`` with the device drained before and after)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def pose_graph_chain(n_kf, max_edges, device, drift=0.3):
    """The drifted chain of ``tests/test_components.py`` at full width:
    ``n_kf`` vertices 0.5 apart, the far end translated by ``drift``,
    sequential edges and one loop edge (0, n_kf - 1, weight 3) measured from
    the truth, padded with zero-weight (0, 0) edges to ``max_edges``.
    Returns (truth [n_kf, 7], S_est, edges, fixed)."""
    import torch

    from rumi_slam_tpu_torch.geometry import lie
    from rumi_slam_tpu_torch.optim import pose_graph

    truth = torch.zeros((n_kf, 7))
    truth[:, 0] = 1.0
    truth[:, 4] = 0.5 * torch.arange(n_kf)
    est = truth.clone()
    est[n_kf - 1, 4] += drift
    S_truth = lie.sim3_from_se3(truth)
    ei = torch.zeros(max_edges, dtype=torch.int32)
    ej = torch.zeros(max_edges, dtype=torch.int32)
    w = torch.zeros(max_edges)
    ei[: n_kf - 1], ej[: n_kf - 1] = torch.arange(n_kf - 1), torch.arange(1, n_kf)
    w[: n_kf - 1] = 1.0
    ei[n_kf - 1], ej[n_kf - 1], w[n_kf - 1] = 0, n_kf - 1, 3.0
    S_m = pose_graph.relative_sim3(S_truth[ei.long()], S_truth[ej.long()])
    edges = pose_graph.PoseGraphEdges(*(x.to(device) for x in (ei, ej, S_m, w)))
    fixed = torch.zeros(n_kf, dtype=torch.bool)
    fixed[0] = True
    return truth.to(device), lie.sim3_from_se3(est).to(device), edges, fixed.to(device)


def two_keyframe_loop_map(cfg, S_true, device):
    """Two keyframes holding one real frame's ORB features at full width:
    the query sees the scene at its true place, the candidate sees the same
    pixels with its points moved by ``S_true^-1`` (the construction of
    ``tests/test_rumination.py::build_two_submaps``).  Returns (ms, K)."""
    import torch

    from rumi_slam_tpu_torch import step as S
    from rumi_slam_tpu_torch.geometry import lie
    from rumi_slam_tpu_torch.io.synthetic import SyntheticSequence
    from rumi_slam_tpu_torch.mapstate import map_state as M
    from rumi_slam_tpu_torch.rumination.merge import correct_poses

    c = cfg.camera
    K = cfg.intrinsics(device)
    seq = SyntheticSequence(n_frames=2, width=c.width, height=c.height, K=K, seed=7,
                            device=device)
    tstep = S.TrackingStep(cfg, K).to(device)
    img, depth, _ = seq.frame_rgbd(0)
    feats = tstep.extractor(img)
    T0 = seq.poses_gt[0]
    seeded = S.seed_map_from_depth(feats, depth, K, T0, cfg)
    n = feats.capacity
    X, ok = seeded.pt_xyz[:n], seeded.pt_valid[:n]
    ms = M.empty(cfg.mapping.max_kf, n, cfg.mapping.max_pt, device)
    ms, pid0 = M.add_points(ms, X, feats.desc, ok, 0, octave=feats.octave, angle=feats.angle)
    ms, pid1 = M.add_points(ms, lie.sim3_apply(lie.sim3_inverse(S_true), X), feats.desc, ok, 1,
                            octave=feats.octave, angle=feats.angle)
    ms, _ = M.insert_keyframe(ms, T0, feats, 0.0, pid0)
    # the same camera in the candidate's world: T0 o S_true, scale divided out
    ms, _ = M.insert_keyframe(ms, correct_poses(T0, lie.sim3_inverse(S_true)), feats, 1.0, pid1)
    return ms, K


def gba_cost(K, prob):
    """Total robust reprojection cost of a compacted global-BA problem."""
    from rumi_slam_tpu_torch.optim import ba

    poses, points, cam_idx, pt_idx, uv, conf = prob["args"][:6]
    return float(ba._problem_terms(K, poses, points, cam_idx.long(), pt_idx.long(), uv, conf)[4])


def to_cpu(ms):
    return type(ms)(*(x.cpu() for x in ms))


def phase_known_answers(slam):
    """Phase 9: checkpoint, pose graph, loop verification and closing, global
    BA and the merge, at full width, each against an answer known
    beforehand.  ``slam``: phase 6's system, its map built on the card."""
    import os
    import tempfile

    import torch

    from rumi_slam_tpu_torch.geometry import lie
    from rumi_slam_tpu_torch.mapstate import checkpoint
    from rumi_slam_tpu_torch.mapstate import map_state as M
    from rumi_slam_tpu_torch.optim import pose_graph, ransac
    from rumi_slam_tpu_torch.rumination import cloud_map, coordinator
    from rumi_slam_tpu_torch.rumination import merge as merge_mod
    from rumi_slam_tpu_torch.system import SlamSystem
    from rumi_slam_tpu_torch.tracking import local_mapping, loop_closing

    t_phase = time.perf_counter()
    cfg, K, ms6 = slam.cfg, slam.K, slam.ms
    out = {}

    # --- checkpoint: save -> load on the card, digest, tampering
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "atlas.ckpt")
        _, save_ms = _ms(lambda: slam.save_map(path))
        digest = checkpoint.save(slam.ms, os.path.join(d, "again.ckpt"))
        with open(path, "rb") as f:
            raw = bytearray(f.read())
        hlen = int.from_bytes(raw[:8], "little")
        header = json.loads(raw[8:8 + hlen].decode())
        other = SlamSystem(cfg, device="cuda")
        _, load_ms = _ms(lambda: other.load_map(path))
        unequal = [k for k, a, b in zip(ms6._fields, ms6, other.ms)
                   if not (b.is_cuda and a.dtype == b.dtype and torch.equal(a, b))]
        raw[-64] ^= 0x01
        with open(path, "wb") as f:
            f.write(bytes(raw))
        try:
            checkpoint.load(path)
            tamper_raised = False
        except ValueError:
            tamper_raised = True
    out["checkpoint"] = dict(bytes=len(raw), save_ms=save_ms, load_ms=load_ms,
                             fields_unequal=unequal, digest_stable=header["sha256"] == digest,
                             format_version=header["format_version"],
                             tamper_raised=tamper_raised,
                             n_maps_host=other.n_maps_host, state=other.state.name)
    if unequal or not out["checkpoint"]["digest_stable"] or not tamper_raised:
        raise RuntimeError(f"checkpoint round trip failed: {out['checkpoint']}")

    # --- pose graph at full width: 256 vertices, 2048 edge slots
    n_kf = cfg.mapping.max_kf
    truth, S_est, edges, fixed = pose_graph_chain(n_kf, 2048, "cuda")
    S_opt, pg_ms = _ms(lambda: pose_graph.optimize_pose_graph(S_est, edges, fixed, n_iters=10))
    S_cpu = pose_graph.optimize_pose_graph(
        S_est.cpu(), pose_graph.PoseGraphEdges(*(x.cpu() for x in edges)), fixed.cpu(),
        n_iters=10)
    out["pose_graph"] = dict(
        vertices=n_kf, edge_slots=2048, solve_size=7 * n_kf, ms=pg_ms,
        drift_left=float((S_opt[n_kf - 1, 4:7] - truth[n_kf - 1, 4:7]).norm()),
        card_vs_cpu=float((S_opt.cpu() - S_cpu).abs().max()))
    if not (out["pose_graph"]["drift_left"] < 0.02 and out["pose_graph"]["card_vs_cpu"] < 1e-3):
        raise RuntimeError(f"pose graph: {out['pose_graph']}")

    # --- verify_loop against a known Sim(3); 256 batched 4x4 eigh on the card
    S_true = lie.sim3_make(lie.so3_exp(torch.tensor([0.05, -0.1, 0.08])),
                           torch.tensor([0.5, -0.3, 0.9]), 1.4).to("cuda")
    ms2, _ = two_keyframe_loop_map(cfg, S_true, "cuda")
    drawn = []
    base = ransac.sampler(torch.Generator().manual_seed(9))

    def draw(logits, shape):
        drawn.append(base(logits, shape))
        return drawn[-1]

    (S_v, n_inl, inl), verify_ms = _ms(lambda: loop_closing.verify_loop(draw, K, ms2, 0, 1))
    S_vc, n_inl_c, inl_c = loop_closing.verify_loop_from(drawn[0], K.cpu(), to_cpu(ms2), 0, 1)
    out["verify_loop"] = dict(
        features_with_points=int((ms2.kf_point[0] >= 0).sum()), hypotheses=list(drawn[0].shape),
        n_inliers=int(n_inl), scale=float(lie.sim3_scale(S_v)), scale_true=1.4, ms=verify_ms,
        sim3_error=float((S_v - S_true).abs().max()),
        cpu_same_triples=dict(n_inliers=int(n_inl_c),
                              inlier_rows_differing=int((inl.cpu() != inl_c).sum()),
                              sim3_diff=float((S_v.cpu() - S_vc).abs().max())))
    if not (abs(out["verify_loop"]["scale"] - 1.4) < 0.02
            and int(n_inl) >= cfg.mapping.loop_min_inliers
            and out["verify_loop"]["cpu_same_triples"]["sim3_diff"] < 1e-3):
        raise RuntimeError(f"verify_loop: {out['verify_loop']}")

    # --- close_loop and global BA on the driven map
    q, cand = int(ms6.n_kf) - 1, 0
    S_drift = lie.sim3_exp(torch.tensor([0.004, -0.006, 0.005, 0.02, -0.01, 0.015, 0.02],
                                        device="cuda"))
    closed, close_ms = _ms(lambda: loop_closing.close_loop(ms6, K, q, cand, S_drift))
    prob = local_mapping.gba_problem(closed, 0)
    cost0 = gba_cost(K, prob)
    after, gba_ms = _ms(lambda: local_mapping.global_bundle_adjustment(
        closed, K, 0, n_iters=cfg.mapping.loop_gba_iters))
    cost1 = gba_cost(K, local_mapping.gba_problem(after, 0))
    out["close_loop_gba"] = dict(
        keyframes=int(ms6.kf_valid.sum()), query=q, candidate=cand, close_loop_ms=close_ms,
        candidate_moved=float((closed.kf_pose[cand] - ms6.kf_pose[cand]).abs().max()),
        query_moved=float((closed.kf_pose[q] - ms6.kf_pose[q]).abs().max()),
        gba=dict(C=prob["C"], P=prob["P"], observations=int(prob["n_obs"]),
                 iters=cfg.mapping.loop_gba_iters, ms=gba_ms, cost_before=cost0,
                 cost_after=cost1))
    finite = all(bool(torch.isfinite(x).all()) for x in (closed.kf_pose, closed.pt_xyz,
                                                         after.kf_pose, after.pt_xyz))
    if not (finite and cost1 <= cost0 and out["close_loop_gba"]["candidate_moved"] < 1e-6):
        raise RuntimeError(f"close_loop / global BA: {out['close_loop_gba']}")

    # --- the merge against a known Sim(3): the driven map's copy, moved,
    # comes back as a second submap and is merged into the first
    S_known = lie.sim3_make(lie.so3_exp(torch.tensor([0.03, 0.08, -0.05])),
                            torch.tensor([0.4, 0.2, -0.6]), 1.3).to("cuda")
    S_inv = lie.sim3_inverse(S_known)
    cm = cloud_map.from_map_state(ms6, 0)
    cm = cm._replace(pt_xyz=lie.sim3_apply(S_inv, cm.pt_xyz),
                     kf_pose=merge_mod.correct_poses(cm.kf_pose, S_inv))
    ms_in, kf_ids = coordinator.insert_cloud_map(ms6._replace(n_maps=ms6.n_maps + 1), cm, 1)
    mcfg = cfg.merge
    matches = merge_mod.match_kfs_by_time(ms_in.kf_time, ms_in.kf_valid, ms_in.kf_map_id, 0, 1,
                                          max_pairs=mcfg.max_match_kf, tol=mcfg.time_tolerance_s)
    drawn = []
    base = ransac.sampler(torch.Generator().manual_seed(10))   # ``draw`` records into ``drawn``
    (merged, ok, info), merge_ms = _ms(
        lambda: merge_mod.merge_submaps(ms_in, K, 1, 0, mcfg, draw))
    replay = iter(list(drawn))
    _, ok_c, info_c = merge_mod.merge_submaps(to_cpu(ms_in), K.cpu(), 1, 0, mcfg,
                                              lambda logits, shape: next(replay))
    pair_err = 0.0
    if ok:
        m = matches.valid
        Ta = merged.kf_pose[matches.dst_kf[m].long()]
        Tb = merged.kf_pose[matches.src_kf[m].long()]
        pair_err = float(lie.se3_log(lie.se3_compose(Ta, lie.se3_inverse(Tb))).norm(dim=-1).max())
    out["merge"] = dict(
        copy_keyframes=int((kf_ids >= 0).sum()), ms=merge_ms, ok=bool(ok), info=info,
        scale_known=1.3, kf_left_in_copy=int(M.map_kf_count(merged, 1)),
        points_before=int(ms_in.pt_valid.sum()), points_after=int(merged.pt_valid.sum()),
        max_pair_se3_log=pair_err, cpu_same_triples=dict(ok=bool(ok_c), info=info_c))
    if not (ok and ok_c and abs(info["scale"] - 1.3) < 0.02
            and abs(info["scale"] - info_c["scale"]) < 1e-3
            and out["merge"]["kf_left_in_copy"] == 0
            and out["merge"]["points_after"] < out["merge"]["points_before"]
            and pair_err < 0.05):
        raise RuntimeError(f"known-answer merge: {out['merge']}")
    out["weld"] = known_answer_weld(cfg, K, ms6)
    out["seconds"] = time.perf_counter() - t_phase
    emit(phase="known_answers", **out)
    return out


def known_answer_weld(cfg, K, ms):
    """The backend's weld against a known Sim(3): the driven map split in two
    by time (later keyframes, and the points they were first seen from, become
    submap 1, moved by ``S_known^-1``), then ``_weld_submaps(dst=0, src=1)``
    must bring them back.  Every weld try is one ``relocalize_map``, i.e. one
    launch of the gate-off kernel over the whole observation bank."""
    import types

    import torch

    from rumi_slam_tpu_torch.geometry import lie
    from rumi_slam_tpu_torch.mapstate import map_state as M
    from rumi_slam_tpu_torch.ops import fused_matcher as fm
    from rumi_slam_tpu_torch.rumination.backend import RuminationBackend
    from rumi_slam_tpu_torch.rumination.merge import correct_poses

    S_known = lie.sim3_make(lie.so3_exp(torch.tensor([-0.04, 0.06, 0.03])),
                            torch.tensor([-0.3, 0.25, 0.5]), 1.3).to("cuda")
    S_inv = lie.sim3_inverse(S_known)
    rows = torch.nonzero(ms.kf_valid).flatten()
    t_split = ms.kf_time[rows].median()
    late_kf = ms.kf_valid & (ms.kf_time > t_split)
    late_pt = ms.pt_valid & late_kf[ms.pt_ref_kf.clamp_min(0).long()] & (ms.pt_ref_kf >= 0)
    split = ms._replace(
        kf_map_id=torch.where(late_kf, 1, ms.kf_map_id).to(ms.kf_map_id.dtype),
        pt_map_id=torch.where(late_pt, 1, ms.pt_map_id).to(ms.pt_map_id.dtype),
        kf_pose=torch.where(late_kf[:, None], correct_poses(ms.kf_pose, S_inv), ms.kf_pose),
        pt_xyz=torch.where(late_pt[:, None], lie.sim3_apply(S_inv, ms.pt_xyz), ms.pt_xyz),
        n_maps=ms.n_maps + 1)
    backend = RuminationBackend(cfg, device="cuda")
    before = fm.match_bank.launches
    welded, weld_ms = _ms(lambda: backend._weld_submaps(
        types.SimpleNamespace(ms=split, K=K), 0, 1))
    launches = fm.match_bank.launches - before
    tries = backend.last_weld_tries["pnp"]
    r = dict(keyframes=[int((ms.kf_valid & ~late_kf).sum()), int(late_kf.sum())],
             points=[int((ms.pt_valid & ~late_pt).sum()), int(late_pt.sum())],
             tries=tries, launches_match_bank=launches, ms=weld_ms,
             info=backend.last_weld_info, scale_known=1.3, welded=welded is not None)
    if welded is not None:
        rel = lie.se3_compose(welded.kf_pose[late_kf], lie.se3_inverse(ms.kf_pose[late_kf]))
        depth = ms.pt_xyz[late_pt].norm(dim=-1).clamp_min(1e-6)
        r.update(kf_left_in_src=int(M.map_kf_count(welded, 1)),
                 max_kf_se3_log=float(lie.se3_log(rel).norm(dim=-1).max()),
                 max_point_rel_err=float(((welded.pt_xyz[late_pt] - ms.pt_xyz[late_pt])
                                          .norm(dim=-1) / depth).max()))
    if not (welded is not None and launches == len(tries) and len(tries) >= 2
            and abs(r["info"]["scale"] - 1.3) < WELD_SCALE_TOL and r["kf_left_in_src"] == 0
            and r["max_kf_se3_log"] < WELD_POSE_TOL):
        raise RuntimeError(f"known-answer weld: {r}")
    return r


# The rumination scenario of phase 10 and what the JAX package does on it at
# the same widths (CPU, `JAX_PLATFORMS=cpu PYTHONPATH=. python
# tests/torch_rumination_drive.py --full [--own-backend]`).  Clear-view
# backend: states NN, 43 x OK, RECENTLY_LOST on 45-47, a new submap on frame
# 48, OK again from 53 (100 of 110 OK); bundle of 20 frames (8 lost raw, 1
# sampled), 24.576 MB; 18 cloud keyframes; cloud merge 10 keyframe matches /
# 4319 pairs / inlier ratio 0.674 / scale 1.082, back merge 5 / 1182 / 0.183 /
# 0.393; dense global BA; one map of 50 keyframes; keyframe ATE 0.030678 m.
# Own backend: the same bundle, offline states NOOOOOOOOORRRRRRRRNN,
# `backend_failed`.  The ATE bound is the JAX end-to-end test's own, 0.3 m.
# the weld fixes its scale from the baselines between PnP poses, each good to
# a few millimetres on baselines of decimetres: a few percent, not the merge's
# 0.02 (1.271 for 1.3 on an H100, six anchors of 512 down to 15 inliers)
WELD_SCALE_TOL = 0.08
WELD_POSE_TOL = 0.05
RUMI_FRAMES = 110
RUMI_SEED = 11
RUMI_LOST_SPAN = (45, 51)
JAX_RUMI_OK_SHARE = 100 / 110
JAX_RUMI_NEW_MAP_FRAME = 48
JAX_RUMI_ATE_M = 0.030678
RUMI_ATE_MAX_M = 0.3
# With the live system's mapping on its worker thread (``Config()``'s own
# setting; `... tests/torch_rumination_drive.py --full --overlapped --async`)
# the JAX package makes 14 live keyframes (27 in the merged map; 50 with
# synchronous mapping) and merges with keyframe ATE 0.1186 m (0.1223 m
# with the backend inline): it degrades as the port does (ROADMAP queue 3).
# The async_overlapped run is held to JAX's keyframe counts less
# OVL_KF_SLACK, and to OVL_ATE_MAX_M: its ATE swings with the back merge, the
# known bimodal one of queue 3, which on an H100 gave 0.046-0.348 m over the
# runs recorded in PERF.md (0.181 m with an inlier ratio of 0.18); a merge
# gone wrong lands at metres.
JAX_OVL_LIVE_KF = 14
JAX_OVL_MERGED_KF = 27
JAX_OVL_ATE_M = 0.1186
OVL_KF_SLACK = 3
OVL_ATE_MAX_M = 0.5
_LETTER = {"NOT_INITIALIZED": "N", "OK": "O", "RECENTLY_LOST": "R", "LOST": "L"}


def rumination_drive():
    """``tests/torch_rumination_drive.py``: the scenario's configuration,
    sequence and clear-view backend, shared with the CPU drives of either
    package (the module itself imports neither)."""
    return tests_module("torch_rumination_drive")


def rumination_config(overlapped=False):
    """``Config()`` widths with ``tiny_config()``'s time and count gates (they
    are depths: a 110-frame drive cannot meet the defaults' 40 keyframes and
    3 s), ``reloc_window_s=0.1`` so that the six featureless frames are a
    real loss, loop closing on, synchronous mapping unless ``overlapped``
    (``Config()``'s own setting: local mapping on the worker thread)."""
    import dataclasses

    from rumi_slam_tpu_torch import config

    cfg = rumination_drive().scenario_config(config, full=True)
    return dataclasses.replace(cfg, mapping=dataclasses.replace(cfg.mapping,
                                                                overlapped=overlapped))


def rumination_sequence(cfg, lost_span):
    from rumi_slam_tpu_torch.io import synthetic

    return rumination_drive().make_sequence(synthetic, cfg, seed=RUMI_SEED, frames=RUMI_FRAMES,
                                            lost_span=lost_span, device="cuda")


def clear_view_backend(cfg, clean_seq, clear_view=True):
    """A ``RuminationBackend`` on the card that times its builds
    (``build_ms``) and, with ``clear_view``, first swaps each bundle image for
    ``clean_seq``'s rendering at the same timestamp; everything else is the
    package's own ``build()``.  The synthetic loss renders a flat image, which
    no backend can see through; a dense backend sees degraded frames, and the
    clean renderings stand in for that."""
    import torch

    from rumi_slam_tpu_torch.rumination import sampler
    from rumi_slam_tpu_torch.rumination.backend import RuminationBackend

    class TimedBackend(RuminationBackend):
        build_ms = None

        def build(self, bundle, anchor_times=(), anchor_split=None):
            t0 = time.perf_counter()
            try:
                return super().build(bundle, anchor_times=anchor_times,
                                     anchor_split=anchor_split)
            finally:
                torch.cuda.current_stream().synchronize()
                self.build_ms = (time.perf_counter() - t0) * 1e3

    cls = (rumination_drive().clear_view_backend(TimedBackend, clean_seq, sampler)
           if clear_view else TimedBackend)
    return cls(cfg, device="cuda")


def clear_view_coordinator(slam, cfg, clean_seq):
    """A synchronous ``RuminationCoordinator`` on ``slam`` with the clear-view
    backend (``tools/profile_torch_slam.py --ruminate`` drives it)."""
    from rumi_slam_tpu_torch.rumination.coordinator import RuminationCoordinator

    return RuminationCoordinator(slam, cfg, backend=clear_view_backend(cfg, clean_seq))


def rumination_run(cfg, seq, clean_seq, *, mode):
    """One drive of the scenario on the card.  ``mode``: ``"sync"`` (clear-view
    backend inline), ``"async"`` (the same through ``AsyncRuminationShard``) or
    ``"async_overlapped"`` (the shard again, and the live system's local
    mapping on its worker thread, ``Config()``'s own setting: three host
    threads on one card) or ``"own"`` (the package's backend unchanged; stops
    at the first history row).  The backend's offline system always maps
    inline.  With overlapped mapping keyframes are made only while the worker
    is idle, so the live maps hold about half as many and the result depends
    on the threads' timing: that run must lose track, open its submap, merge
    into one finite map that spans the gap and raise nothing; its ATE is
    printed beside the bound and not required to meet it.  Returns the summary
    dict; raises if a requirement fails."""
    import torch

    from rumi_slam_tpu_torch.evaluation import ate
    from rumi_slam_tpu_torch.mapstate import map_state as M
    from rumi_slam_tpu_torch.ops import fused_matcher as fm
    from rumi_slam_tpu_torch.rumination import backend as backend_mod
    from rumi_slam_tpu_torch.rumination.coordinator import RuminationCoordinator
    from rumi_slam_tpu_torch.rumination.remote import AsyncRuminationShard
    from rumi_slam_tpu_torch.system import SlamSystem
    from rumi_slam_tpu_torch.tracking import local_mapping, tracker

    offline = []          # the backend's offline systems, one per build
    reloc_calls = [0]
    gba_sizes = []

    class RecordingSlam(SlamSystem):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.states = []
            offline.append(self)

        def track_monocular(self, img, t):
            st = super().track_monocular(img, t)
            self.states.append(_LETTER[st.name])
            return st

    relocalize_map, gba = tracker.relocalize_map, local_mapping.gba_problem

    def counted_reloc(*a, **kw):
        reloc_calls[0] += 1
        return relocalize_map(*a, **kw)

    def sized_gba(ms, map_id):
        prob = gba(ms, map_id)
        if prob is not None:
            gba_sizes.append(dict(C=prob["C"], P=prob["P"], observations=int(prob["n_obs"])))
        return prob

    overlapped = mode == "async_overlapped"
    if overlapped:
        cfg = rumination_config(overlapped=True)
    slam = SlamSystem(cfg, device="cuda")
    backend = clear_view_backend(cfg, clean_seq, clear_view=mode != "own")
    shard = AsyncRuminationShard(cfg, backend=backend) if mode.startswith("async") else None
    coord = RuminationCoordinator(slam, cfg, backend=backend, async_shard=shard)
    states, in_flight = [], 0
    # the main path: the launch counters start at 0 here
    fm.fused_match.launches = 0
    fm.match_bank.launches = 0
    backend_mod.SlamSystem = RecordingSlam
    tracker.relocalize_map, local_mapping.gba_problem = counted_reloc, sized_gba
    t0 = time.perf_counter()
    try:
        for i in range(len(seq)):
            states.append(_LETTER[slam.track_monocular(*seq.frame(i)).name])
            if shard is not None and shard.busy:
                in_flight += 1
            coord.maybe_ruminate()
            if mode == "own" and coord.history:
                break
        deadline = time.time() + 300
        while shard is not None and (shard.busy or coord._pending is not None):
            if time.time() > deadline:
                raise RuntimeError("the asynchronous build did not finish in 300 s")
            coord.maybe_ruminate()
            time.sleep(0.02)
        slam.sync_mapping()
    finally:
        if slam.mapper is not None:
            slam.mapper.shutdown()
        backend_mod.SlamSystem = SlamSystem
        tracker.relocalize_map, local_mapping.gba_problem = relocalize_map, gba
        if shard is not None:
            shard.shutdown()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fused_match": fm.fused_match.launches, "match_bank": fm.match_bank.launches}
    if shard is not None and shard.last_error is not None:
        raise RuntimeError("the asynchronous backend build raised") from shard.last_error

    ms = slam.ms
    tracked = tracked_in_ok(slam) + sum(tracked_in_ok(s) for s in offline)
    stage = slam.timer.stats()
    r = dict(mode=mode, overlapped_mapping=cfg.mapping.overlapped, frames=len(states),
             states="".join(states),
             ok_share=states.count("O") / len(states), stats=slam.stats,
             history=coord.history,
             kf_per_map=[int(M.map_kf_count(ms, m)) for m in range(slam.n_maps_host)],
             backend_states=["".join(s.states) for s in offline],
             backend_build_ms=backend.build_ms, last_weld_tries=backend.last_weld_tries,
             gba_problems=gba_sizes, frames_tracked_in_flight=in_flight,
             launches_fused_match=launches["fused_match"],
             launches_match_bank=launches["match_bank"], tracked_in_ok=tracked,
             relocalize_map_calls=reloc_calls[0], wall_s=wall,
             stage_ms={k: stage[k] for k in stage if k.startswith(("ruminate", "loop"))})
    first_lost = r["states"].find("R")
    new_map = r["states"].find("N", first_lost)
    r["first_lost_frame"], r["new_map_frame"] = first_lost, new_map

    def need(cond, what):
        if not cond:
            emit(phase="rumination", failed=what, **r)
            raise RuntimeError(f"rumination ({mode}): {what}")

    need(first_lost == RUMI_LOST_SPAN[0] and "O" in r["states"][:first_lost],
         "tracking was not lost on the span's first frame")
    need(slam.stats["n_new_maps"] >= 1
         and new_map in (JAX_RUMI_NEW_MAP_FRAME, JAX_RUMI_NEW_MAP_FRAME + 1),
         f"no new submap on frame {JAX_RUMI_NEW_MAP_FRAME} or the next")
    need(len(coord.history) == 1 and "bundle_size" in coord.history[0], "no bundle assembled")
    need(launches["fused_match"] >= tracked,
         f"{launches['fused_match']} gated launches for {tracked} frames tracked in OK")
    need(launches["match_bank"] == reloc_calls[0],
         f"{launches['match_bank']} gate-off launches for {reloc_calls[0]} relocalize_map calls")
    row = coord.history[0]
    if mode == "own":
        need(row["result"] == "backend_failed", f"expected backend_failed, got {row['result']}")
        return r
    need(r["ok_share"] >= JAX_RUMI_OK_SHARE - 0.05, f"OK share {r['ok_share']}")
    need(row["result"] == "merged" and row.get("gba") == "dense", f"result {row.get('result')}")
    need(row["cloud_merge"]["n_kf_matches"] >= 2 and row["back_merge"]["n_kf_matches"] >= 2,
         "a merge had fewer than 2 keyframe matches")
    need(sum(r["kf_per_map"][1:]) == 0 and r["kf_per_map"][0] == int(ms.kf_valid.sum()),
         f"keyframes per map {r['kf_per_map']}")
    kt, kp = slam.keyframe_trajectory()
    gt = torch.stack(seq.poses_gt).cpu().numpy()
    m = ate.evaluate_trajectory(kt, kp, seq.times, gt)
    ate_max = OVL_ATE_MAX_M if overlapped else RUMI_ATE_MAX_M
    r.update(kf_ate_m=float(m["ate"]), kf_span_s=[float(kt.min()), float(kt.max())],
             jax_kf_ate_m=JAX_OVL_ATE_M if overlapped else JAX_RUMI_ATE_M, ate_max_m=ate_max)
    need(np.isfinite(kp).all() and kt.min() < seq.times[40] and kt.max() > seq.times[60],
         "the merged trajectory does not span the gap")
    need(np.isfinite(m["ate"]) and m["ate"] <= ate_max,
         f"keyframe ATE {m['ate']} m above {ate_max} m")
    if overlapped:
        r["jax_keyframes"] = dict(live=JAX_OVL_LIVE_KF, merged=JAX_OVL_MERGED_KF)
        need(slam.stats["n_kf"] >= JAX_OVL_LIVE_KF - OVL_KF_SLACK
             and r["kf_per_map"][0] >= JAX_OVL_MERGED_KF - OVL_KF_SLACK,
             f"{slam.stats['n_kf']} live and {r['kf_per_map'][0]} merged keyframes, JAX "
             f"{JAX_OVL_LIVE_KF} and {JAX_OVL_MERGED_KF}")
    return r


def phase_rumination():
    """Phase 10: loss -> back submap -> double merge on the card, four runs."""
    cfg = rumination_config()
    seq = rumination_sequence(cfg, RUMI_LOST_SPAN)
    clean = rumination_sequence(cfg, None)
    runs = {}
    for mode in ("sync", "async", "async_overlapped", "own"):
        runs[mode] = rumination_run(cfg, seq, clean, mode=mode)
        emit(phase="rumination", **runs[mode])
    return runs


# Phase 11: the depth modes at full width, loop closing off, synchronous
# mapping, an 8 cm baseline (``tests/torch_system_drive.py::depth_camera``).
# What the JAX package does on each run (CPU, `JAX_PLATFORMS=cpu PYTHONPATH=.
# python tests/torch_system_drive.py --mode rgbd`, `... --mode stereo`, `...
# --mode rgbd --frames 70 --lost-span 40 46 --reloc-window 0.1`): (a) RGB-D,
# 60 of 60 frames OK, 20 keyframes, frame-trajectory ATE 0.011534 m without
# scale (0.010817 m with); (b) stereo, 60 of 60 OK, 20 keyframes, 0.012798 m
# (0.008839 m); (c) RGB-D over 70 frames with frames 40-45 featureless and a
# 0.1 s relocalisation window: RECENTLY_LOST on 40-42, LOST and submap 1 on
# 43, initialised from depth on 46 (the first textured frame), 64 of 70 OK,
# 22 keyframes (14 + 8), 0.008409 m (0.008397 m).  Each run is held to an OK
# share of at least JAX's less 0.05, an ATE without scale of at most 1.5 x
# JAX's + 0.01 m, a metric scale (the ATE without scale below the larger of
# that bound and twice the ATE with scale), and run (c) to a new submap on
# JAX's frame or next to it.
DEPTH_RUNS = {
    "rgbd": dict(mode="rgbd", n_frames=60, jax_ok_share=60 / 60, jax_ate_m=0.011534),
    "stereo": dict(mode="stereo", n_frames=60, jax_ok_share=60 / 60, jax_ate_m=0.012798),
    "rgbd_loss": dict(mode="rgbd", n_frames=70, lost_span=(40, 46), reloc_window_s=0.1,
                      jax_ok_share=64 / 70, jax_ate_m=0.008409, jax_new_map_frame=43),
}
# The camera models on the card: TUM1's radtan coefficients with its
# intrinsics, and a KB8 camera, each with the rectification on the card held
# to the CPU's on the same keypoints.
TUM1_RADTAN = (0.262383, -0.953104, -0.005358, 0.002628, 1.163314)
KB8_COEFFS = (0.05, -0.01, 0.003, -0.001)
RECTIFY_ATOL_PX = 1e-3


def tests_module(name):
    """A module of ``tests/`` (the drives' helpers, which import neither
    package at their top)."""
    import importlib

    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    return importlib.import_module(name)


def depth_run(name):
    """One run of phase 11 on the card: drive, time, check."""
    import torch

    from rumi_slam_tpu_torch.ops import fused_matcher as fm

    spec = dict(DEPTH_RUNS[name])
    jax_ok, jax_ate = spec.pop("jax_ok_share"), spec.pop("jax_ate_m")
    jax_new_map = spec.pop("jax_new_map_frame", None)
    drive = tests_module("torch_system_drive").drive
    # the main path: the launch counters start at 0 here
    fm.fused_match.launches = 0
    fm.match_bank.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d, slam, seq = drive(True, device="cuda", **spec)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = {"fused_match": fm.fused_match.launches, "match_bank": fm.match_bank.launches}
    states = d["states"]
    tracked = tracked_in_ok(slam)
    bound = 1.5 * jax_ate + 0.01
    r = dict(run=name, mode=spec["mode"], frames=len(states), lost_span=spec.get("lost_span"),
             states="".join(_LETTER[s] for s in states), ok_share=d["ok_share"],
             n_kf=d["n_kf"], n_maps=slam.n_maps_host, new_map_frames=d["new_map_frames"],
             ate_unscaled_m=d["ate_unscaled"], ate_scaled_m=d["ate"], wall_s=d["wall_s"],
             ms_per_frame=1e3 * d["wall_s"] / len(states), total_s=total,
             stage_ms=slam.timer.stats(),
             launches_fused_match=launches["fused_match"],
             launches_match_bank=launches["match_bank"], tracked_in_ok=tracked,
             stats=slam.stats,
             bounds=dict(ok_share_min=jax_ok - 0.05, ate_unscaled_max_m=bound,
                         jax_ate_unscaled_m=jax_ate, jax_new_map_frame=jax_new_map))
    if spec["mode"] == "stereo":
        from rumi_slam_tpu_torch.ops import stereo

        img_l, img_r, _ = seq.frame_stereo(0, slam.cfg.camera.baseline)
        fl, fr = slam._extract(img_l), slam._extract(img_r)
        r["match_stereo_ms"] = cuda_time_ms(
            lambda: stereo.match_stereo(fl, fr, slam.cfg.camera.bf))
        r["match_stereo_shape"] = [fl.uv.shape[0], fr.uv.shape[0]]
    emit(phase="depth_modes", **r)
    if r["ok_share"] < r["bounds"]["ok_share_min"]:
        raise RuntimeError(f"{name}: OK share {r['ok_share']} below {jax_ok - 0.05}")
    if not d["ate_unscaled"] <= bound:
        raise RuntimeError(f"{name}: ATE without scale {d['ate_unscaled']} m above {bound} m")
    if not d["ate_unscaled"] < max(2.0 * d["ate"], bound):
        raise RuntimeError(f"{name}: not at metric scale: {d['ate_unscaled']} m without scale, "
                           f"{d['ate']} m with")
    if launches["fused_match"] < tracked:
        raise RuntimeError(f"{name}: {launches['fused_match']} gated launches for {tracked} "
                           "frames tracked in OK")
    if jax_new_map is not None and (slam.stats["n_new_maps"] != 1 or len(d["new_map_frames"]) != 1
                                    or abs(d["new_map_frames"][0] - jax_new_map) > 1):
        raise RuntimeError(f"{name}: new submap on {d['new_map_frames']}, JAX on {jax_new_map}")
    return r


def camera_models_on_card(device="cuda"):
    """``_extract`` on one 640x480 frame on ``device`` and on the CPU under
    TUM1's radtan camera and a KB8 camera: rows whose raw keypoint is the
    same on both (valid in both) must be rectified to within RECTIFY_ATOL_PX;
    ``undistort_points`` and ``kb8.unproject`` on 1024 seeded points, card
    against CPU."""
    import dataclasses

    import torch

    from rumi_slam_tpu_torch.config import Config
    from rumi_slam_tpu_torch.geometry import camera_kb8, distortion
    from rumi_slam_tpu_torch.io import settings
    from rumi_slam_tpu_torch.io.synthetic import SyntheticSequence
    from rumi_slam_tpu_torch.system import SlamSystem

    tum1 = settings.preset("tum1")
    configs = {
        "radtan": dataclasses.replace(tum1, camera=dataclasses.replace(
            tum1.camera, **dict(zip(("k1", "k2", "p1", "p2", "k3"), TUM1_RADTAN)))),
        "kb8": dataclasses.replace(Config(), camera=dataclasses.replace(
            Config().camera, model="kb8", kb_coeffs=KB8_COEFFS)),
    }
    out = {}
    for name, cfg in configs.items():
        c = cfg.camera
        img = SyntheticSequence(n_frames=1, width=c.width, height=c.height,
                                K=cfg.intrinsics(), seed=4).frame(0)[0]
        systems = {"card": SlamSystem(cfg, device=device), "cpu": SlamSystem(cfg, device="cpu")}
        raw = {k: s.extractor(img.to(s.device)) for k, s in systems.items()}
        rect = {k: s._extract(img.to(s.device)) for k, s in systems.items()}
        common = ((raw["card"].uv.cpu() == raw["cpu"].uv).all(1) & raw["card"].valid.cpu()
                  & raw["cpu"].valid)
        gap = float((rect["card"].uv.cpu() - rect["cpu"].uv)[common].abs().max())
        moved = float((rect["cpu"].uv - raw["cpu"].uv)[common].norm(dim=1).max())
        out[name] = dict(valid=[int(raw["card"].valid.sum()), int(raw["cpu"].valid.sum())],
                         common_rows=int(common.sum()), max_gap_px=gap, max_moved_px=moved)
        if not gap <= RECTIFY_ATOL_PX or common.sum() < 0.9 * raw["cpu"].valid.sum():
            raise RuntimeError(f"_extract under {name} on the card against the CPU: {out[name]}")
    rng = np.random.default_rng(0)
    uv = torch.from_numpy(rng.uniform([0, 0], [640, 480], (1024, 2)).astype(np.float32))
    K = configs["radtan"].intrinsics()
    dist = torch.tensor(TUM1_RADTAN, dtype=torch.float32)
    P8 = torch.cat([Config().intrinsics(), torch.tensor(KB8_COEFFS)])
    fns = {"undistort_points": lambda d: distortion.undistort_points(K.to(d), dist.to(d), uv.to(d)),
           "kb8_unproject": lambda d: camera_kb8.unproject(P8.to(d), uv.to(d))}
    for name, fn in fns.items():
        gap = float((fn(device).cpu() - fn("cpu")).abs().max())
        out[name] = dict(points=1024, max_gap=gap)
        if not gap <= RECTIFY_ATOL_PX:
            raise RuntimeError(f"{name} on the card against the CPU: largest gap {gap}")
    emit(phase="camera_models", **out)
    return out


def phase_depth_modes():
    """Phase 11: RGB-D, stereo and RGB-D with a loss at full width, then the
    camera models on the card."""
    runs = {name: depth_run(name) for name in DEPTH_RUNS}
    camera_models_on_card()
    return runs


# Phase 12: the evaluation harness, the native edge runtime and the inertial
# solvers.  (a) and (a') replay phase 6's first frames written to disk as 8-bit
# PGM in TUM layout through ``examples/run_tum.run_paced`` (the native reader
# and ring; PIL and matplotlib stay off this path) and the driver's export;
# (a) paces the replay at twice phase 6's measured time a frame in the same
# call, so the tracker keeps up and is held to phase 6's bounds over the
# frames it tracked; (a') replays at real time, which the tracker cannot keep
# up with: the ring must drop frames and count them.  (b) is
# ``harness.run_once`` over ``tests/torch_harness_drive.py``'s scenario (a
# ``GroundtruthSequence`` along a handheld sweep at ``Config()`` widths,
# rumination on), held to the JAX package's row of the same drive
# (``tests/torch_harness_floor.json``, "full": CPU, 59 of 60 frames OK, 21
# keyframes, keyframe ATE 0.002326 m) with phase 6's margins.  (c) is the
# visual-inertial window of ``tests/torch_inertial_window.py`` (10 keyframes,
# 200 Hz IMU with 50 samples an interval, 2000 points with 8 observations
# each, 1024 points for the pose solve), solved on the card and on the CPU.
TUM_FRAMES = 60
REALTIME_FRAMES = 30
TUM_YAML = ("%YAML:1.0\n"
            "Camera1.fx: 525.0\nCamera1.fy: 525.0\nCamera1.cx: 319.5\nCamera1.cy: 239.5\n"
            "Camera.width: 640\nCamera.height: 480\nCamera.fps: 30\n"
            "ORBextractor.nFeatures: 1024\nORBextractor.nLevels: 8\n")
# (c) the card against the CPU on the same inputs: orientations, positions and
# points (quaternion components and metres), velocities (m/s), scale and the
# window BA's final cost (relative).  The H100 (700 W) read at most 1.2e-6 in
# gravity, 4.2e-7 in poses, 4.8e-6 in points, 3.6e-7 m/s, 1.9e-7 in scale and
# 4e-7 in cost; the limits are about 20-100 times that.
VI_POSE_ATOL = 1e-4
VI_VEL_ATOL = 1e-3
VI_SCALE_RTOL = 1e-5
VI_COST_RTOL = 1e-4


def _recording_slam():
    """``SlamSystem`` that keeps each frame's state letter in ``states``."""
    from rumi_slam_tpu_torch.system import SlamSystem

    class RecordingSlam(SlamSystem):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.states = []

        def track_monocular(self, img, t):
            st = super().track_monocular(img, t)
            self.states.append(_LETTER[st.name])
            return st

    return RecordingSlam


def write_tum_layout(root, n_frames):
    """Phase 6's first ``n_frames`` frames as 8-bit PGM in TUM layout, with
    rgb.txt, groundtruth.txt (``io/trajectory.save_tum``) and a settings
    YAML for the synthetic camera; returns the YAML's path."""
    import torch

    from rumi_slam_tpu_torch.config import Config
    from rumi_slam_tpu_torch.io import trajectory
    from rumi_slam_tpu_torch.io.synthetic import SyntheticSequence

    cfg = Config()
    c = cfg.camera
    seq = SyntheticSequence(n_frames=n_frames, width=c.width, height=c.height,
                            K=cfg.intrinsics("cuda"), seed=4, device="cuda")
    os.makedirs(os.path.join(root, "rgb"))
    lines = []
    for i in range(n_frames):
        img, t = seq.frame(i)
        arr = torch.clamp(torch.round(img), 0, 255).to(torch.uint8).cpu().numpy()
        name = f"rgb/{t:.6f}.pgm"
        with open(os.path.join(root, name), "wb") as f:
            f.write(f"P5\n{arr.shape[1]} {arr.shape[0]}\n255\n".encode() + arr.tobytes())
        lines.append(f"{t:.6f} {name}")
    with open(os.path.join(root, "rgb.txt"), "w") as f:
        f.write("# color images\n" + "\n".join(lines) + "\n")
    trajectory.save_tum(os.path.join(root, "groundtruth.txt"), seq.times,
                        torch.stack(seq.poses_gt).cpu().numpy())
    yaml = os.path.join(root, "cam.yaml")
    with open(yaml, "w") as f:
        f.write(TUM_YAML)
    return yaml


def tum_replay(name, data_root, yaml, pace, out_dir):
    """``run_paced`` + ``export`` (no plots) of the sequence at ``data_root``
    on the card, phase 6's configuration read from ``yaml``."""
    import csv
    import dataclasses

    import torch

    from rumi_slam_tpu_torch.config import Config
    from rumi_slam_tpu_torch.evaluation.harness import RESULT_COLUMNS
    from rumi_slam_tpu_torch.examples import run_tum
    from rumi_slam_tpu_torch.io import datasets
    from rumi_slam_tpu_torch.ops import fused_matcher as fm

    cfg = run_tum.load_config(yaml, rgbd=False)
    cfg = dataclasses.replace(cfg, mapping=dataclasses.replace(
        cfg.mapping, loop_closing=False, overlapped=False))
    phase6 = Config()
    phase6 = dataclasses.replace(phase6, mapping=dataclasses.replace(
        phase6.mapping, loop_closing=False, overlapped=False))
    if cfg != phase6:
        raise RuntimeError(f"{name}: the settings file does not give phase 6's configuration")
    seq = datasets.TumSequence(data_root)
    slam = _recording_slam()(cfg, device="cuda")
    # the main path: the launch counters start at 0 here
    fm.fused_match.launches = 0
    fm.match_bank.launches = 0
    t0 = time.perf_counter()
    drops, n_tracked = run_tum.run_paced(slam, None, seq, data_root, pace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fused_match": fm.fused_match.launches, "match_bank": fm.match_bank.launches}
    row = run_tum.export(slam, None, seq, out_dir,
                         {"dataset": name, "runtime_s": wall, "drops": drops,
                          "n_tracked": n_tracked}, plots=False)
    with open(os.path.join(out_dir, "result.csv")) as f:
        header = next(csv.reader(f))
    states = "".join(slam.states)
    return dict(run=name, frames=len(seq), pace=pace,
                replay_interval_ms=1e3 * float(np.median(np.diff(seq.times))) / pace,
                drops=drops, n_tracked=n_tracked, states=states,
                ok_share_tracked=states.count("O") / max(n_tracked, 1), n_kf=slam.stats["n_kf"],
                ate_m=row.get("ate"), rate=row.get("rate"), wall_s=wall,
                ms_per_tracked_frame=1e3 * wall / max(n_tracked, 1),
                result_csv_columns_ok=header == RESULT_COLUMNS,
                launches_fused_match=launches["fused_match"],
                launches_match_bank=launches["match_bank"], tracked_in_ok=tracked_in_ok(slam),
                stage_ms=slam.timer.stats())


def harness_run_once():
    """(b): ``run_once`` of ``tests/torch_harness_drive.py``'s scenario on the
    card; the facade ``run_once`` builds is recorded for its stage times."""
    import torch

    import rumi_slam_tpu_torch.system as system_mod
    from rumi_slam_tpu_torch.ops import fused_matcher as fm

    drive = tests_module("torch_harness_drive")
    made = []
    base = system_mod.SlamSystem

    class Recorded(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    fm.fused_match.launches = 0
    fm.match_bank.launches = 0
    system_mod.SlamSystem = Recorded
    try:
        row = drive.run("rumi_slam_tpu_torch", device="cuda")
    finally:
        system_mod.SlamSystem = base
    torch.cuda.synchronize()
    slam, = made
    jax_row = json.loads(drive.FLOOR.read_text())["full"]
    return dict(row, launches_fused_match=fm.fused_match.launches,
                launches_match_bank=fm.match_bank.launches, tracked_in_ok=tracked_in_ok(slam),
                stage_ms=slam.timer.stats(),
                jax=dict(ok_share=jax_row["ok_share"], ate_m=jax_row["ate"],
                         n_kf=jax_row["n_kf"]),
                bounds=dict(ok_share_min=jax_row["ok_share"] - 0.05,
                            ate_max_m=1.5 * jax_row["ate"] + 0.01))


def inertial_window_on_card():
    """(c): the three inertial solvers on the card and on the CPU, the same
    numpy inputs; events around one more call of each on the card."""
    import torch

    from rumi_slam_tpu_torch.geometry import lie
    from rumi_slam_tpu_torch.inertial import preintegration as P

    W = tests_module("torch_inertial_window")
    win = W.window(0)
    t_gpu, t_cpu = W.to_device(win, "cuda"), W.to_device(win, "cpu")
    card = W.solve_all(t_gpu, "cuda")
    cpu = W.solve_all(t_cpu, "cpu")
    ms = {}
    for name, fn in W.solvers(t_gpu, "cuda").items():
        if name != "inertial_only_0":
            ms[name] = cuda_time_ms(fn, reps=1, warmup=0)
    ms["preintegrate_9x50"] = cuda_time_ms(lambda: W.to_device(win, "cuda"), reps=1, warmup=0)

    def gap(x, y):
        return float((x.detach().cpu() - y.detach()).abs().max())

    io, io0, pose, vi = (card[k] for k in ("inertial_only", "inertial_only_0", "pose_inertial",
                                            "visual_inertial_ba"))
    cio, cpose, cvi = (cpu[k] for k in ("inertial_only", "pose_inertial", "visual_inertial_ba"))
    g0 = P.gravity_vector(io.q_wg)
    r = dict(
        shapes=dict(n_kf=len(win["qs"]), imu_samples=list(win["imu"][0].shape[:2]),
                    points=len(win["X"]), observations=len(win["uv"]),
                    pose_points=len(win["pose_X"])),
        ms_per_call=ms,
        inertial_only=dict(scale=float(io.scale), scale_cpu=float(cio.scale),
                           cost=float(io.cost), cost_initial=float(io0.cost),
                           gravity_gap=gap(lie.quat_rotate(io.q_wg, g0),
                                           lie.quat_rotate(cio.q_wg, g0.cpu())),
                           velocity_gap=gap(io.velocities, cio.velocities),
                           scale_error=abs(float(io.scale) - W.TRUE_SCALE)),
        pose_inertial=dict(q_gap=gap(pose.q_wb, cpose.q_wb), p_gap=gap(pose.p_wb, cpose.p_wb),
                           v_gap=gap(pose.v, cpose.v), n_inliers=int(pose.n_inliers),
                           n_inliers_cpu=int(cpose.n_inliers),
                           p_error_m=float((pose.p_wb.cpu() - t_cpu["ps"][-1]).norm())),
        visual_inertial_ba=dict(q_gap=gap(vi.q_wb, cvi.q_wb), p_gap=gap(vi.p_wb, cvi.p_wb),
                                v_gap=gap(vi.v, cvi.v), points_gap=gap(vi.points, cvi.points),
                                cost=float(vi.cost), cost_initial=float(vi.cost0),
                                cost_cpu=float(cvi.cost),
                                p_error_before_m=float(np.abs(win["p0"] - win["ps"]).max()),
                                p_error_after_m=float((vi.p_wb.cpu() - t_cpu["ps"]).abs().max())))
    fails = []
    a_io, a_po, a_vi = r["inertial_only"], r["pose_inertial"], r["visual_inertial_ba"]
    if not abs(a_io["scale"] - a_io["scale_cpu"]) <= VI_SCALE_RTOL * a_io["scale_cpu"]:
        fails.append("inertial_only scale")
    if not (a_io["gravity_gap"] <= VI_POSE_ATOL * 9.81 and a_io["velocity_gap"] <= VI_VEL_ATOL):
        fails.append("inertial_only gravity or velocities")
    if not a_io["cost"] <= a_io["cost_initial"]:
        fails.append("inertial_only cost rose")
    if not max(a_po["q_gap"], a_po["p_gap"]) <= VI_POSE_ATOL or not a_po["v_gap"] <= VI_VEL_ATOL:
        fails.append("pose_inertial state")
    if a_po["n_inliers"] != a_po["n_inliers_cpu"]:
        fails.append("pose_inertial inliers")
    if not (max(a_vi["q_gap"], a_vi["p_gap"], a_vi["points_gap"]) <= VI_POSE_ATOL
            and a_vi["v_gap"] <= VI_VEL_ATOL):
        fails.append("visual_inertial_ba state")
    if not abs(a_vi["cost"] - a_vi["cost_cpu"]) <= VI_COST_RTOL * a_vi["cost_cpu"]:
        fails.append("visual_inertial_ba cost")
    if not a_vi["cost"] <= a_vi["cost_initial"]:
        fails.append("visual_inertial_ba cost rose")
    r["failed"] = fails
    return r


def phase_harness(drive):
    """Phase 12: (a) paced TUM replay, (a') real-time replay, (b) run_once,
    (c) the visual-inertial window; ``drive`` is phase 6's result."""
    import shutil
    import tempfile

    from rumi_slam_tpu_torch.runtime import native

    if not native.available():
        raise RuntimeError(f"the native runtime did not build: {native.build_log[-1000:]}")
    out = {}
    ms6 = 1e3 * drive["wall_s"] / drive["frames"]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tum_")
    try:
        data = os.path.join(tmp, "seq")
        os.makedirs(data)
        yaml = write_tum_layout(data, TUM_FRAMES)
        # (a): the replay interval is twice phase 6's time a frame
        pace = (1.0 / 30.0) / (2.0 * ms6 / 1e3)
        a = tum_replay("tum_paced", data, yaml, pace, os.path.join(tmp, "out_paced"))
        a.update(phase6_ms_per_frame=ms6,
                 bounds=dict(ok_share_min=JAX_DRIVE_OK_SHARE - 0.05,
                             ate_max_m=1.5 * JAX_DRIVE_ATE_M + 0.01))
        emit(phase="harness", part="a", **a)
        if a["drops"] + a["n_tracked"] != TUM_FRAMES:
            raise RuntimeError(f"(a): {a['drops']} drops + {a['n_tracked']} tracked != {TUM_FRAMES}")
        if a["ok_share_tracked"] < a["bounds"]["ok_share_min"]:
            raise RuntimeError(f"(a): OK share {a['ok_share_tracked']} of the tracked frames")
        if not (a["ate_m"] is not None and a["ate_m"] <= a["bounds"]["ate_max_m"]):
            raise RuntimeError(f"(a): ATE {a['ate_m']} m above {a['bounds']['ate_max_m']} m")
        if not a["result_csv_columns_ok"]:
            raise RuntimeError("(a): result.csv does not have RESULT_COLUMNS")
        if a["launches_fused_match"] < a["tracked_in_ok"]:
            raise RuntimeError(f"(a): {a['launches_fused_match']} gated launches for "
                               f"{a['tracked_in_ok']} frames tracked in OK")
        out["tum_paced"] = a
        # (a'): the first REALTIME_FRAMES frames at real time
        rt = os.path.join(tmp, "realtime")
        os.makedirs(rt)
        with open(os.path.join(data, "rgb.txt")) as f:
            rows = [ln for ln in f if not ln.startswith("#")][:REALTIME_FRAMES]
        with open(os.path.join(rt, "rgb.txt"), "w") as f:
            f.writelines(ln.replace(" rgb/", " ../seq/rgb/") for ln in rows)
        a2 = tum_replay("tum_realtime", rt, yaml, 1.0, os.path.join(tmp, "out_realtime"))
        emit(phase="harness", part="a_realtime", **a2)
        if not (a2["drops"] > 0 and a2["drops"] + a2["n_tracked"] == REALTIME_FRAMES):
            raise RuntimeError(f"(a'): {a2['drops']} drops, {a2['n_tracked']} tracked of "
                               f"{REALTIME_FRAMES} at real time")
        out["tum_realtime"] = a2
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    b = harness_run_once()
    emit(phase="harness", part="b", **b)
    if b["ok_share"] < b["bounds"]["ok_share_min"]:
        raise RuntimeError(f"(b): OK share {b['ok_share']} below {b['bounds']['ok_share_min']}")
    if not b["ate"] <= b["bounds"]["ate_max_m"]:
        raise RuntimeError(f"(b): ATE {b['ate']} m above {b['bounds']['ate_max_m']} m")
    if not b["rss_mb"] > 0:
        raise RuntimeError(f"(b): rss_mb {b['rss_mb']}")
    if b["launches_fused_match"] < b["tracked_in_ok"]:
        raise RuntimeError(f"(b): {b['launches_fused_match']} gated launches for "
                           f"{b['tracked_in_ok']} frames tracked in OK")
    out["run_once"] = b
    c = inertial_window_on_card()
    emit(phase="harness", part="c", **c)
    if c["failed"]:
        raise RuntimeError(f"(c): {c['failed']}")
    out["inertial"] = c
    return out


def kernel_entry(name, shape_result, launches, launches_by_path, all_results):
    """One entry of the ``kernels`` line: the times and the bound at the
    main path's shape, the largest error over every shape compared."""
    return {
        "name": name,
        "route": "cuda",
        "source": "rumi_slam_tpu_torch/csrc/fused_match.cu",
        "replaces": "rumi_slam_tpu/ops/pallas_matcher.py:35",
        "launches": launches,
        "launches_by_path": launches_by_path,
        "max_abs_err": max(r["max_abs_err"] for r in all_results),
        "shape": {k: shape_result[k] for k in ("F", "P", "valid_points")},
        "ms": shape_result["kernel_ms"],                # events around one call of the wrapper
        "plain_ms": shape_result["plain_ms"],
        "graph_ms": shape_result["kernel_graph_ms"],    # device time, from a CUDA graph
        "plain_graph_ms": shape_result["plain_graph_ms"],
        "bound_ms": shape_result["bound_ms"],
        "bound_by": shape_result["bound_by"],
        "bound_ms_tensor": shape_result.get("bound_ms_tensor"),   # gate-off only
        "library_ms": None,   # no single PyTorch call computes either function
    }


def sweep_blocks_per_sm():
    """Device time of both instantiations (from a CUDA graph) with the grid
    planned for 2 to 64 blocks an SM, at phase 3's main-path shapes."""
    from rumi_slam_tpu_torch.ops import fused_matcher as fm

    g = matcher_problem(1024, 16384, 16384, seed=1, device="cuda", cluster_px=160.0)
    problems = {"fused_match 1024x16384 all valid, clustered":
                lambda: fm.fused_match(*g[:4], 15.0, *g[4:])}
    for n_valid in (21 * 1024, 262144):
        b = bank_problem(1024, 262144, n_valid, seed=1024 + n_valid, device="cuda")
        problems[f"match_bank 1024x262144, first {n_valid} rows in use"] = (
            lambda b=b: fm.match_bank(*b, n_chunks=16, max_dist=80.0, ratio=0.9))
    default = fm.BLOCKS_PER_SM
    for name, fn in problems.items():
        times = {}
        for turn in range(2):
            for n in (2, 4, 8, 16, 32, 64):
                fm.BLOCKS_PER_SM = n
                times.setdefault(n, []).append(cuda_graph_ms(fn))
        fm.BLOCKS_PER_SM = default
        emit(sweep="blocks_per_sm", problem=name, default=default, graph_ms_runs=times)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import rumi_slam_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    smi = phase_device()
    phase_build()
    if sys.argv[1:] == ["--sweep-blocks-per-sm"]:
        sweep_blocks_per_sm()
        print(smi, flush=True)
        return 0
    seconds = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        seconds[name] = round(time.perf_counter() - t0, 1)
        return out

    gated, bank = timed("3_kernel", phase_kernel)
    main_path = timed("4_main_path", phase_main_path)
    timed("5_tracked_sequence", phase_tracked_sequence)
    drive, slam = timed("6_slam_drive", phase_slam_drive)
    overlapped = timed("7_overlapped_mapping", phase_overlapped_mapping)
    reloc = timed("8_reloc_drive", phase_reloc_drive)
    known = timed("9_known_answers", phase_known_answers, slam)
    rumi = timed("10_rumination", phase_rumination)
    depth = timed("11_depth_modes", phase_depth_modes)
    harness = timed("12_harness", phase_harness, drive)
    emit(phase_seconds=seconds)

    def by_path(key):
        paths = {"tracking_step": sum(r[key] for r in main_path.values()),
                 "slam_drive": drive[key], "overlapped_mapping": overlapped[key]}
        key = {"launches": "launches_fused_match"}.get(key, key)
        paths["reloc_drive"] = reloc[key]
        paths["known_answer_weld"] = known["weld"].get(key, 0)   # gate-off only
        for mode, r in rumi.items():
            paths[f"rumination_{mode}"] = r[key]
        for name, r in depth.items():
            paths[f"depth_{name}"] = r[key]
        for name in ("tum_paced", "tum_realtime", "run_once"):
            paths[name] = harness[name][key]
        return paths

    emit(kernels=[
        kernel_entry("fused_match", gated[0], drive["launches"], by_path("launches"), gated),
        kernel_entry("match_bank", bank[0], reloc["launches_match_bank"],
                     by_path("launches_match_bank"), bank),
    ])
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
