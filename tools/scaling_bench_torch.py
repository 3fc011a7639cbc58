"""Sharded-BA scaling on one GPU: the port's counterpart of
``tools/scaling_bench.py``.

The same problem as the JAX bench (``build_problem``): 128 cameras along a
trajectory, 131,072 points each seen by 8 consecutive cameras (1,048,576
observations), seed 0, perturbed with seed 1, K = [200, 200, 127.5, 95.5];
``parallel.sharded_ba.sharded_bundle_adjust_pcg`` with 32 CG iterations and
2 LM iterations a timed call.  Two measured sections:

1. ``one_card_shard_rows``: D = 1/2/4/8 shards batched on the one card
   (``BaMesh(device, D)``): the same work in D blocks, with the cost and
   the peak memory of each;
2. ``work_scaling_rows``: one device timing the per-shard program at P/D
   points, what each card of a D-card host would run.

Times are CUDA events around each call, the median of 3 after a warm call,
divided by the LM iterations.  The JAX bench's model of TPU ICI links has
no counterpart here.  ``SCALING.json`` holds the JAX package's figures (a
virtual CPU mesh); this tool prints its JSON, or writes it to ``--out``.

    python tools/scaling_bench_torch.py [--out PATH] [--profile | --spread]

``--profile`` instead runs one call at D=1 under ``torch.profiler``: the
kernel time against the call's time, the launches, the top kernels.
``--spread [--runs N --cams C --points P --iters I]`` runs both solvers N times on
``make_problem``'s construction, card against CPU, and prints the gaps.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_CAMS = 128
N_PTS = 131_072
OBS_PER_PT = 8          # every point seen by 8 consecutive cameras -> 1.05M obs
CG_ITERS = 32
LM_ITERS = 2            # per timed call; time is reported per LM iteration
K = [200.0, 200.0, 127.5, 95.5]


def build_problem(seed=0, *, n_cams=N_CAMS, n_pts=N_PTS, obs_per_pt=OBS_PER_PT, device="cuda"):
    """The JAX bench's trajectory and points, the same numpy draws in the
    same order, projected with the port's ``camera`` on ``device``.
    Returns (K tensor, poses [C,7] tensor, X, cam_g [P,R], uv_g [P,R,2],
    conf_g [P,R]) with the last four numpy."""
    from rumi_slam_tpu_torch.geometry import camera, lie

    rng = np.random.default_rng(seed)
    Kt = torch.tensor(K, device=device)
    poses = []
    for i in range(n_cams):
        q = lie.so3_exp(torch.from_numpy(rng.normal(scale=0.02, size=3).astype(np.float32)))
        poses.append(np.concatenate([
            q.numpy(), np.asarray([0.15 * i, 0.5 * np.sin(0.2 * i), 0.0], np.float32)]))
    poses = torch.from_numpy(np.stack(poses)).to(device)

    base = (np.arange(n_pts) * (n_cams - obs_per_pt) // n_pts).astype(np.int32)
    X = np.empty((n_pts, 3), np.float32)
    X[:, 0] = 0.15 * base + rng.uniform(-2, 4, n_pts)
    X[:, 1] = rng.uniform(-2, 2, n_pts)
    X[:, 2] = rng.uniform(2, 9, n_pts)

    cam_g = base[:, None] + np.arange(obs_per_pt)[None, :]      # [P,R]
    Xt = torch.from_numpy(X).to(device)
    uv_g = np.zeros((n_pts, obs_per_pt, 2), np.float32)
    for r in range(obs_per_pt):
        Xc = lie.se3_apply(poses[torch.from_numpy(cam_g[:, r]).to(device).long()], Xt)
        uv_g[:, r] = camera.project(Kt, Xc).cpu().numpy()
    uv_g += rng.normal(scale=0.5, size=uv_g.shape).astype(np.float32)
    conf_g = np.ones((n_pts, obs_per_pt), np.float32)
    return Kt, poses, X, cam_g.astype(np.int32), uv_g, conf_g


def perturb(poses, X, seed=1):
    """Cameras 2.. moved by 5 mrad / 5 mm, points by 2 cm (the JAX bench's)."""
    from rumi_slam_tpu_torch.geometry import lie

    rng = np.random.default_rng(seed)
    tau = torch.from_numpy(rng.normal(scale=0.005, size=(poses.shape[0], 6)).astype(np.float32))
    poses_n = lie.se3_retract(poses, tau.to(poses.device))
    poses_n[:2] = poses[:2]
    X_n = X + rng.normal(scale=0.02, size=X.shape).astype(np.float32)
    return poses_n, X_n


def shard_arrays(X, cam_g, uv_g, conf_g, D):
    """Round-robin point sharding (matches partition_problem_grouped)."""
    P = X.shape[0]
    Pl = (P + D - 1) // D
    R = cam_g.shape[1]
    pts = np.zeros((D, Pl, 3), np.float32)
    cam = np.zeros((D, Pl, R), np.int32)
    uv = np.zeros((D, Pl, R, 2), np.float32)
    conf = np.zeros((D, Pl, R), np.float32)
    for d in range(D):
        g = np.arange(d, P, D)
        pts[d, : len(g)] = X[g]
        cam[d, : len(g)] = cam_g[g]
        uv[d, : len(g)] = uv_g[g]
        conf[d, : len(g)] = conf_g[g]
    return (pts.reshape(D * Pl, 3), cam.reshape(D * Pl, R),
            uv.reshape(D * Pl, R, 2), conf.reshape(D * Pl, R))


def solve(K, poses_n, arrays, D, device, *, n_iters=LM_ITERS, cg_iters=CG_ITERS):
    """One call of the PCG solver over ``D`` shards on ``device``; returns a
    callable (so it can be timed) giving (poses, points_sh, cost)."""
    from rumi_slam_tpu_torch.parallel import distributed, sharded_ba

    mesh = distributed.BaMesh(device, D)
    pts, cam, uv, conf = (torch.from_numpy(a).to(device) for a in arrays)
    free = torch.arange(poses_n.shape[0], device=device) >= 2
    return lambda: sharded_ba.sharded_bundle_adjust_pcg(
        mesh, K, poses_n, pts, cam, uv, conf, free, n_iters=n_iters, cg_iters=cg_iters)


def time_call(fn, cuda, reps=3):
    """Median ms per LM iteration over ``reps`` calls after a warm call
    (CUDA events around each call with ``cuda``, else the host clock), every
    reading, the last call's result and the peak memory (MB, card only)."""
    import time

    out = fn()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(reps):
        if cuda:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / LM_ITERS)
        else:
            t0 = time.perf_counter()
            out = fn()
            times.append(1e3 * (time.perf_counter() - t0) / LM_ITERS)
    peak = torch.cuda.max_memory_allocated() / 1e6 if cuda else None
    return statistics.median(times), times, out, peak


def run(device="cuda", *, n_cams=N_CAMS, n_pts=N_PTS, obs_per_pt=OBS_PER_PT, shards=(1, 2, 4, 8),
        reps=3):
    """Both sections; returns the JSON-ready dict.  ``device="cuda"`` needs
    a card (a measurement never falls back to the CPU)."""
    cuda = torch.device(device).type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("scaling_bench_torch: no CUDA device")
    K_, poses, X, cam_g, uv_g, conf_g = build_problem(n_cams=n_cams, n_pts=n_pts,
                                                      obs_per_pt=obs_per_pt, device=device)
    poses_n, X_n = perturb(poses, X)
    rows = []
    for D in shards:
        ms, runs, (_, _, c), peak = time_call(
            solve(K_, poses_n, shard_arrays(X_n, cam_g, uv_g, conf_g, D), D, device), cuda, reps)
        rows.append({"shards": D, "ms_per_lm_iter": ms, "ms_per_lm_iter_runs": runs,
                     "cost": float(c), "peak_mem_mb": peak})
        print(f"[one card, D={D}] {ms:.3f} ms/LM-iter cost={float(c)}", file=sys.stderr,
              flush=True)
    work = []
    for D in shards:
        g = np.arange(0, n_pts, D)       # the shard device 0 would own
        ms, runs, _, peak = time_call(
            solve(K_, poses_n, shard_arrays(X_n[g], cam_g[g], uv_g[g], conf_g[g], 1), 1, device),
            cuda, reps)
        work.append({"shard_of": D, "points_on_device": len(g), "ms_per_lm_iter": ms,
                     "ms_per_lm_iter_runs": runs, "peak_mem_mb": peak})
        print(f"[work 1/{D} shard] {ms:.3f} ms/LM-iter", file=sys.stderr, flush=True)
    out = {
        "metric": "sharded_ba_one_card",
        "solver": "matrix-free PCG Schur (rumi_slam_tpu_torch.parallel.sharded_ba."
                  f"sharded_bundle_adjust_pcg), {CG_ITERS} CG iters/LM iter, "
                  f"{LM_ITERS} LM iters a timed call",
        "device": torch.cuda.get_device_name(0) if cuda else "cpu",
        "problem": {"cams": n_cams, "points": n_pts, "obs": int((conf_g > 0).sum())},
        "one_card_shard_rows": rows,
        "work_scaling_rows": work,
    }
    if cuda:
        out["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    return out


def profile(D=1, device="cuda"):
    """One call (``LM_ITERS`` LM iterations) at ``D`` shards under
    ``torch.profiler`` after a warm call: kernel time against the call's
    CUDA-event time, the launches, and the kernels that take the most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    K_, poses, X, cam_g, uv_g, conf_g = build_problem(device=device)
    poses_n, X_n = perturb(poses, X)
    fn = solve(K_, poses_n, shard_arrays(X_n, cam_g, uv_g, conf_g, D), D, device)
    ms, _, _, _ = time_call(fn, True, reps=1)
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.time_range.end - e.time_range.start for e in kernels) / 1e3
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + (e.time_range.end - e.time_range.start) / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    return {"shards": D, "ms_per_lm_iter_events": ms,
            "kernel_ms_per_lm_iter": dev_ms / LM_ITERS,
            "device_busy_share": dev_ms / LM_ITERS / ms,
            "kernels_per_lm_iter": len(kernels) / LM_ITERS,
            "top_kernels_ms_per_lm_iter": [
                {"name": n[:90], "count": c // LM_ITERS, "ms": t / LM_ITERS}
                for n, (c, t) in top]}


def spread(runs=6, device="cuda", n_cams=6, n_pts=64, n_iters=8):
    """Each sharded solver on ``tests/test_parallel.py::make_problem``'s
    construction (``tests/torch_parallel_problem.py``), ``runs`` times on the
    card against one CPU run: the largest pose, point and relative cost gaps
    (the limits of ``tests/test_torch_cuda.py::test_sharded_ba_on_card_equals_cpu``)."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                    "tests"))
    import torch_parallel_problem as P

    from rumi_slam_tpu_torch.parallel import distributed, sharded_ba

    prob = P.make_problem(n_cams=n_cams, n_pts=n_pts)
    out = []
    for solver, D in (("pcg", 1), ("pcg", 8), ("dense", 4)):
        args, _ = (P.pcg_inputs if solver == "pcg" else P.dense_inputs)(prob, D)
        fn = (sharded_ba.sharded_bundle_adjust_pcg if solver == "pcg"
              else sharded_ba.sharded_bundle_adjust)
        kw = dict(n_iters=n_iters, cg_iters=24) if solver == "pcg" else dict(n_iters=n_iters)

        def call(dev):
            t = [torch.tensor(P.K, device=dev), torch.from_numpy(prob[1]).to(dev)]
            return fn(distributed.BaMesh(dev, D), *t, *(torch.from_numpy(a).to(dev) for a in args),
                      **kw)

        pc, xc, cc = call("cpu")
        gaps = []
        for _ in range(runs):
            pg, xg, cg = call(device)
            gaps.append((float((pg.cpu() - pc).abs().max()), float((xg.cpu() - xc).abs().max()),
                         abs(float(cg) - float(cc)) / float(cc)))
        out.append({"solver": solver, "shards": D, "runs": runs, "cams": n_cams,
                    "points": n_pts, "lm_iters": n_iters, "pose_gaps": [g[0] for g in gaps],
                    "pose_gap_max": max(g[0] for g in gaps),
                    "point_gap_max": max(g[1] for g in gaps),
                    "cost_rel_gap_max": max(g[2] for g in gaps)})
    return out


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="write the JSON here (default: print it)")
    ap.add_argument("--profile", action="store_true",
                    help="instead: one call at D=1 under torch.profiler")
    ap.add_argument("--spread", action="store_true",
                    help="instead: card-against-CPU gaps of both solvers over --runs runs")
    ap.add_argument("--runs", type=int, default=6)
    ap.add_argument("--cams", type=int, default=6, help="--spread's problem: cameras")
    ap.add_argument("--points", type=int, default=64, help="--spread's problem: points")
    ap.add_argument("--iters", type=int, default=8, help="--spread's LM iterations")
    a = ap.parse_args()
    res = (profile() if a.profile else
           spread(a.runs, n_cams=a.cams, n_pts=a.points, n_iters=a.iters) if a.spread else run())
    if a.out:
        with open(a.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res), flush=True)
