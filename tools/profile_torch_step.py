"""Profile the PyTorch port's per-frame tracking step on one GPU.

    python -m tools.profile_torch_step [--features 2048] [--steps 5]

Runs ``rumi_slam_tpu_torch.step`` on the bench map under ``torch.profiler``
for a few steady-state frames and prints: wall time per frame without the
profiler, device (kernel) time per frame under it and their ratio as the
device busy share, the kernels with the most device time and the operators
with the most host time, and the host synchronisations and copies seen.
Also times the host cost of one tiny launch and of the 6x6 ``solve_ex`` used
by pose optimisation.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from rumi_slam_tpu_torch import step as S


def _dev_time(evt):
    return getattr(evt, "self_device_time_total", None) or getattr(evt, "self_cuda_time_total", 0)


def host_us_per_call(fn, n=2000):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return host


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--features", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=5)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_step: no CUDA device")

    step, frames, ms, pose = S.build_step(n_features=a.features, device="cuda", n_frames=8)

    def run():
        t0 = time.perf_counter()
        for i in range(a.steps):
            step(frames[i % len(frames)], ms, pose)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    run()
    wall = run()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_prof = run()
    ka = prof.key_averages()
    # kernel rows only: operator rows repeat their kernels' device time
    dev_us = sum(_dev_time(e) for e in ka if e.device_type == DeviceType.CUDA)
    launches = sum(e.count for e in ka if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                                     "cudaLaunchKernelExC"))
    syncs = {e.key: e.count for e in ka
             if "Synchronize" in e.key or "Memcpy" in e.key or "memcpy" in e.key.lower()}

    x = torch.zeros(8, device="cuda")
    H = torch.eye(6, device="cuda") * 2.0
    g = torch.ones(6, device="cuda")
    print(json.dumps({
        "features": a.features, "steps": a.steps,
        "wall_ms_per_frame": wall / a.steps * 1e3,
        "wall_ms_per_frame_profiled": wall_prof / a.steps * 1e3,
        "device_busy_ms_per_frame": dev_us / a.steps / 1e3,
        "device_busy_share": dev_us / 1e6 / wall,
        "kernel_launches_per_frame": launches / a.steps,
        "host_syncs_and_copies": syncs,
        "host_us_per_tiny_launch": host_us_per_call(lambda: x.add_(1.0)),
        "host_us_per_solve_ex_6x6": host_us_per_call(lambda: torch.linalg.solve_ex(H, g), 200),
    }))
    sort_dev = "self_device_time_total" if hasattr(ka[0], "self_device_time_total") \
        else "self_cuda_time_total"
    print(ka.table(sort_by=sort_dev, row_limit=40))
    print(ka.table(sort_by="self_cpu_time_total", row_limit=25))


if __name__ == "__main__":
    main()
