"""Profile the PyTorch port's monocular SLAM facade on one GPU.

    python -m tools.profile_torch_slam [--frames 60] [--lost-span FIRST END] [--ruminate]
        [--mode mono|rgbd|stereo]

Runs the drive of ``chip_smoke.py`` phase 6 (``SlamSystem.track_monocular``
over ``SyntheticSequence(seed=4)`` at the full ``Config()`` size, loop
closing off, synchronous mapping) twice, each time on a fresh system: once
for the wall time, once under ``torch.profiler``, where each ``StageTimer``
stage is the program's own ``record_function`` range ``slam/<name>``.
Prints the device (kernel) time of the drive over its wall time without the
profiler as the device busy share; per stage, its host time and the kernel
time launched in it, both under the profiler; the kernel launches, syncs and
copies; then the kernels with the most device time and the operators with
the most host time.  Needs a CUDA device.

``--frames 80 --lost-span 20 22`` is the relocalisation drive of
``chip_smoke.py`` phase 8: the ``relocalize`` stage then shows the kernel time
of ``tracker.relocalize_map``.

``--mode rgbd`` / ``--mode stereo`` feed the same frames through
``track_rgbd`` / ``track_stereo`` with the depth camera of ``chip_smoke.py``
phase 11 (a) / (b) (``tests/torch_system_drive.py::depth_camera``: an 8 cm
baseline, depth in metres); the rendering of the depth map or the right
image is done once, before the timing, as the frames are.

``--ruminate`` is the rumination scenario of ``chip_smoke.py`` phase 10 (110
frames of the sweep sequence, frames 45..50 featureless, the clear-view
backend inline, loop closing on): the stages ``ruminate_bundle``,
``ruminate_backend``, ``ruminate_merge``, ``ruminate_gba`` and ``loop_closing``
appear beside the others, each with its kernel time, its host time and the
kernel launches made in it, and ``on_frame`` (the coordinator's stage around
its per-frame copy of the image to the host).  The profiler then runs only
from the frame before the loss to the frame after the rumination, and
``wall_s`` and the busy shares are those frames'; ``stage_wall`` is the
whole unprofiled drive.  The backend's offline system runs inside
``ruminate_backend``; its own stages are not split out.
"""

from __future__ import annotations

import argparse
import bisect
import dataclasses
import json
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from rumi_slam_tpu_torch.config import Config
from rumi_slam_tpu_torch.io.synthetic import SyntheticSequence
from rumi_slam_tpu_torch.system import SlamSystem


def drive(cfg, seq, ruminate=None, prof=None, window=None, mode="mono"):
    """Run the drive on a fresh system; returns (system, wall seconds).
    ``mode``: ``seq.frame(i)`` is fed to ``track_monocular``, ``track_rgbd`` or
    ``track_stereo``.
    ``ruminate``: the clean sequence of the rumination scenario, or None.
    ``prof``: a profiler to run over the frames ``window = (first, last)``
    (the whole drive if None); the drive ends with the window."""
    slam = SlamSystem(cfg, device="cuda")
    track = {"mono": slam.track_monocular, "rgbd": slam.track_rgbd,
             "stereo": slam.track_stereo}[mode]
    coord = None
    if ruminate is not None:
        import chip_smoke

        coord = chip_smoke.clear_view_coordinator(slam, cfg, ruminate)
    first, last = window or (0, len(seq) - 1)
    slam.frame_s = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(last + 1):
        if prof is not None and i == first:
            torch.cuda.synchronize()
            slam.timer.samples.clear()      # stage times of the window only
            prof.start()
        t = time.perf_counter()
        track(*seq.frame(i))
        if coord is not None:
            coord.maybe_ruminate()
        slam.frame_s.append(time.perf_counter() - t)
    torch.cuda.synchronize()
    if prof is not None:
        prof.stop()
    if coord is not None:
        slam.rumination_history = coord.history
    return slam, time.perf_counter() - t0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--lost-span", type=int, nargs=2, metavar=("FIRST", "END"),
                    help="render frames FIRST <= i < END featureless")
    ap.add_argument("--ruminate", action="store_true",
                    help="the rumination scenario of chip_smoke.py phase 10")
    ap.add_argument("--mode", choices=("mono", "rgbd", "stereo"), default="mono",
                    help="the input of chip_smoke.py phase 11 (a) rgbd, (b) stereo")
    a = ap.parse_args()
    if a.ruminate and a.mode != "mono":
        raise SystemExit("profile_torch_slam: --ruminate drives the monocular input")
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_slam: no CUDA device")
    clean = None
    if a.ruminate:
        import chip_smoke

        cfg = chip_smoke.rumination_config()
        seq = chip_smoke.rumination_sequence(cfg, chip_smoke.RUMI_LOST_SPAN)
        clean = chip_smoke.rumination_sequence(cfg, None)
    else:
        cfg = Config()
        cfg = dataclasses.replace(cfg, mapping=dataclasses.replace(
            cfg.mapping, loop_closing=False, overlapped=False))
        if a.mode != "mono":
            import chip_smoke

            cfg = chip_smoke.tests_module("torch_system_drive").depth_camera(cfg)
        c = cfg.camera
        seq = SyntheticSequence(n_frames=a.frames, width=c.width, height=c.height,
                                K=cfg.intrinsics("cuda"), seed=4, device="cuda",
                                lost_span=tuple(a.lost_span) if a.lost_span else None)
    render = {"mono": seq.frame, "rgbd": seq.frame_rgbd,
              "stereo": lambda i: seq.frame_stereo(i, cfg.camera.baseline)}[a.mode]
    frames = [render(i) for i in range(len(seq))]   # render once, outside the timing
    seq.frame = lambda i: frames[i]

    drive(cfg, seq, ruminate=clean, window=(0, 12), mode=a.mode)  # warm-up (build, caches)
    slam, wall = drive(cfg, seq, ruminate=clean, mode=a.mode)
    window = None
    if a.ruminate:
        # profile from the frame before the loss to the frame after the one
        # that ran the rumination: a whole drive's events are too many
        ran = max(range(len(frames)), key=lambda i: slam.frame_s[i])
        window = (chip_smoke.RUMI_LOST_SPAN[0] - 1, min(ran + 1, len(frames) - 1))
        wall = sum(slam.frame_s[window[0]:window[1] + 1])
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    slam_p, wall_p = drive(cfg, seq, ruminate=clean, prof=prof, window=window, mode=a.mode)
    if window is not None:
        wall_p = sum(slam_p.frame_s[window[0]:window[1] + 1])
    ka = prof.key_averages()
    # the stage ranges appear on the device timeline as annotations: keep
    # them out of the kernel sums, and attribute each kernel to the stage
    # range that holds its start
    kernels, ranges = [], []
    n_by_stage = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        if e.name.startswith("slam/"):
            ranges.append((e.time_range.start, e.time_range.end, e.name[len("slam/"):]))
        else:
            kernels.append((e.time_range.start, e.time_range.end - e.time_range.start))
    ranges.sort()
    starts = [r[0] for r in ranges]
    dev_by_stage = {}
    for t0, dur in kernels:
        # the innermost stage range that holds the kernel's start (stages
        # nest: ``loop_closing`` runs inside ``keyframe``)
        i = bisect.bisect_right(starts, t0) - 1
        while i >= 0 and t0 >= ranges[i][1] and starts[i] > t0 - 120e6:
            i -= 1
        name = ranges[i][2] if i >= 0 and t0 < ranges[i][1] else "outside stages"
        dev_by_stage[name] = dev_by_stage.get(name, 0.0) + dur
        n_by_stage[name] = n_by_stage.get(name, 0) + 1
    dev_us = sum(d for _, d in kernels)
    launches = sum(e.count for e in ka if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                                     "cudaLaunchKernelExC"))
    stages = {}
    for name, st in slam_p.timer.stats().items():
        dev_s = dev_by_stage.get(name, 0.0) / 1e6
        stages[name] = {"n": st["n"], "host_s_profiled": st["total_s"], "device_s": dev_s,
                        "device_busy_share_profiled": dev_s / st["total_s"],
                        "kernels": n_by_stage.get(name, 0)}
    stages["outside stages"] = {"device_s": dev_by_stage.get("outside stages", 0.0) / 1e6}
    print(json.dumps({
        "mode": a.mode, "frames": len(frames), "profiled_frames": list(window or (0, len(frames) - 1)),
        "n_kf": slam.stats["n_kf"],
        "rumination_history": getattr(slam, "rumination_history", None),
        "wall_s": wall, "wall_s_profiled": wall_p, "device_busy_s": dev_us / 1e6,
        "device_busy_share": dev_us / 1e6 / wall,
        "device_busy_share_profiled": dev_us / 1e6 / wall_p,
        "kernel_launches_per_frame": launches / (
            window[1] - window[0] + 1 if window else len(frames)),
        "stage_wall": slam.timer.stats(), "stage_profiled": stages,
        "syncs_and_copies": {e.key: e.count for e in ka
                             if "Synchronize" in e.key or "memcpy" in e.key.lower()},
    }))
    sort_dev = "self_device_time_total" if hasattr(ka[0], "self_device_time_total") \
        else "self_cuda_time_total"
    print(ka.table(sort_by=sort_dev, row_limit=30))
    print(ka.table(sort_by="self_cpu_time_total", row_limit=25))


if __name__ == "__main__":
    main()
