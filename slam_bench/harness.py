"""One run of one cell: set-up, the timed window, the traced span, the
check, and the result line.

A cell (``cells/<name>.json``) names a configuration (``configs/<name>.json``)
and a traffic mix (``traffic/<name>.json``, read by ``stream.Stream``) and
states the limits of its checks (``check.py``).  A cell with
``"truth_snapshot": true`` has the truth checks read the program's keyframes
and points at a fixed frame of the stream, once the mapping rounds of the
checked stretch's keyframes are adopted (``SlamSystem.ADOPT_AFTER`` frames
after the stretch), and not when the window closes, after as many rounds as
the host ran.  A configuration with
``"deterministic_algorithms": true`` runs under PyTorch's deterministic
algorithms (``torch.use_deterministic_algorithms``, warning where an
operation has no such version) from the system's build to the check.  The
metrics a run prints are those ``BENCHMARK.json`` gives the cell: each
end-to-end metric is read by ``end_to_end/<name>.py`` and each per-layer
metric by ``metrics/<name>.py``, a module with ``read(run) -> float | None``
(None: nothing to read, the metric is left out of the line).

The window drives the deployment's per-frame pair, as
``rumi_slam_tpu_torch.evaluation.harness.run_once`` does: the facade's call
for the configuration's sensor (``SlamSystem.track_monocular(frame, t)``,
``track_stereo(frame, right, t)`` or ``track_rgbd(frame, depth, t)``), then
``RuminationCoordinator.maybe_ruminate()``, with an ``AsyncRuminationShard``
on the same card and mapping as ``Config()`` sets it (overlapped, loop
closing on).  The loop is closed: a frame is handed in when the one before
it has returned.  A frame's latency runs from the hand-in to the return of
``maybe_ruminate``; the pose is on the host by then (the facade copies it
there), so no device-wide synchronisation is added per frame.  The window
ends with one synchronisation.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import subprocess
import sys
import threading
import time
import traceback
from collections import Counter
from pathlib import Path

import numpy as np

from . import check, stream as stream_mod

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "rumi_slam_tpu")
SPAN_AT = 0.4      # the profiled span starts at this share of the window ...
SPAN_S = 3.0       # ... and lasts this long at most


def load(kind: str, name: str) -> dict:
    return json.loads((HERE / kind / f"{name}.json").read_text())


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_metrics(bench: dict, cell: str):
    """(end-to-end names, per-layer names) that ``bench`` gives ``cell``."""
    def mine(m):
        return "workloads" not in m or cell in m["workloads"]
    return ([m["name"] for m in bench["end_to_end"] if mine(m)],
            [m["name"] for m in bench["per_layer"] if mine(m)])


def reader(kind: str, name: str):
    spec = importlib.util.spec_from_file_location(f"slam_bench.{kind}.{name}",
                                                  HERE / kind / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


SENSORS = ("monocular", "stereo", "rgbd")
CAMERA_TYPES = {"stereo": ("Rectified",), "rgbd": ("PinHole",)}


def sensor_of(c: dict) -> str:
    sensor = c.get("sensor", "monocular")
    if sensor not in SENSORS:
        raise ValueError(f"configuration: sensor {sensor!r} is not one of {SENSORS}")
    return sensor


def build_config(c: dict):
    """The port's ``Config`` from a configuration file's own values (the
    reference's settings keys); everything else is ``Config()``.

    ``"sensor"``: ``"monocular"`` (the default) reads ORB-SLAM2's monocular
    keys (``Camera.fx`` ... ``Camera.k3``).  ``"stereo"`` and ``"rgbd"`` read
    ORB-SLAM3's keys for a rectified pair or a pinhole camera
    (``Camera.type``, ``Camera1.fx/fy/cx/cy``, for RGB-D ``Camera1.k1, k2,
    p1, p2, k3``), ``Stereo.b`` (m), ``Stereo.ThDepth`` (in baselines, as
    ORB-SLAM's Tracking reads it: ``th_depth = b * ThDepth`` m) and, for
    RGB-D, ``RGBD.DepthMapFactor``."""
    from rumi_slam_tpu_torch.config import Config

    base = Config()
    sensor = sensor_of(c)
    size = dict(width=int(c["Camera.width"]), height=int(c["Camera.height"]),
                fps=float(c["Camera.fps"]))
    if sensor == "monocular":
        cam = dataclasses.replace(
            base.camera, fx=float(c["Camera.fx"]), fy=float(c["Camera.fy"]),
            cx=float(c["Camera.cx"]), cy=float(c["Camera.cy"]), **size,
            k1=float(c.get("Camera.k1", 0.0)), k2=float(c.get("Camera.k2", 0.0)),
            p1=float(c.get("Camera.p1", 0.0)), p2=float(c.get("Camera.p2", 0.0)),
            k3=float(c.get("Camera.k3", 0.0)))
    else:
        if c["Camera.type"] not in CAMERA_TYPES[sensor]:
            raise ValueError(f"configuration: Camera.type {c['Camera.type']!r} for a "
                             f"{sensor} sensor is not one of {CAMERA_TYPES[sensor]}")
        rgbd = {}
        if sensor == "rgbd":
            rgbd = {k: float(c.get(f"Camera1.{k}", 0.0)) for k in ("k1", "k2", "p1", "p2", "k3")}
            rgbd["depth_factor"] = float(c["RGBD.DepthMapFactor"])
        b = float(c["Stereo.b"])
        cam = dataclasses.replace(
            base.camera, fx=float(c["Camera1.fx"]), fy=float(c["Camera1.fy"]),
            cx=float(c["Camera1.cx"]), cy=float(c["Camera1.cy"]), **size, **rgbd,
            baseline=b, th_depth=b * float(c["Stereo.ThDepth"]))
    orb = dataclasses.replace(
        base.orb, n_features=int(c["ORBextractor.nFeatures"]),
        n_levels=int(c["ORBextractor.nLevels"]),
        scale_factor=float(c["ORBextractor.scaleFactor"]),
        ini_th_fast=float(c["ORBextractor.iniThFAST"]),
        min_th_fast=float(c["ORBextractor.minThFAST"]))
    mapping = dataclasses.replace(base.mapping, **c.get("assumed", {}).get("mapping", {}))
    return dataclasses.replace(base, camera=cam, orb=orb, mapping=mapping)


class Run:
    """What the readers see: ``frames`` [(k, t_in, t_out, state)] of the
    window, ``t0``/``t1`` its ends, ``window_s``, ``setup_s``; in a traced
    run ``spans`` [(stage, start, end, thread)], ``span`` (start, end) of the
    profiled span, ``trace`` (``trace.Profiled.summary``) and
    ``match_bounds_ms`` (one least time per gated matcher call in the span);
    ``ruminations`` [(t_submit, t_done, result)]."""

    def __init__(self):
        self.frames, self.spans, self.ruminations = [], [], []
        self.span = self.trace = None
        self.match_bounds_ms = []
        self.main_thread = threading.get_ident()
        self.t0 = self.t1 = self.window_s = self.setup_s = None
        self.keyframes = 0

    def stage_durations(self, name):
        """Durations (s) of the tracking thread's ``name`` stages in the
        window, outside the profiled span."""
        out = []
        for n, s, e, tid in self.spans:
            if n != name or tid != self.main_thread or s < self.t0 or e > self.t1:
                continue
            if self.span is not None and e >= self.span[0] and s <= self.span[1]:
                continue
            out.append(e - s)
        return out

    def self_durations(self, name, child):
        """Durations of ``name`` stages less the ``child`` stages they hold."""
        kids = [(s, e) for n, s, e, tid in self.spans if n == child and tid == self.main_thread]
        out = []
        for n, s, e, tid in self.spans:
            if n != name or tid != self.main_thread or s < self.t0 or e > self.t1:
                continue
            if self.span is not None and e >= self.span[0] and s <= self.span[1]:
                continue
            out.append((e - s) - sum(ke - ks for ks, ke in kids if ks >= s and ke <= e))
        return out


def host_state(slam, stream):
    """Host copies of what the truth checks judge: the frames tracked in the
    map that holds the most of them, that map's keyframes and points (each
    with the stream index of its reference keyframe)."""
    traj = slam.trajectory
    if not traj:
        return {"frames": [], "keyframes": [], "points": np.zeros((0, 3)),
                "point_kf": np.zeros(0, np.int64)}
    best = Counter(m for _, _, m, _ in traj).most_common(1)[0][0]
    fps = stream.fps
    frames = [(int(round(t * fps)), p) for t, p, m, _ in traj if m == best]
    times, poses = slam.keyframe_trajectory(best)
    kfs = [(int(round(t * fps)), p) for t, p in zip(times, poses)]
    ms = slam.ms
    sel = ms.pt_valid & (ms.pt_map_id == best)
    pts = ms.pt_xyz[sel].double().cpu().numpy()
    ref = ms.pt_ref_kf[sel].long()
    ref_t = ms.kf_time[ref.clamp_min(0)].double().cpu().numpy()
    point_kf = np.where(ref.cpu().numpy() >= 0, np.round(ref_t * fps), np.iinfo(np.int64).max)
    return {"frames": frames, "keyframes": kfs, "points": pts,
            "point_kf": point_kf.astype(np.int64)}


def _power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def execute(cell_name, seed, seconds, trace, *, device="cuda", cell=None, faults=(),
            bench=None, t_start=None, log=sys.stderr, control=False, dump=None):
    """One run.  Returns (result dict, check rows [(name, value, limit)]).
    ``cell``, ``bench`` and ``faults`` are for tests and ``slam_bench.control``:
    a cell dict in place of the file (``config_params`` and
    ``traffic_params`` in it stand for the named files), a benchmark dict in
    place of ``BENCHMARK.json``, and fault names from ``faults.FAULTS``.
    ``control``: also read the step checks' control (``check.step_readings``
    with ``low=True``) into ``result["control"]``.  ``dump``: a path to
    write what the truth checks read to (``.npz``)."""
    import torch

    from rumi_slam_tpu_torch.rumination.coordinator import RuminationCoordinator
    from rumi_slam_tpu_torch.rumination.remote import AsyncRuminationShard
    from rumi_slam_tpu_torch.ops import stereo
    from rumi_slam_tpu_torch.system import SlamSystem, TrackState
    from rumi_slam_tpu_torch.tracking import tracker

    from . import trace as trace_mod
    from .faults import FAULTS

    t_start = time.perf_counter() if t_start is None else t_start
    cuda = torch.device(device).type == "cuda"
    cell = cell or load("cells", cell_name)
    bench = bench or benchmark()
    e2e_names, layer_names = cell_metrics(bench, cell_name)
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    conf = cell.get("config_params") or load("configs", cell["config"])
    cfg = build_config(conf)
    sensor = sensor_of(conf)
    traffic = cell.get("traffic_params") or load("traffic", cell["traffic"])
    seed = int(seed)
    if seed < 0:
        raise ValueError("--seed must not be negative")

    # -- set-up -----------------------------------------------------------
    was_deterministic = torch.are_deterministic_algorithms_enabled()
    deterministic = bool(conf.get("deterministic_algorithms", False))
    if deterministic and cuda:
        # cuBLAS repeats its sums only with a fixed workspace, read when its
        # first handle is made
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if cuda:
        from rumi_slam_tpu_torch.ops import fused_matcher

        fused_matcher.build_library()
        # the card's solver library loads at its first call: load it here
        # (pose optimisation, loop closing and merges call these)
        a = torch.eye(4, device=device) * 2.0
        torch.linalg.solve_ex(a, torch.ones(4, device=device))
        torch.linalg.svd(a)
        torch.linalg.eigh(a)
        torch.linalg.cholesky(a)
        if trace:
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA]):
                (a @ a).sum().item()
        torch.cuda.reset_peak_memory_stats()
    stream = stream_mod.Stream(traffic, cfg.camera, seed, device, sensor)
    # the program's algorithms from here on (the bank's maxima repeat anyway)
    torch.use_deterministic_algorithms(deterministic, warn_only=True)
    slam = SlamSystem(cfg, device=device)
    slam._gen = torch.Generator().manual_seed(seed)
    shard = AsyncRuminationShard(cfg, device=device)
    coord = RuminationCoordinator(slam, cfg, async_shard=shard)
    run = Run()
    submits = []
    orig_submit = shard.submit

    def submit(*a, **kw):
        ok = orig_submit(*a, **kw)
        if ok:
            submits.append(time.perf_counter())
        return ok

    shard.submit = submit
    undo = [FAULTS[f](slam) for f in faults]
    captures = check.Captures(tracker, stereo, sensor).__enter__()
    match_calls = prof = None
    if trace:
        run.spans = trace_mod.StageSpans(slam.timer).spans
        match_calls = trace_mod.MatchCalls(tracker)
        prof = trace_mod.Profiled(cuda)
    samples = check.sample_ordinals(seed)
    bad = (TrackState.RECENTLY_LOST, TrackState.LOST, TrackState.NOT_INITIALIZED)
    # the stream index after whose frame the truth checks' inputs are read
    truth_at = (stream.warmup_frames + check.TRUTH_FRAMES + SlamSystem.ADOPT_AFTER - 1
                if cell.get("truth_snapshot") else None)
    host = None

    failed, attempted, error = 0, 0, None
    # the facade's call for the sensor, chosen once
    if sensor == "stereo":
        def track(k):
            return slam.track_stereo(stream.frame(k), stream.right(k), stream.time(k))
    elif sensor == "rgbd":
        def track(k):
            return slam.track_rgbd(stream.frame(k), stream.depth(k), stream.time(k))
    else:
        def track(k):
            return slam.track_monocular(stream.frame(k), stream.time(k))
    try:
        def step(k):
            t_in = time.perf_counter()
            state = track(k)
            info = coord.maybe_ruminate()
            return t_in, time.perf_counter(), state, info

        for k in range(stream.warmup_frames):
            step(k)
        if cuda:
            torch.cuda.synchronize()
        run.setup_s = time.perf_counter() - t_start

        # -- the window ---------------------------------------------------
        k, j, span_state = stream.warmup_frames, 0, 0
        n_sub0 = len(submits)
        kf0 = slam.stats["n_kf"]
        run.t0 = time.perf_counter()
        while True:
            elapsed = time.perf_counter() - run.t0
            if elapsed >= seconds:
                break
            if trace and span_state == 0 and elapsed >= SPAN_AT * seconds:
                prof.start()
                match_calls.active, span_state = True, 1
            elif span_state == 1 and elapsed >= SPAN_AT * seconds + SPAN_S:
                match_calls.active, span_state = False, 2
                prof.stop()
            captures.want = k if j in samples else None
            attempted += 1
            try:
                t_in, t_out, state, info = step(k)
            except Exception:  # a frame that raises ends the window
                failed += 1
                error = traceback.format_exc()
                break
            run.frames.append((k, t_in, t_out, state.name))
            if k == truth_at:
                host = host_state(slam, stream)
            if state in bad:
                failed += 1
            if info is not None and submits:
                run.ruminations.append((submits[-1], t_out, info.get("result")))
            k, j = k + 1, j + 1
        if span_state == 1:
            match_calls.active = False
            prof.stop()
        if cuda:
            torch.cuda.synchronize()
        run.t1 = time.perf_counter()
        run.window_s = run.t1 - run.t0
        run.keyframes = slam.stats["n_kf"] - kf0
        n_sub = len(submits) - n_sub0
        attempted += n_sub
        failed += n_sub - sum(1 for _, _, r in run.ruminations if r == "merged")
    finally:
        captures.__exit__()
        if match_calls is not None:
            tracker.fused_match = match_calls.orig
        for u in reversed(undo):
            u()
    if error is not None:
        print(error, file=log)

    # -- after the window: memory, the trace, the program's state freed -----
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": 1,
                   "memory_peak_bytes": int(torch.cuda.max_memory_allocated()) if cuda else 0}
    slam.sync_mapping()
    if slam.mapper is not None:
        slam.mapper.shutdown()
    shard.shutdown()
    if host is None:
        host = host_state(slam, stream)
    stats = dict(slam.stats)
    if trace and prof.prof is not None:
        run.span = (prof.t0, prof.t1)
        run.trace = prof.summary()
        run.match_bounds_ms = match_calls.bounds_ms()
        device_info["busy_s"] = run.trace["busy_s"]
        device_info["window_s"] = run.trace["window_s"]
    del slam, coord, shard, prof, match_calls
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        device_info["power_limit_w"] = _power_limit()

    # -- the check ----------------------------------------------------------
    if dump is not None:
        np.savez_compressed(
            dump, frames_k=np.array([k for k, _ in host["frames"]], np.int64),
            frames_pose=np.array([p for _, p in host["frames"]]).reshape(-1, 7),
            kf_k=np.array([k for k, _ in host["keyframes"]], np.int64),
            kf_pose=np.array([p for _, p in host["keyframes"]]).reshape(-1, 7),
            points=host["points"], point_kf=host["point_kf"], truth=stream.poses,
            landmarks=stream.landmarks, meta=json.dumps(
                {"n_bank": stream.n_bank, "loop_from": stream.loop_from, "fps": stream.fps,
                 "warmup": stream.warmup_frames, "stats": stats,
                 "states": [f[3] for f in run.frames]}))
    readings = {**check.step_readings(captures, stream, cfg, device),
                **check.truth_readings(host, stream)}
    correct, rows = check.verdict(readings, cell["limits"])
    low = check.step_readings(captures, stream, cfg, device, low=True) if control else None

    metrics = {}
    names = layer_names if trace else e2e_names
    kind = "metrics" if trace else "end_to_end"
    for name in names:
        v = reader(kind, name).read(run)
        if v is not None:
            metrics[name] = {"value": float(v), "unit": units[name]}
    lat = [1e3 * (b - a) for _, a, b, _ in run.frames]
    if lat:
        print(f"frame_ms median {float(np.median(lat))} p95 {float(np.percentile(lat, 95))} "
              f"frames {len(lat)} keyframes {run.keyframes} window_s {run.window_s} "
              f"setup_s {run.setup_s}", file=log)
    result = {"correct": bool(correct and error is None), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": device_info}
    if trace and run.trace is not None:
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    result["window"] = {"frames": len(run.frames), "keyframes": run.keyframes,
                        "seconds": run.window_s}
    if low is not None:
        result["control"] = low
    result["readings"] = readings
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    torch.use_deterministic_algorithms(was_deterministic, warn_only=True)
    return result, rows


def main(args, t_start):
    import torch

    if not torch.cuda.is_available():
        print("slam_bench: no CUDA device; the benchmark measures the card only",
              file=sys.stderr)
        return 2
    cell = load("cells", args.workload)
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"slam_bench: {args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result, rows = execute(args.workload, args.seed, args.seconds, bool(args.trace),
                           t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print(f"slam_bench: modules loaded that the benchmark forbids: {bad}", file=sys.stderr)
        return 3
    for n, v in result["readings"].items():
        if n not in result["checks"]:
            print(f"reading {n} {v} (not compared in this cell)", file=sys.stderr)
    for n, v, lim in rows:
        print(f"check {n} {v} limit {lim}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
