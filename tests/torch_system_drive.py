"""The SLAM drives of ``chip_smoke.py`` phases 6, 8 and 11, in either package.

``SlamSystem`` over ``SyntheticSequence(n_frames=60, 640x480, seed=4)``
rendered with ``K = cfg.intrinsics()``, at the full ``Config()`` size (8
levels, 1024 features, ``max_kf`` 256, ``max_pt`` 16384) with loop closing
off and synchronous mapping.  It prints the share of frames in the OK state,
the keyframe count and the frame-trajectory ATE (with and without a scale
in the alignment): the bounds that the chip check holds the port to.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_system_drive.py [--port]
        [--frames 80 --lost-span 20 22] [--mode mono|rgbd|stereo]
        [--reloc-window 0.1] [--tiny]

``--port`` also runs the same drive through the port on the CPU.
``--frames 80 --lost-span 20 22`` is the relocalisation drive of phase 8:
frames 20..21 render featureless, inside the relocalisation window, and the
frame after them relocalises against the map.  ``--mode rgbd`` /
``--mode stereo`` feed ``track_rgbd`` / ``track_stereo`` with an 8 cm
baseline (phase 11 (a), (b)); ``--mode rgbd --frames 70 --lost-span 40 46
--reloc-window 0.1`` is phase 11 (c): the system gives the map up during
the span, opens submap 1 and initialises it from depth on frame 46.
``--tiny`` runs ``tiny_config()`` over the 320x240 scene of the depth
parity tests (``tests/test_torch_depth_drives.py``).

The parity tests import the helpers below: JAX draws for the port's RANSAC
(``jax_draw``, ``jax_draw_stream``), the inputs of the mapping rounds of a
short port drive (``mapping_inputs``) and the drive itself (``drive``).
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import time

import numpy as np

N_FRAMES = 60
SEED = 4


def jax_draw(key):
    """A RANSAC draw for the port (``optim.ransac``) that returns what
    ``jax.random.categorical(key, logits[None].repeat(H * m, 0)).reshape(H, m)``
    draws in ``two_view_init`` and ``pnp_ransac``.  The key rides along as
    ``draw.key``."""
    import jax
    import jax.numpy as jnp
    import torch

    def draw(logits, shape):
        h, m = shape
        lg = jnp.asarray(logits.detach().cpu().numpy())
        idx = jax.random.categorical(key, lg[None, :].repeat(h * m, 0)).reshape(h, m)
        return torch.from_numpy(np.asarray(idx).astype(np.int64))

    draw.key = key
    return draw


def jax_draw_stream():
    """A ``_next_draw`` for the port's ``SlamSystem`` that splits
    ``PRNGKey(0)`` at the same calls as the JAX facade's ``_next_key``."""
    import jax

    state = {"key": jax.random.PRNGKey(0)}

    def next_draw():
        state["key"], k = jax.random.split(state["key"])
        return jax_draw(k)

    return next_draw


def mapping_inputs(n_frames=12, mode="mono"):
    """Run the port's ``SlamSystem(tiny_config())`` over the first frames of
    the verify drive (seed 4, patch 3, 320x240), or with ``mode`` "rgbd" or
    "stereo" over those of the tiny depth drive (``drive(tiny=True)``), and
    record the input of every local-mapping round: (MapState snapshot,
    kf_id, kf_count), plus the system and the sequence."""
    from rumi_slam_tpu_torch.config import tiny_config
    from rumi_slam_tpu_torch.io.synthetic import SyntheticSequence
    from rumi_slam_tpu_torch.system import SlamSystem
    from rumi_slam_tpu_torch.tracking import mapping_worker as MW

    cfg = tiny_config()
    if mode == "mono":
        seq = SyntheticSequence(n_frames=n_frames, width=320, height=240, n_points=1500,
                                seed=4, patch=3)
    else:
        cfg = depth_camera(cfg)
        seq = SyntheticSequence(n_frames=n_frames, width=320, height=240, n_points=1500,
                                seed=5, patch=3, K=cfg.intrinsics())
    slam = SlamSystem(cfg, device="cpu")
    rounds = []
    real = MW.run_mapping_round

    def record(ms, K, cfg, kf_id, **kw):
        rounds.append((ms, kf_id, kw["kf_count"]))
        return real(ms, K, cfg, kf_id, **kw)

    MW.run_mapping_round = record
    try:
        for i in range(n_frames):
            feed(slam, seq, i, mode)
    finally:
        MW.run_mapping_round = real
    return rounds, slam, seq


def drive_config(cfg):
    """``cfg`` with loop closing off and synchronous mapping."""
    return dataclasses.replace(cfg, mapping=dataclasses.replace(
        cfg.mapping, loop_closing=False, overlapped=False))


# The depth modes' camera: the JAX package's own depth test settings
# (tests/test_stereo_rgbd.py) -- an 8 cm baseline, depth gate 30 m, and depth
# maps in metres (the synthetic depth is rendered in metres).
DEPTH_BASELINE = 0.08
DEPTH_TH = 30.0


def depth_camera(cfg):
    """``cfg`` with the depth modes' camera."""
    return dataclasses.replace(cfg, camera=dataclasses.replace(
        cfg.camera, baseline=DEPTH_BASELINE, th_depth=DEPTH_TH, depth_factor=1.0))


def feed(slam, seq, i, mode):
    """Frame ``i`` of ``seq`` through ``slam`` in ``mode`` (``"mono"``,
    ``"rgbd"`` or ``"stereo"``); returns the state's name."""
    if mode == "rgbd":
        return slam.track_rgbd(*seq.frame_rgbd(i)).name
    if mode == "stereo":
        return slam.track_stereo(*seq.frame_stereo(i, DEPTH_BASELINE)).name
    return slam.track_monocular(*seq.frame(i)).name


def _packages(port):
    pkg = "rumi_slam_tpu_torch" if port else "rumi_slam_tpu"
    return tuple(importlib.import_module(f"{pkg}.{m}") for m in
                 ("config", "evaluation.ate", "io.synthetic", "system"))


def _np(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def drive(port=False, *, n_frames=N_FRAMES, lost_span=None, mode="mono", tiny=False,
          reloc_window_s=None, next_draw=None, device="cpu"):
    """One drive in either package.  Full size: ``Config()`` with loop
    closing off and synchronous mapping over ``SyntheticSequence(seed=4)``.
    ``tiny``: ``tiny_config()`` as it is over the 320x240 sequence (1500
    points, patch 3) of seed 5, the JAX package's depth test's scene.  The
    scene is rendered with the configuration's intrinsics.  ``next_draw``
    replaces the port's ``_next_draw`` (``jax_draw_stream()``).

    Returns (summary dict, system, sequence)."""
    config, ate, synthetic, system = _packages(port)
    cfg = config.tiny_config() if tiny else drive_config(config.Config())
    if mode != "mono":
        cfg = depth_camera(cfg)
    if reloc_window_s is not None:
        cfg = dataclasses.replace(cfg, tracking=dataclasses.replace(
            cfg.tracking, reloc_window_s=reloc_window_s))
    c = cfg.camera
    size = dict(n_points=1500, seed=5, patch=3) if tiny else dict(seed=SEED)
    kw = dict(device=device) if port else {}
    seq = synthetic.SyntheticSequence(n_frames=n_frames, width=c.width, height=c.height,
                                      K=cfg.intrinsics(*([device] if port else [])),
                                      lost_span=lost_span, **size, **kw)
    slam = system.SlamSystem(cfg, **kw) if port else system.SlamSystem(cfg)
    if next_draw is not None:
        slam._next_draw = next_draw
    t0 = time.perf_counter()
    states = [feed(slam, seq, i, mode) for i in range(len(seq))]
    wall = time.perf_counter() - t0
    slam.sync_mapping()
    times, poses = slam.trajectory_of_map()
    gt = np.stack([_np(p) for p in seq.poses_gt])
    m = ate.evaluate_trajectory(times, poses, seq.times, gt)
    ms = slam.ms
    n_kf = int(ms.n_kf)
    r = summarize(states, dict(slam.stats), m["ate"])
    r.update(mode=mode, lost_span=lost_span, wall_s=wall,
             ate_unscaled=ate.evaluate_trajectory(times, poses, seq.times, gt,
                                                  with_scale=False)["ate"],
             new_map_frames=new_map_frames(states),
             kf_time=_np(ms.kf_time)[:n_kf].tolist(), kf_map=_np(ms.kf_map_id)[:n_kf].tolist(),
             kf_pose=_np(ms.kf_pose)[:n_kf].tolist())
    return r, slam, seq


def new_map_frames(states):
    """Frames on which a submap opened: NOT_INITIALIZED after a loss."""
    return [i for i in range(1, len(states))
            if states[i] == "NOT_INITIALIZED" and states[i - 1] in ("RECENTLY_LOST", "LOST")]


def summarize(states, stats, ate):
    ok = sum(s == "OK" for s in states)
    return {"frames": len(states), "ok_frames": ok, "ok_share": ok / len(states),
            "n_kf": stats["n_kf"], "ate": ate, "states": states, "stats": stats}


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--port", action="store_true",
                    help="also run the drive through the port on the CPU")
    ap.add_argument("--frames", type=int, default=N_FRAMES)
    ap.add_argument("--lost-span", type=int, nargs=2, metavar=("FIRST", "END"),
                    help="render frames FIRST <= i < END featureless (the relocalisation "
                         "drive of chip_smoke.py phase 8: --frames 80 --lost-span 20 22)")
    ap.add_argument("--mode", choices=("mono", "rgbd", "stereo"), default="mono",
                    help="the input: track_monocular, track_rgbd or track_stereo with an "
                         "8 cm baseline (chip_smoke.py phase 11)")
    ap.add_argument("--reloc-window", type=float, metavar="SECONDS",
                    help="tracking.reloc_window_s (phase 11's run (c): 0.1)")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny_config() over the 320x240 scene of seed 5 (the parity tests)")
    a = ap.parse_args()
    span = tuple(a.lost_span) if a.lost_span else None
    kw = dict(n_frames=a.frames, lost_span=span, mode=a.mode, tiny=a.tiny,
              reloc_window_s=a.reloc_window)
    for port in (False, True) if a.port else (False,):
        t0 = time.perf_counter()
        r = drive(port, **kw)[0]
        name = "rumi_slam_tpu_torch (cpu)" if port else "rumi_slam_tpu"
        print(json.dumps({"package": name, **r, "seconds": time.perf_counter() - t0}),
              flush=True)
