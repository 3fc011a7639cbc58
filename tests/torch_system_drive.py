"""The monocular SLAM drive of ``chip_smoke.py`` phase 6, in the JAX package.

``SlamSystem`` over ``SyntheticSequence(n_frames=60, 640x480, seed=4)``
rendered with ``K = cfg.intrinsics()``, at the full ``Config()`` size (8
levels, 1024 features, ``max_kf`` 256, ``max_pt`` 16384) with loop closing
off and synchronous mapping.  It prints the share of frames in the OK state,
the keyframe count and the frame-trajectory ATE: the bounds that phase 6
holds the port to.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_system_drive.py [--port]
        [--frames 80 --lost-span 20 22]

``--port`` also runs the same drive through the port on the CPU.
``--frames 80 --lost-span 20 22`` is the relocalisation drive of phase 8:
frames 20..21 render featureless, inside the relocalisation window, and the
frame after them relocalises against the map.

The parity tests import the helpers below: JAX draws for the port's RANSAC
(``jax_draw``, ``jax_draw_stream``) and the inputs of the mapping rounds of
a short port drive (``mapping_inputs``).
"""

from __future__ import annotations

import dataclasses
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


def mapping_inputs(n_frames=12):
    """Run the port's ``SlamSystem(tiny_config())`` over the first frames of
    the verify drive (seed 4, patch 3, 320x240) and record the input of
    every local-mapping round: (MapState snapshot, kf_id, kf_count), plus
    the system and the sequence."""
    from rumi_slam_tpu_torch.config import tiny_config
    from rumi_slam_tpu_torch.io.synthetic import SyntheticSequence
    from rumi_slam_tpu_torch.system import SlamSystem
    from rumi_slam_tpu_torch.tracking import mapping_worker as MW

    seq = SyntheticSequence(n_frames=n_frames, width=320, height=240, n_points=1500,
                            seed=4, patch=3)
    slam = SlamSystem(tiny_config(), device="cpu")
    rounds = []
    real = MW.run_mapping_round

    def record(ms, K, cfg, kf_id, **kw):
        rounds.append((ms, kf_id, kw["kf_count"]))
        return real(ms, K, cfg, kf_id, **kw)

    MW.run_mapping_round = record
    try:
        for i in range(n_frames):
            slam.track_monocular(*seq.frame(i))
    finally:
        MW.run_mapping_round = real
    return rounds, slam, seq


def drive_config(cfg):
    """``cfg`` with loop closing off and synchronous mapping."""
    return dataclasses.replace(cfg, mapping=dataclasses.replace(
        cfg.mapping, loop_closing=False, overlapped=False))


def summarize(states, stats, ate):
    ok = sum(s == "OK" for s in states)
    return {"frames": len(states), "ok_frames": ok, "ok_share": ok / len(states),
            "n_kf": stats["n_kf"], "ate": ate, "states": states, "stats": stats}


def run_jax(n_frames=N_FRAMES, lost_span=None):
    from rumi_slam_tpu.config import Config
    from rumi_slam_tpu.evaluation import ate
    from rumi_slam_tpu.io.synthetic import SyntheticSequence
    from rumi_slam_tpu.system import SlamSystem

    cfg = drive_config(Config())
    c = cfg.camera
    seq = SyntheticSequence(n_frames=n_frames, width=c.width, height=c.height,
                            K=cfg.intrinsics(), seed=SEED, lost_span=lost_span)
    slam = SlamSystem(cfg)
    states = [slam.track_monocular(seq.frame(i)[0], seq.times[i]).name
              for i in range(len(seq))]
    times, poses = slam.trajectory_of_map()
    gt = np.stack([np.asarray(p) for p in seq.poses_gt])
    m = ate.evaluate_trajectory(times, poses, seq.times, gt)
    return summarize(states, dict(slam.stats), m["ate"])


def run_port(n_frames=N_FRAMES, lost_span=None):
    import torch

    from rumi_slam_tpu_torch.config import Config
    from rumi_slam_tpu_torch.evaluation import ate
    from rumi_slam_tpu_torch.io.synthetic import SyntheticSequence
    from rumi_slam_tpu_torch.system import SlamSystem

    cfg = drive_config(Config())
    c = cfg.camera
    seq = SyntheticSequence(n_frames=n_frames, width=c.width, height=c.height,
                            K=cfg.intrinsics("cpu"), seed=SEED, lost_span=lost_span)
    slam = SlamSystem(cfg, device="cpu")
    states = [slam.track_monocular(seq.frame(i)[0], seq.times[i]).name
              for i in range(len(seq))]
    times, poses = slam.trajectory_of_map()
    gt = torch.stack(seq.poses_gt).numpy()
    m = ate.evaluate_trajectory(times, poses, seq.times, gt)
    return summarize(states, dict(slam.stats), m["ate"])


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--port", action="store_true",
                    help="also run the drive through the port on the CPU")
    ap.add_argument("--frames", type=int, default=N_FRAMES)
    ap.add_argument("--lost-span", type=int, nargs=2, metavar=("FIRST", "END"),
                    help="render frames FIRST <= i < END featureless (the relocalisation "
                         "drive of chip_smoke.py phase 8: --frames 80 --lost-span 20 22)")
    a = ap.parse_args()
    span = tuple(a.lost_span) if a.lost_span else None
    t0 = time.perf_counter()
    print(json.dumps({"package": "rumi_slam_tpu", "lost_span": span,
                      **run_jax(a.frames, span),
                      "seconds": time.perf_counter() - t0}), flush=True)
    if a.port:
        t0 = time.perf_counter()
        print(json.dumps({"package": "rumi_slam_tpu_torch (cpu)", "lost_span": span,
                          **run_port(a.frames, span),
                          "seconds": time.perf_counter() - t0}), flush=True)
