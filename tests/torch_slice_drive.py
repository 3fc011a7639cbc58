"""The tracked drive over a synthetic sequence, in both packages.

Frame 0 of ``SyntheticSequence(seed=7)`` is rendered with its depth; the
port's ``seed_map_from_depth`` builds a map from frame 0's own features at
the ground-truth pose, and that one map is carried into both packages
(``to_numpy``/``from_numpy``).  Frames 1..N-1 are then extracted and tracked
with a constant-velocity prediction, by each package on its own.

``tests/test_torch_slice.py`` runs it at test size.  Run as a script, it
drives the full-size configuration (640x480, 8 levels, 1024 features,
max_pt 16384) on the CPU and prints the JAX package's per-frame inliers and
their median, the floor that ``chip_smoke.py`` holds the port to:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_slice_drive.py
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from rumi_slam_tpu.geometry import lie as jlie
from rumi_slam_tpu.mapstate import map_state as jM
from rumi_slam_tpu.ops import orb as jorb
from rumi_slam_tpu.tracking import tracker as jtr
from rumi_slam_tpu_torch import step as tstep
from rumi_slam_tpu_torch.io.synthetic import SyntheticSequence
from rumi_slam_tpu_torch.mapstate import map_state as tM


def make_drive(cfg, n_frames: int, seed: int = 7):
    """Frames, K, ground truth and the seeded map (numpy dict) of a drive."""
    c = cfg.camera
    seq = SyntheticSequence(n_frames=n_frames, width=c.width, height=c.height, seed=seed)
    img0, depth0, _ = seq.frame_rgbd(0)
    step = tstep.TrackingStep(cfg, seq.K)
    ms = tstep.seed_map_from_depth(step.extractor(img0), depth0, seq.K, seq.poses_gt[0], cfg)
    frames = [seq.frame(i)[0].numpy() for i in range(n_frames)]
    gt = [p.numpy() for p in seq.poses_gt]
    return frames, seq.K.numpy(), gt, tM.to_numpy(ms)


def run_port(cfg, frames, K, gt, ms_np):
    step = tstep.TrackingStep(cfg, torch.from_numpy(K))
    ms = tM.from_numpy(ms_np, device="cpu")
    poses = [torch.from_numpy(gt[0])]
    out = []
    for i in range(1, len(frames)):
        pred = poses[0] if i == 1 else tstep.constant_velocity(poses[-1], poses[-2])
        feats = step.extractor(torch.from_numpy(frames[i]))
        ms, tr = step.track(feats, ms, pred)
        poses.append(tr.pose)
        out.append(dict(n_inliers=int(tr.n_inliers), pose=tr.pose.numpy(),
                        assoc=tr.assoc.numpy(),
                        uv=feats.uv.numpy(), desc=feats.desc.numpy().view(np.uint32),
                        valid=feats.valid.numpy()))
    return out


def run_jax(cfg, frames, K, gt, ms_np):
    o, c = cfg.orb, cfg.camera
    ms = jM.MapState(**{k: jnp.asarray(v) for k, v in ms_np.items()})
    Kj = jnp.asarray(K)

    @jax.jit
    def track(img, ms, pred):
        feats = jorb.extract_orb(img, n_features=o.n_features, n_levels=o.n_levels,
                                 scale_factor=o.scale_factor, threshold=o.ini_th_fast,
                                 min_threshold=o.min_th_fast, cell=o.cell, k_cell=o.k_cell)
        ms, tr = jtr.track_frame(ms, Kj, feats, pred, cfg.tracking.match_radius,
                                 img_w=c.width, img_h=c.height, fused=False)
        return ms, tr, feats

    poses = [jnp.asarray(gt[0])]
    out = []
    for i in range(1, len(frames)):
        if i == 1:
            pred = poses[0]
        else:
            vel = jlie.se3_compose(poses[-1], jlie.se3_inverse(poses[-2]))
            pred = jlie.se3_compose(vel, poses[-1])
        ms, tr, feats = track(jnp.asarray(frames[i]), ms, pred)
        poses.append(tr.pose)
        out.append(dict(n_inliers=int(tr.n_inliers), pose=np.asarray(tr.pose),
                        assoc=np.asarray(tr.assoc),
                        uv=np.asarray(feats.uv), desc=np.asarray(feats.desc),
                        valid=np.asarray(feats.valid)))
    return out


def center_error(T_cw, T_gt):
    c = lambda T: np.asarray(jlie.se3_inverse(jnp.asarray(T)))[4:7]
    return float(np.linalg.norm(c(T_cw) - c(T_gt)))


if __name__ == "__main__":
    from rumi_slam_tpu_torch.config import Config

    torch.set_num_threads(4)
    cfg = Config()
    n = 30
    frames, K, gt, ms_np = make_drive(cfg, n)
    jx = run_jax(cfg, frames, K, gt, ms_np)
    inl = [r["n_inliers"] for r in jx]
    err = [center_error(r["pose"], gt[i + 1]) for i, r in enumerate(jx)]
    print(json.dumps({"package": "rumi_slam_tpu", "frames": n, "n_inliers": inl,
                      "median_n_inliers": float(np.median(inl)),
                      "center_error_m": [round(e, 5) for e in err]}))
    pt = run_port(cfg, frames, K, gt, ms_np)
    inl_t = [r["n_inliers"] for r in pt]
    print(json.dumps({"package": "rumi_slam_tpu_torch (cpu)", "n_inliers": inl_t,
                      "median_n_inliers": float(np.median(inl_t))}))
