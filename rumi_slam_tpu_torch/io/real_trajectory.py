"""Render the synthetic world along a real TUM groundtruth trajectory (port
of ``rumi_slam_tpu/io/real_trajectory.py``).

The reference validates on real TUM sequences whose motion-capture
groundtruth it vendors (``groundtruth/slam-tum/<seq>/groundtruth.txt``).
This module interpolates the ~90 Hz poses to the camera cadence and drives
the synthetic renderer along them, so a run inherits the real handheld
dynamics instead of a designed sinusoid.  A forced gap (degraded or
featureless frames over a time span) reproduces a tracking-loss event for
the rumination path.

Where the JAX package maps ``lie`` over poses with ``jax.vmap``, the port's
``lie`` functions broadcast over a leading axis.  Frames and poses live on
``device`` (the card unless the caller asks for the CPU).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..geometry import camera, lie
from ..ops import image as I
from . import synthetic


def load_tum_groundtruth(path):
    """Read TUM groundtruth.txt -> (times [N], T_wc [N,7] wxyz+t)."""
    rows = np.loadtxt(path, comments="#")
    times = rows[:, 0]
    t = rows[:, 1:4]
    qxyzw = rows[:, 4:8]
    T_wc = np.concatenate([qxyzw[:, 3:4], qxyzw[:, 0:3], t], axis=1)
    return times, T_wc.astype(np.float32)


def resample_trajectory(times, T_wc, fps: float = 30.0):
    """Interpolate mocap poses to the camera cadence (nlerp on quats —
    adjacent mocap samples are ~11 ms apart, so normalized-lerp == slerp to
    float precision).  Returns (times [M], T_wc [M,7])."""
    t0, t1 = times[0], times[-1]
    out_t = np.arange(t0, t1, 1.0 / fps)
    idx = np.searchsorted(times, out_t, side="right") - 1
    idx = np.clip(idx, 0, len(times) - 2)
    w = ((out_t - times[idx]) / np.maximum(times[idx + 1] - times[idx], 1e-9)
         ).astype(np.float32)[:, None]
    qa, qb = T_wc[idx, :4], T_wc[idx + 1, :4]
    # shortest-arc: flip hemisphere before lerp
    qb = np.where(np.sum(qa * qb, axis=1, keepdims=True) < 0, -qb, qb)
    q = (1 - w) * qa + w * qb
    q /= np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-9)
    p = (1 - w) * T_wc[idx, 4:] + w * T_wc[idx + 1, 4:]
    return out_t, np.concatenate([q, p], axis=1).astype(np.float32)


def world_along_trajectory(K, poses_cw, n_points: int, seed: int,
                           width: int, height: int,
                           depth_range=(0.9, 4.0)):
    """Sample landmarks guaranteed visible from the trajectory: unproject
    random pixels at random depths from uniformly-sampled poses.  (The box
    sampler in synthetic.make_world assumes a forward-facing corridor; a
    real handheld trajectory looks every which way.)  ``K`` and
    ``poses_cw`` ([N,7]) are tensors; the world lands on their device."""
    dev = K.device
    rng = np.random.default_rng(seed)
    frame_pick = rng.integers(0, len(poses_cw), n_points)
    u = rng.uniform(8, width - 8, n_points).astype(np.float32)
    v = rng.uniform(8, height - 8, n_points).astype(np.float32)
    z = rng.uniform(*depth_range, n_points).astype(np.float32)
    uv = torch.from_numpy(np.stack([u, v], -1)).to(dev)
    rays = camera.unproject(K, uv)                          # [N,3] z=1
    Xc = rays * torch.from_numpy(z).to(dev)[:, None]
    T_cw = poses_cw[torch.from_numpy(frame_pick).to(dev)]
    Xw = lie.se3_apply(lie.se3_inverse(T_cw), Xc)
    inten = rng.uniform(60, 255, n_points).astype(np.float32)
    # sized so splats render ~7-15 px at fr1's 1-3 m depths: the textured
    # patch must dominate the BRIEF window for view-stable descriptors
    size = rng.uniform(0.04, 0.12, n_points).astype(np.float32)
    t = 2 * synthetic.TEX_R + 1
    tex = rng.uniform(0.35, 1.0, size=(n_points, t, t)).astype(np.float32)
    return synthetic.SyntheticWorld(
        Xw, *(torch.from_numpy(a).to(dev) for a in (inten, size, tex)))


class GroundtruthSequence:
    """Synthetic frames along a real TUM trajectory.

    API-compatible with SyntheticSequence (frame/times/poses_gt) so it
    drops into harness.run_once / repeat_experiment.

    Args:
      name: an absolute path to a groundtruth.txt, or a sequence directory
        (e.g. "rgbd_dataset_freiburg1_floor") under ``gt_root``, the
        reference's vendored ``groundtruth/slam-tum`` directory.
      lost_span_s: (t0, t1) seconds from sequence start with degraded
        rendering — the forced loss gap driving the rumination path.
      gap_mode: how the gap is rendered.  "degraded" (default) renders the
        true frame then motion-degrades it (gaussian blur + contrast
        collapse) — textured enough that LK optical flow has signal yet
        below the ORB tracker's corner/descriptor floor.  "featureless"
        renders a constant frame (total dropout).
      duration_s: optionally truncate the sequence.
      device: where the world, the poses and the frames live.
    """

    def __init__(self, name, *, gt_root=None, width=320,
                 height=240, K=None, n_points=2500, seed=0,
                 lost_span_s=None, duration_s=None, fps=30.0, patch=6,
                 gap_mode="degraded", device="cuda"):
        if os.path.isabs(name):
            path = name
        elif gt_root is not None:
            path = os.path.join(gt_root, name, "groundtruth.txt")
        else:
            raise ValueError(f"GroundtruthSequence: {name!r} is not an absolute path "
                             "and no gt_root was given")
        self.device = torch.device(device)
        times, T_wc = load_tum_groundtruth(path)
        times, T_wc = resample_trajectory(times, T_wc, fps=fps)
        if duration_s is not None:
            n = int(duration_s * fps)
            times, T_wc = times[:n], T_wc[:n]
        self.name = os.path.basename(os.path.dirname(path)) or "gt"
        self.times = times - times[0]
        poses = lie.se3_inverse(torch.from_numpy(T_wc).to(self.device))
        self.poses_gt = list(poses)
        self.K = (torch.as_tensor(K, dtype=torch.float32, device=self.device)
                  if K is not None else
                  torch.tensor([width * 0.8, width * 0.8, width / 2 - 0.5, height / 2 - 0.5],
                               dtype=torch.float32, device=self.device))
        self.width, self.height, self.patch = width, height, patch
        self.world = world_along_trajectory(self.K, poses, n_points, seed, width, height)
        self.lost_span = None
        self.gap_mode = gap_mode
        if lost_span_s is not None:
            i0 = int(np.searchsorted(self.times, lost_span_s[0]))
            i1 = int(np.searchsorted(self.times, lost_span_s[1]))
            self.lost_span = (i0, i1)

    def __len__(self):
        return len(self.poses_gt)

    def frame(self, i):
        in_gap = (self.lost_span is not None
                  and self.lost_span[0] <= i < self.lost_span[1])
        if in_gap and self.gap_mode == "featureless":
            return (torch.full((self.height, self.width), 40.0, dtype=torch.float32,
                               device=self.device), float(self.times[i]))
        img = synthetic.render_frame(
            self.world, self.K, self.poses_gt[i],
            width=self.width, height=self.height, patch=self.patch)
        if in_gap:
            img = degrade_frame(img)
        return img, float(self.times[i])


def degrade_frame(img, *, sigma=3.0, contrast=0.25, floor=60.0):
    """Motion-degrade a frame below the ORB tracking floor while keeping
    large-scale gradients for LK flow: heavy gaussian blur (kills the FAST
    corner response and decorrelates BRIEF against sharp-frame descriptors)
    plus contrast collapse toward a grey floor."""
    blurred = I.gaussian_blur(img, sigma=sigma, radius=int(3 * sigma))
    return floor + contrast * blurred
