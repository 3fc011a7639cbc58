"""Synthetic sequence generator: textured 3D world + camera trajectory (port
of ``rumi_slam_tpu/io/synthetic.py``; lost-span frames, the sweep trajectory
and stereo pairs are not ported yet).

The renderer splats textured squares at projected world-point locations:
corner-rich imagery that FAST/BRIEF track well, with exact ground truth.
The splats are drawn by scatter-max (image) and scatter-min (depth), which
are order-independent, so the frames equal the JAX package's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geometry import camera, lie

TEX_R = 8  # per-landmark texture half-size (supports patch <= 8)


class SyntheticWorld(NamedTuple):
    xyz: torch.Tensor        # [M,3] world landmarks
    intensity: torch.Tensor  # [M] patch brightness
    size: torch.Tensor       # [M] patch half-size in world units (approx)
    tex: torch.Tensor        # [M,2*TEX_R+1,2*TEX_R+1] per-landmark albedo


def make_world(n_points=3000, seed=0, box=((-5, -3.5, 1.2), (5, 3.5, 8.0)),
               device="cpu"):
    """Close-range landmark box (z 1.2-8) with a random albedo texture per
    landmark; the same numpy draws as the JAX package."""
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(box[0]), np.asarray(box[1])
    xyz = rng.uniform(lo, hi, size=(n_points, 3)).astype(np.float32)
    inten = rng.uniform(60, 255, size=n_points).astype(np.float32)
    size = rng.uniform(0.02, 0.08, size=n_points).astype(np.float32)
    t = 2 * TEX_R + 1
    tex = rng.uniform(0.35, 1.0, size=(n_points, t, t)).astype(np.float32)
    return SyntheticWorld(*(torch.from_numpy(a).to(device) for a in (xyz, inten, size, tex)))


def _splats(world, K, T_cw, width, height, patch):
    """Projected splat centres, pixel half-sizes, visibility and depth."""
    uv, depth = camera.project_world(K, T_cw, world.xyz)
    px = torch.clamp(world.size * K[0] / torch.clamp_min(depth, 0.3), 1.0, float(patch))
    vis = (
        (depth > 0.3)
        & (uv[:, 0] > -8) & (uv[:, 0] < width + 8)
        & (uv[:, 1] > -8) & (uv[:, 1] < height + 8)
    )
    # clamp before the integer cast, so far-off projections saturate
    cx = torch.clamp(torch.round(uv[:, 0]), 0, width - 1).to(torch.int64)
    cy = torch.clamp(torch.round(uv[:, 1]), 0, height - 1).to(torch.int64)
    return cx, cy, px, vis, depth


def _scatter_splats(canvas, values_at, cx, cy, px, width, height, patch, reduce):
    """Draw (2r+1)^2 squares into the flat canvas with scatter-``reduce``."""
    for dy in range(-patch, patch + 1):
        for dx in range(-patch, patch + 1):
            inside = (abs(dy) <= px) & (abs(dx) <= px)
            yy = torch.clamp(cy + dy, 0, height - 1)
            xx = torch.clamp(cx + dx, 0, width - 1)
            canvas.scatter_reduce_(0, yy * width + xx, values_at(dy, dx, inside),
                                   reduce, include_self=True)
    return canvas.reshape(height, width)


def render_frame(world: SyntheticWorld, K, T_cw, *, width=640, height=480, patch=4):
    """Render one grayscale frame [H, W] float32 by splatting textured squares."""
    cx, cy, px, vis, _ = _splats(world, K, T_cw, width, height, patch)
    inten = torch.where(vis, world.intensity, 0.0)

    def values(dy, dx, inside):
        alb = world.tex[:, dy + TEX_R, dx + TEX_R]
        return torch.where(inside, inten * alb, 0.0)

    img = torch.full((height * width,), 40.0, dtype=torch.float32, device=cx.device)
    return _scatter_splats(img, values, cx, cy, px, width, height, patch, "amax")


def render_depth(world: SyntheticWorld, K, T_cw, *, width=640, height=480, patch=4):
    """Depth map [H, W] float32 (meters; 0 = no return) matching
    :func:`render_frame`'s splats."""
    cx, cy, px, vis, depth = _splats(world, K, T_cw, width, height, patch)
    z = torch.where(vis, depth, float("inf"))

    def values(dy, dx, inside):
        return torch.where(inside, z, float("inf"))

    dmap = torch.full((height * width,), float("inf"), dtype=torch.float32, device=cx.device)
    dmap = _scatter_splats(dmap, values, cx, cy, px, width, height, patch, "amin")
    return torch.where(torch.isfinite(dmap), dmap, 0.0)


def smooth_trajectory(n_frames, *, seed=1, speed=0.06, yaw_rate=0.004, sway=0.10):
    """World->camera poses ([7] float32 tensors on the CPU) for a handheld
    forward-moving camera with lateral/vertical sway, and timestamps at 30 fps."""
    rng = np.random.default_rng(seed)
    poses = []
    t = np.zeros(3, np.float32)
    yaw = 0.0
    for i in range(n_frames):
        yaw += yaw_rate + rng.normal(scale=0.0005)
        t = t + np.asarray([np.sin(yaw), 0.0, np.cos(yaw)], np.float32) * speed
        ph = i / 30.0 * 2.0 * np.pi
        osc = np.asarray([
            sway * np.sin(0.45 * ph) + 0.3 * sway * np.sin(1.1 * ph + 1.0),
            0.5 * sway * np.sin(0.7 * ph + 0.5),
            0.0,
        ], np.float32)
        wob = rng.normal(scale=0.002, size=3).astype(np.float32)
        q = lie.so3_exp(torch.tensor([0.0, yaw, 0.0], dtype=torch.float32)
                        + torch.from_numpy(wob))
        T_wc = lie.se3(q, torch.from_numpy(t + osc))
        poses.append(lie.se3_inverse(T_wc))
    times = np.arange(n_frames, dtype=np.float64) / 30.0
    return poses, times


class SyntheticSequence:
    """Frame source over a rendered world along ``smooth_trajectory``."""

    def __init__(self, n_frames=120, *, width=640, height=480, K=None,
                 n_points=3000, seed=0, patch=4, device="cpu"):
        self.world = make_world(n_points, seed=seed, device=device)
        self.K = (
            K if K is not None
            else torch.tensor([width * 0.8, width * 0.8, width / 2 - 0.5, height / 2 - 0.5],
                              dtype=torch.float32, device=device)
        )
        self.width, self.height, self.patch = width, height, patch
        poses, self.times = smooth_trajectory(n_frames, seed=seed + 1)
        self.poses_gt = [p.to(device) for p in poses]

    def __len__(self):
        return len(self.poses_gt)

    def frame(self, i):
        img = render_frame(self.world, self.K, self.poses_gt[i],
                           width=self.width, height=self.height, patch=self.patch)
        return img, float(self.times[i])

    def frame_rgbd(self, i):
        """(gray, depth [m], t) — synthetic RGB-D sensor."""
        img, t = self.frame(i)
        depth = render_depth(self.world, self.K, self.poses_gt[i],
                             width=self.width, height=self.height, patch=self.patch)
        return img, depth, t
