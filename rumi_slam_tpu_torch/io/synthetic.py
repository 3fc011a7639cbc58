"""Synthetic sequence generator: textured 3D world + camera trajectory, with
monocular, RGB-D and rectified stereo frames (port of
``rumi_slam_tpu/io/synthetic.py``).

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


def sweep_trajectory(n_frames, *, seed=1, amp=(1.6, 0.35, 0.5), yaw_amp=0.22):
    """Handheld sweep: the camera oscillates over one region instead of
    advancing, so after a lost span it still faces mapped structure: the
    trajectory of the loss-recovery scenarios.  Returns (poses: [7] float32
    T_cw tensors on the CPU, times at 30 fps)."""
    rng = np.random.default_rng(seed)
    poses = []
    for i in range(n_frames):
        t = i / 30.0
        pos = np.asarray([
            amp[0] * np.sin(2 * np.pi * 0.06 * t),
            amp[1] * np.sin(2 * np.pi * 0.11 * t + 1.0),
            amp[2] * np.sin(2 * np.pi * 0.035 * t),
        ], np.float32) + rng.normal(scale=0.002, size=3).astype(np.float32)
        yaw = yaw_amp * np.sin(2 * np.pi * 0.05 * t)
        pitch = 0.4 * yaw_amp * np.sin(2 * np.pi * 0.08 * t + 0.7)
        q = lie.so3_exp(torch.from_numpy(np.asarray([pitch, yaw, 0.0], np.float32)))
        T_wc = lie.se3(q, torch.from_numpy(pos))
        poses.append(lie.se3_inverse(T_wc))
    times = np.arange(n_frames, dtype=np.float64) / 30.0
    return poses, times


class SyntheticSequence:
    """Frame source over a rendered world along ``smooth_trajectory``, or
    along ``sweep_trajectory`` with ``trajectory="sweep"``.

    Frames ``i`` with ``lost_span[0] <= i < lost_span[1]`` render featureless
    (a covered lens) while the trajectory goes on: the loss event that sends
    the tracker to RECENTLY_LOST and then LOST.
    """

    def __init__(self, n_frames=120, *, width=640, height=480, K=None,
                 n_points=3000, seed=0, lost_span=None, patch=4, trajectory="advance",
                 device="cpu"):
        self.world = make_world(n_points, seed=seed, device=device)
        if K is None:
            K = [width * 0.8, width * 0.8, width / 2 - 0.5, height / 2 - 0.5]
        self.K = torch.as_tensor(K, dtype=torch.float32, device=device)
        self.width, self.height, self.patch = width, height, patch
        self.lost_span = lost_span
        make = sweep_trajectory if trajectory == "sweep" else smooth_trajectory
        poses, self.times = make(n_frames, seed=seed + 1)
        self.poses_gt = [p.to(device) for p in poses]

    def __len__(self):
        return len(self.poses_gt)

    def _in_lost_span(self, i):
        return self.lost_span is not None and self.lost_span[0] <= i < self.lost_span[1]

    def frame(self, i):
        if self._in_lost_span(i):
            return (torch.full((self.height, self.width), 40.0, dtype=torch.float32,
                               device=self.K.device), float(self.times[i]))
        img = render_frame(self.world, self.K, self.poses_gt[i],
                           width=self.width, height=self.height, patch=self.patch)
        return img, float(self.times[i])

    def frame_rgbd(self, i):
        """(gray, depth [m], t) — synthetic RGB-D sensor."""
        img, t = self.frame(i)
        depth = render_depth(self.world, self.K, self.poses_gt[i],
                             width=self.width, height=self.height, patch=self.patch)
        return img, depth, t

    def frame_stereo(self, i, baseline: float):
        """(gray_left, gray_right, t): a rectified stereo pair, the right
        camera offset by ``baseline`` metres along +x of the left camera
        frame.  Only the left image follows ``lost_span``."""
        img_l, t = self.frame(i)
        T_rl = lie.se3(lie.quat_identity(device=self.K.device),
                       torch.tensor([-baseline, 0.0, 0.0], dtype=torch.float32,
                                    device=self.K.device))
        T_rw = lie.se3_compose(T_rl, self.poses_gt[i])
        img_r = render_frame(self.world, self.K, T_rw,
                             width=self.width, height=self.height, patch=self.patch)
        return img_l, img_r, t
