"""The general traffic generator: a synthetic world, a camera path through
it, and a bank of frames rendered on the device before the window opens.

A traffic mix is a data file, ``slam_bench/traffic/<name>.json``; this
module reads every one of them.  Its keys:

``landmarks``, ``world_seed``
    Landmarks of the world (the box of ``make_world``).  Their positions,
    sizes, brightness and texture come from ``world_seed``, the same for
    every ``--seed``; the seed draws the path's jitter (2 mm a frame), so
    every seed gives other frames and poses of the same scene.  A seed that
    drew the scene's look changed the work: under deterministic algorithms
    one seed ran at 2.96 frames/s and another at 3.56, both on repeat.
``path``
    ``{"amp": [x, y, z] metres, "yaw_amp": rad}``: the handheld sweep.
``bank_s``, ``loop_from_s``
    The bank holds ``bank_s`` seconds of the path.  The stream plays it
    forwards, then back and forth over ``[loop_from_s, bank_s)`` (the camera
    reverses there), with timestamps that keep rising at the camera's rate,
    so it never runs dry.
``warmup_s``
    Seconds of stream driven untimed in set-up.
``patch``
    Splat half-size bound in pixels (default 4).

The camera is the configuration's: its intrinsics, size and rate, and its
radial-tangential coefficients, through which each landmark's projection is
distorted before it is splatted (``reference/distortion.py``), so a camera
with published coefficients sees distorted frames and the program's own
undistortion is on the path.

The same seed gives the same world, path, bank and truth.  The renderer is
order-independent (scatter-max), so the frames do not depend on the device.

Copied, with the changes named: ``make_world``, ``render_frame`` and
``sweep_trajectory`` from ``rumi_slam_tpu_torch/io/synthetic.py`` at commit
359566b (the world draws geometry and appearance from two generators; the
render distorts; the sweep returns numpy poses).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from .reference import camera, distortion, lie

HERE = Path(__file__).resolve().parent
TEX_R = 8  # per-landmark texture half-size (supports patch <= 8)


class World(NamedTuple):
    xyz: torch.Tensor        # [M, 3] world landmarks
    intensity: torch.Tensor  # [M]
    size: torch.Tensor       # [M] patch half-size in world units
    tex: torch.Tensor        # [M, 2 TEX_R + 1, 2 TEX_R + 1] albedo


def make_world(n_points, geometry_seed, appearance_seed,
               box=((-5, -3.5, 1.2), (5, 3.5, 8.0)), device="cpu"):
    geo = np.random.default_rng(geometry_seed)
    lo, hi = np.asarray(box[0]), np.asarray(box[1])
    xyz = geo.uniform(lo, hi, size=(n_points, 3)).astype(np.float32)
    size = geo.uniform(0.02, 0.08, size=n_points).astype(np.float32)
    rng = np.random.default_rng(appearance_seed)
    inten = rng.uniform(60, 255, size=n_points).astype(np.float32)
    t = 2 * TEX_R + 1
    tex = rng.uniform(0.35, 1.0, size=(n_points, t, t)).astype(np.float32)
    return World(*(torch.from_numpy(a).to(device) for a in (xyz, inten, size, tex)))


def render_frame(world, K, T_cw, *, width, height, patch=4, dist=None):
    """One grayscale frame [H, W] float32 by splatting textured squares;
    with ``dist`` (k1, k2, p1, p2, k3) each centre is distorted first."""
    uv, depth = camera.project_world(K, T_cw, world.xyz)
    if dist is not None:
        uv = distortion.distort_pixels(K, dist, uv)
    px = torch.clamp(world.size * K[0] / torch.clamp_min(depth, 0.3), 1.0, float(patch))
    vis = ((depth > 0.3) & (uv[:, 0] > -8) & (uv[:, 0] < width + 8)
           & (uv[:, 1] > -8) & (uv[:, 1] < height + 8))
    cx = torch.clamp(torch.round(uv[:, 0]), 0, width - 1).to(torch.int64)
    cy = torch.clamp(torch.round(uv[:, 1]), 0, height - 1).to(torch.int64)
    inten = torch.where(vis, world.intensity, 0.0)
    img = torch.full((height * width,), 40.0, dtype=torch.float32, device=cx.device)
    for dy in range(-patch, patch + 1):
        for dx in range(-patch, patch + 1):
            inside = (abs(dy) <= px) & (abs(dx) <= px)
            yy = torch.clamp(cy + dy, 0, height - 1)
            xx = torch.clamp(cx + dx, 0, width - 1)
            alb = world.tex[:, dy + TEX_R, dx + TEX_R]
            img.scatter_reduce_(0, yy * width + xx, torch.where(inside, inten * alb, 0.0),
                                "amax", include_self=True)
    return img.reshape(height, width)


def sweep_trajectory(n_frames, fps, *, seed, amp, yaw_amp):
    """World->camera poses [n, 7] float32 (quaternion wxyz, translation) of
    the handheld sweep, at ``fps``."""
    rng = np.random.default_rng(seed)
    poses = []
    for i in range(n_frames):
        t = i / fps
        pos = np.asarray([
            amp[0] * np.sin(2 * np.pi * 0.06 * t),
            amp[1] * np.sin(2 * np.pi * 0.11 * t + 1.0),
            amp[2] * np.sin(2 * np.pi * 0.035 * t),
        ], np.float32) + rng.normal(scale=0.002, size=3).astype(np.float32)
        yaw = yaw_amp * np.sin(2 * np.pi * 0.05 * t)
        pitch = 0.4 * yaw_amp * np.sin(2 * np.pi * 0.08 * t + 0.7)
        q = lie.so3_exp(torch.from_numpy(np.asarray([pitch, yaw, 0.0], np.float32)))
        poses.append(lie.se3_inverse(lie.se3(q, torch.from_numpy(pos.astype(np.float32)))))
    return torch.stack(poses).numpy()


def load_traffic(name):
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


class Stream:
    """Frames, timestamps and truth of one run.

    ``frame(k)``: the bank's uint8 [H, W] frame for stream index k (a view,
    no copy, no rendering); ``time(k)`` = k / fps; ``pose(k)``: the true
    world->camera pose [7] (numpy); ``landmarks``: [M, 3] numpy; ``K`` and
    ``dist`` (None for a pinhole): the camera it was rendered through.
    """

    def __init__(self, traffic: dict, camera_cfg, seed: int, device):
        c = camera_cfg
        self.fps = float(c.fps)
        self.width, self.height = int(c.width), int(c.height)
        self.warmup_frames = int(round(traffic["warmup_s"] * self.fps))
        n = int(round(traffic["bank_s"] * self.fps))
        self.n_bank = n
        self.loop_from = int(round(traffic.get("loop_from_s", 0.0) * self.fps))
        if not 0 <= self.loop_from < n - 1:
            raise ValueError("traffic: loop_from_s must lie inside the bank")
        world_seed = int(traffic["world_seed"])
        world = make_world(int(traffic["landmarks"]), [world_seed, 0], [world_seed, 1],
                           device=device)
        path = traffic["path"]
        self.poses = sweep_trajectory(n, self.fps, seed=[seed, 1], amp=path["amp"],
                                      yaw_amp=path["yaw_amp"])
        self.landmarks = world.xyz.cpu().numpy().astype(np.float64)
        K = torch.tensor([c.fx, c.fy, c.cx, c.cy], dtype=torch.float32, device=device)
        patch = int(traffic.get("patch", 4))
        poses_dev = torch.from_numpy(self.poses).to(device)
        coeffs = [float(getattr(c, key, 0.0)) for key in ("k1", "k2", "p1", "p2", "k3")]
        dist = (torch.tensor(coeffs, dtype=torch.float32, device=device)
                if any(coeffs) else None)
        self.K, self.dist = K, dist
        self.bank = torch.empty((n, self.height, self.width), dtype=torch.uint8, device=device)
        for i in range(n):
            img = render_frame(world, K, poses_dev[i], width=self.width, height=self.height,
                               patch=patch, dist=dist)
            self.bank[i] = torch.clamp(torch.round(img), 0, 255).to(torch.uint8)

    def bank_index(self, k: int) -> int:
        n, lo = self.n_bank, self.loop_from
        if k < n:
            return k
        period = 2 * (n - 1 - lo)
        r = (k - lo) % period
        return lo + (r if r <= n - 1 - lo else period - r)

    def frame(self, k: int):
        return self.bank[self.bank_index(k)]

    def time(self, k: int) -> float:
        return k / self.fps

    def pose(self, k: int):
        return self.poses[self.bank_index(k)]
