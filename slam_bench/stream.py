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

The sensor is the configuration's (``harness.build_config``): a monocular
stream holds the one bank of grey frames.  A stereo stream holds a rectified
pair instead, both banks through ``render_pair_frame``: the left camera's,
and the right camera's, ``T_rw = [I | (-b, 0, 0)] T_lw`` with the baseline
b, the same intrinsics and no distortion.  An RGB-D stream holds the
monocular grey bank and a uint16 bank of ``round(z * depth_factor)``
registered to the grey frame's own (distorted, where the camera has
coefficients) pixels: a pixel holds the depth of the landmark whose splat
it shows, 0 where it shows none.

``render_frame`` splats at the rounded centre and keeps the brightest splat
where splats overlap: a disparity read from two such frames is off by up to
a pixel and can mix two landmarks.  ``render_pair_frame`` renders what a
camera sees: each splat at its sub-pixel centre (box-filtered coverage,
bilinear texture) and the nearest splat over the farther ones, so the two
frames of a pair show each landmark at its own projection.

The same seed gives the same world, path, banks and truth.  Both renderers
are order-independent (scatter-max and scatter-min), so the banks do not
depend on the order of the device's sums.

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


def render_frame(world, K, T_cw, *, width, height, patch=4, dist=None, depth_factor=None):
    """One grayscale frame [H, W] float32 by splatting textured squares;
    with ``dist`` (k1, k2, p1, p2, k3) each centre is distorted first.  With
    ``depth_factor``, (frame, depth [H, W] uint16): a pixel holds
    ``round(z * depth_factor)`` of the landmark whose splat sets its value
    (the brightest, which ``amax`` keeps; of equals the nearest), and 0
    where no splat reaches the background."""
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
    if depth_factor is None:
        return img.reshape(height, width)
    raw = torch.clamp(torch.round(depth * depth_factor), 1.0, 65535.0)
    far = torch.full((height * width,), float("inf"), dtype=torch.float32, device=cx.device)
    for dy in range(-patch, patch + 1):
        for dx in range(-patch, patch + 1):
            inside = (abs(dy) <= px) & (abs(dx) <= px)
            idx = torch.clamp(cy + dy, 0, height - 1) * width + torch.clamp(cx + dx, 0, width - 1)
            val = torch.where(inside, inten * world.tex[:, dy + TEX_R, dx + TEX_R], 0.0)
            # the splat this pixel shows gave it its value; the background's 40
            # is above every splat that is hidden, outside or not in view (0)
            far.scatter_reduce_(0, idx, torch.where(val >= img[idx], raw, float("inf")),
                                "amin", include_self=True)
    d = torch.where(torch.isinf(far), 0.0, far).to(torch.uint16)
    return img.reshape(height, width), d.reshape(height, width)


def render_pair_frame(world, K, T_cw, *, width, height, patch=4):
    """One grayscale frame [H, W] float32 of a rectified camera (no
    distortion) as the camera sees the splats: a landmark's square of
    half-size ``px`` (as ``render_frame`` sizes it) plus half a pixel sits
    at its projected sub-pixel centre; a pixel takes its coverage of the
    nearest square that reaches it, with that square's texture sampled
    bilinearly at the pixel's offset from the centre, over the background's
    40."""
    uv, depth = camera.project_world(K, T_cw, world.xyz)
    px = torch.clamp(world.size * K[0] / torch.clamp_min(depth, 0.3), 1.0, float(patch))
    vis = ((depth > 0.3) & (uv[:, 0] > -8) & (uv[:, 0] < width + 8)
           & (uv[:, 1] > -8) & (uv[:, 1] < height + 8))
    uv = torch.where(vis[:, None], uv, 0.0)
    off = torch.arange(-patch - 1, patch + 3, device=uv.device, dtype=torch.float32)

    def axis(c, size):
        """Pixel centres [M, n] near c [M], their coverage, the texture's
        lower index and weight of the upper one, and whether in the image."""
        x = torch.floor(c)[:, None] + off
        cover = torch.clamp(torch.minimum(x + 0.5, (c + px + 0.5)[:, None])
                            - torch.maximum(x - 0.5, (c - px - 0.5)[:, None]), 0.0, 1.0)
        rel = x - c[:, None]
        lo = torch.floor(rel)
        idx = torch.clamp(lo.to(torch.int64) + TEX_R, 0, 2 * TEX_R - 1)
        return x.to(torch.int64), cover, idx, rel - lo, (x >= 0) & (x < size)

    xs, cov_x, tx, wx, in_x = axis(uv[:, 0], width)
    ys, cov_y, ty, wy, in_y = axis(uv[:, 1], height)
    m = torch.arange(len(px), device=uv.device)[:, None, None]
    iy, ix = ty[:, :, None], tx[:, None, :]
    fy, fx = wy[:, :, None], wx[:, None, :]
    tex = world.tex
    alb = ((1 - fy) * ((1 - fx) * tex[m, iy, ix] + fx * tex[m, iy, ix + 1])
           + fy * ((1 - fx) * tex[m, iy + 1, ix] + fx * tex[m, iy + 1, ix + 1]))
    cover = cov_y[:, :, None] * cov_x[:, None, :]
    shown = vis[:, None, None] & (cover > 0) & in_y[:, :, None] & in_x[:, None, :]
    n_pix = height * width
    idx = torch.where(shown, ys[:, :, None] * width + xs[:, None, :], n_pix).reshape(-1)
    z = torch.where(shown, depth[:, None, None], float("inf")).reshape(-1)
    near = torch.full((n_pix + 1,), float("inf"), device=uv.device)
    near.scatter_reduce_(0, idx, z, "amin", include_self=True)
    val = cover * world.intensity[:, None, None] * alb + (1 - cover) * 40.0
    win = shown.reshape(-1) & (z == near[idx])
    img = torch.full((n_pix + 1,), -1.0, device=uv.device)
    img.scatter_reduce_(0, idx, torch.where(win, val.reshape(-1), -1.0), "amax",
                        include_self=True)
    return torch.where(img[:n_pix] < 0, 40.0, img[:n_pix]).reshape(height, width)


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
    no copy, no rendering); ``right(k)`` (stereo): the right camera's uint8
    frame; ``depth(k)`` (RGB-D): the registered uint16 depth; ``time(k)`` =
    k / fps; ``pose(k)``: the true world->(left) camera pose [7] (numpy);
    ``landmarks``: [M, 3] numpy; ``K`` and ``dist`` (None for a pinhole):
    the camera it was rendered through.
    """

    def __init__(self, traffic: dict, camera_cfg, seed: int, device, sensor="monocular"):
        c = camera_cfg
        self.sensor = sensor
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
        shape = (n, self.height, self.width)
        self.bank = torch.empty(shape, dtype=torch.uint8, device=device)
        self.bank_r = self.bank_d = None
        if sensor == "stereo":
            self.bank_r = torch.empty(shape, dtype=torch.uint8, device=device)
            to_right = torch.tensor([0, 0, 0, 0, -float(c.baseline), 0, 0], device=device)
        elif sensor == "rgbd":
            self.bank_d = torch.empty(shape, dtype=torch.uint16, device=device)
        elif sensor != "monocular":
            raise ValueError(f"unknown sensor {sensor!r}")
        size = dict(width=self.width, height=self.height, patch=patch)

        def grey(img):
            return torch.clamp(torch.round(img), 0, 255).to(torch.uint8)

        for i in range(n):
            if self.bank_r is not None:
                self.bank[i] = grey(render_pair_frame(world, K, poses_dev[i], **size))
                # a rotation-free translation composed on the left: T_rw = T_rl T_lw
                self.bank_r[i] = grey(render_pair_frame(world, K, poses_dev[i] + to_right,
                                                        **size))
            elif self.bank_d is not None:
                img, self.bank_d[i] = render_frame(world, K, poses_dev[i], dist=dist,
                                                   depth_factor=float(c.depth_factor), **size)
                self.bank[i] = grey(img)
            else:
                self.bank[i] = grey(render_frame(world, K, poses_dev[i], dist=dist, **size))

    def bank_index(self, k: int) -> int:
        n, lo = self.n_bank, self.loop_from
        if k < n:
            return k
        period = 2 * (n - 1 - lo)
        r = (k - lo) % period
        return lo + (r if r <= n - 1 - lo else period - r)

    def frame(self, k: int):
        return self.bank[self.bank_index(k)]

    def right(self, k: int):
        return self.bank_r[self.bank_index(k)]

    def depth(self, k: int):
        return self.bank_d[self.bank_index(k)]

    def time(self, k: int) -> float:
        return k / self.fps

    def pose(self, k: int):
        return self.poses[self.bank_index(k)]
