"""Radial-tangential ("plumb bob") distortion and keypoint undistortion (port
of ``rumi_slam_tpu/geometry/distortion.py``).

The pipeline stays pinhole: keypoints are undistorted once after
extraction, so every later stage sees ideal pixels.  ``undistort_points``
inverts the distortion by a fixed count of fixed-point iterations, as the
JAX package does (8 by default).
"""

from __future__ import annotations

import numpy as np
import torch


def distort_normalized(xy, dist):
    """Apply radtan distortion to normalized coordinates [..., 2].

    dist: [5] (k1, k2, p1, p2, k3).
    """
    k1, k2, p1, p2, k3 = dist[0], dist[1], dist[2], dist[3], dist[4]
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    x_t = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    y_t = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([x * radial + x_t, y * radial + y_t], dim=-1)


def undistort_points(K, dist, uv, *, n_iters: int = 8):
    """Undistort pixel keypoints [..., 2] -> ideal pinhole pixels.

    Fixed-point iteration x_{n+1} = (x_d - tangential(x_n)) / radial(x_n)
    from x_0 = x_d, ``n_iters`` times; a radial factor under 1e-9 in
    magnitude is replaced by 1e-9.
    """
    fx, fy, cx, cy = K[0], K[1], K[2], K[3]
    k1, k2, p1, p2, k3 = dist[0], dist[1], dist[2], dist[3], dist[4]
    xd = (uv[..., 0] - cx) / fx
    yd = (uv[..., 1] - cy) / fy
    x, y = xd, yd
    for _ in range(n_iters):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        x_t = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        y_t = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        inv = 1.0 / torch.where(torch.abs(radial) < 1e-9, 1e-9, radial)
        x, y = (xd - x_t) * inv, (yd - y_t) * inv
    return torch.stack([x * fx + cx, y * fy + cy], dim=-1)


def has_distortion(dist) -> bool:
    return dist is not None and bool(np.any(np.asarray(dist) != 0.0))
