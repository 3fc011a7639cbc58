"""Radial-tangential ("plumb bob") distortion, written for the benchmark
(not a copy of the program's): the render distorts each landmark's
projection with it, and the step checks' reference undistorts its ORB
keypoints with it as the program does after extraction.

``dist`` is (k1, k2, p1, p2, k3); ``K`` is (fx, fy, cx, cy).
"""

from __future__ import annotations

import torch


def _distort(x, y, dist):
    k1, k2, p1, p2, k3 = (dist[i] for i in range(5))
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    return (x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x),
            y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y)


def distort_pixels(K, dist, uv):
    """Ideal pinhole pixels [..., 2] -> distorted pixels."""
    x, y = (uv[..., 0] - K[2]) / K[0], (uv[..., 1] - K[3]) / K[1]
    xd, yd = _distort(x, y, dist)
    return torch.stack([xd * K[0] + K[2], yd * K[1] + K[3]], dim=-1)


def undistort_pixels(K, dist, uv, *, iters=20):
    """Distorted pixels [..., 2] -> ideal pinhole pixels, by Newton's method
    on the 2x2 system in float64 (the Jacobian by central differences)."""
    dt = uv.dtype
    K, dist = K.double(), dist.double()
    xd, yd = (uv[..., 0].double() - K[2]) / K[0], (uv[..., 1].double() - K[3]) / K[1]
    x, y = xd.clone(), yd.clone()
    h = 1e-7
    for _ in range(iters):
        fx, fy = _distort(x, y, dist)
        ex, ey = fx - xd, fy - yd
        ax, ay = _distort(x + h, y, dist)
        bx, by = _distort(x - h, y, dist)
        cx, cy = _distort(x, y + h, dist)
        dx, dy = _distort(x, y - h, dist)
        j11, j21 = (ax - bx) / (2 * h), (ay - by) / (2 * h)
        j12, j22 = (cx - dx) / (2 * h), (cy - dy) / (2 * h)
        det = j11 * j22 - j12 * j21
        x = x - (j22 * ex - j12 * ey) / det
        y = y - (-j21 * ex + j11 * ey) / det
    return torch.stack([x * K[0] + K[2], y * K[1] + K[3]], dim=-1).to(dt)
