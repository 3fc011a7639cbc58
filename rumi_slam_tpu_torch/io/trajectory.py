"""Trajectory export and import: TUM, EuRoC and KITTI formats (port of
``rumi_slam_tpu/io/trajectory.py``).

* TUM:   ``timestamp tx ty tz qx qy qz qw`` (seconds, camera-to-world)
* EuRoC: the same fields with integer nanosecond timestamps
* KITTI: the 12 row-major entries of the 3x4 camera-to-world matrix, no stamps

Poses come in and go out as ``[N, 7]`` world-to-camera arrays (the
packages' convention); the files hold camera-to-world, as the reference
system writes them.  The inversions are float32, as in the JAX package.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..geometry import lie


def _twc(poses_cw) -> np.ndarray:
    """[N, 7] world->camera -> [N, 7] camera->world, float32."""
    return lie.se3_inverse(torch.as_tensor(np.asarray(poses_cw), dtype=torch.float32)).numpy()


def _write(path, lines):
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text("\n".join(lines) + "\n")


def _stamped_lines(times, poses_cw, stamp):
    lines = []
    if len(poses_cw):
        for t, T in zip(np.asarray(times), _twc(poses_cw)):
            qw, qx, qy, qz = T[0], T[1], T[2], T[3]
            tx, ty, tz = T[4], T[5], T[6]
            lines.append(f"{stamp(t)} {tx:.7f} {ty:.7f} {tz:.7f} "
                         f"{qx:.7f} {qy:.7f} {qz:.7f} {qw:.7f}")
    return lines


def save_tum(path, times, poses_cw):
    """TUM format: seconds with 6 decimals, then the camera-to-world pose."""
    _write(path, _stamped_lines(times, np.asarray(poses_cw), lambda t: f"{t:.6f}"))


def save_euroc(path, times, poses_cw):
    """EuRoC format: integer nanosecond timestamps, then the camera-to-world
    pose as in TUM."""
    _write(path, _stamped_lines(times, np.asarray(poses_cw), lambda t: f"{int(round(t * 1e9))}"))


def save_kitti(path, poses_cw):
    """KITTI format: per line the 12 row-major entries of the 3x4 [R|t]
    camera-to-world matrix."""
    poses_cw = np.asarray(poses_cw)
    lines = []
    if len(poses_cw):
        Twc = torch.from_numpy(_twc(poses_cw))
        R = lie.quat_to_matrix(Twc[:, :4]).numpy()
        t = Twc[:, 4:7].numpy()
        for Ri, ti in zip(R, t):
            M = np.concatenate([Ri, ti[:, None]], axis=1).reshape(-1)
            lines.append(" ".join(f"{v:.9e}" for v in M))
    _write(path, lines)


def load_tum(path):
    """Read a TUM file.  Returns (times [N] float64, poses_cw [N, 7]
    float32); lines that are empty, comments or not 8 numbers are skipped."""
    times, poses_wc = [], []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        vals = [float(v) for v in line.split()]
        if len(vals) != 8:
            continue
        t, tx, ty, tz, qx, qy, qz, qw = vals
        times.append(t)
        poses_wc.append([qw, qx, qy, qz, tx, ty, tz])
    if not times:
        return np.zeros(0), np.zeros((0, 7))
    Tcw = lie.se3_inverse(torch.tensor(poses_wc, dtype=torch.float32)).numpy()
    return np.asarray(times), Tcw
