# Frozen copy of rumi_slam_tpu_torch/geometry/camera.py at commit 359566b (plain PyTorch,
# no kernel): the benchmark's reference.  Imports made relative; no other change.
"""Pinhole camera model: projection, unprojection, analytic Jacobians (port of
``rumi_slam_tpu/geometry/camera.py``).

Intrinsics are a flat ``[4]`` tensor ``(fx, fy, cx, cy)``; all functions
broadcast over leading batch axes.
"""

from __future__ import annotations

import torch

from . import lie


def _inv_depth(z):
    return 1.0 / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)


def project(K, x_cam):
    """Camera-frame points [..., 3] -> pixels [..., 2].  No validity check."""
    fx, fy, cx, cy = K[0], K[1], K[2], K[3]
    zi = _inv_depth(x_cam[..., 2])
    u = fx * x_cam[..., 0] * zi + cx
    v = fy * x_cam[..., 1] * zi + cy
    return torch.stack([u, v], dim=-1)


def unproject(K, uv, depth=None):
    """Pixels [..., 2] (+ optional depth [...]) -> camera-frame rays/points [..., 3]."""
    fx, fy, cx, cy = K[0], K[1], K[2], K[3]
    x = (uv[..., 0] - cx) / fx
    y = (uv[..., 1] - cy) / fy
    ray = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    if depth is not None:
        ray = ray * depth[..., None]
    return ray


def project_jacobian_point(K, x_cam):
    """d(uv)/d(x_cam): [..., 2, 3]."""
    fx, fy = K[0], K[1]
    x, y = x_cam[..., 0], x_cam[..., 1]
    zi = _inv_depth(x_cam[..., 2])
    zi2 = zi * zi
    zero = torch.zeros_like(x)
    J = torch.stack(
        [
            fx * zi, zero, -fx * x * zi2,
            zero, fy * zi, -fy * y * zi2,
        ],
        dim=-1,
    )
    return J.reshape(J.shape[:-1] + (2, 3))


def project_world(K, T_cw, X_w):
    """World points through pose: pixels, depth."""
    x_cam = lie.se3_apply(T_cw, X_w)
    return project(K, x_cam), x_cam[..., 2]


def reproj_residual_and_jacobians(K, T_cw, X_w, uv_obs):
    """Residual r = project(T X) - uv and its Jacobians.

    Returns (r [..., 2], J_pose [..., 2, 6], J_point [..., 2, 3], depth [...]).
    Pose tangent: left-multiplicative ``exp(tau) * T_cw`` with tau = (omega, v),
    so d(xc)/d(tau) = [ -hat(xc) | I ].
    """
    x_cam = lie.se3_apply(T_cw, X_w)
    r = project(K, x_cam) - uv_obs
    Jp = project_jacobian_point(K, x_cam)
    J_omega = -torch.einsum("...ij,...jk->...ik", Jp, lie.hat(x_cam))
    J_pose = torch.cat([J_omega, Jp], dim=-1)
    R = lie.quat_to_matrix(T_cw[..., :4])
    J_point = torch.einsum("...ij,...jk->...ik", Jp, R)
    return r, J_pose, J_point, x_cam[..., 2]


def reproj_residual_and_jacobians_stereo(K, bf, T_cw, X_w, uv_obs, ur_obs):
    """Stereo (or RGB-D virtual-right) residual r = [u - û, v - v̂, u_r - û_r]
    with û_r = û - bf / ẑ (bf = fx * baseline).  Rows with ``ur_obs`` < 0 are
    mono observations; the caller masks their third row.

    Returns (r [..., 3], J_pose [..., 3, 6], J_point [..., 3, 3], depth [...]).
    """
    x_cam = lie.se3_apply(T_cw, X_w)
    z = x_cam[..., 2]
    zi = _inv_depth(z)
    uv_hat = project(K, x_cam)
    ur_hat = uv_hat[..., 0] - bf * zi
    r = torch.cat([uv_hat - uv_obs, (ur_hat - ur_obs)[..., None]], dim=-1)
    Jp2 = project_jacobian_point(K, x_cam)
    e_z = torch.tensor([0.0, 0.0, 1.0], dtype=x_cam.dtype, device=x_cam.device)
    row_ur = Jp2[..., 0, :] + (bf * zi * zi)[..., None] * e_z
    Jp = torch.cat([Jp2, row_ur[..., None, :]], dim=-2)
    J_omega = -torch.einsum("...ij,...jk->...ik", Jp, lie.hat(x_cam))
    J_pose = torch.cat([J_omega, Jp], dim=-1)
    R = lie.quat_to_matrix(T_cw[..., :4])
    J_point = torch.einsum("...ij,...jk->...ik", Jp, R)
    return r, J_pose, J_point, z
