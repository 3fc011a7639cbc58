"""Two-view triangulation and epipolar helpers (port of
``rumi_slam_tpu/geometry/triangulation.py``), batched over leading axes;
degenerate inputs give garbage that the returned masks reject."""

from __future__ import annotations

import torch

from . import camera, lie


def triangulate_dlt(T1_cw, T2_cw, ray1, ray2):
    """DLT triangulation from two normalized rays.

    Args:
      T1_cw, T2_cw: [..., 7] world->camera poses.
      ray1, ray2:   [..., 3] normalized camera rays (z=1 plane coords ok).
    Returns X_w [..., 3] (homogeneous-normalized; invalid if w ~ 0).
    """
    P1 = lie.se3_to_matrix(T1_cw)[..., :3, :]
    P2 = lie.se3_to_matrix(T2_cw)[..., :3, :]

    def rows(P, ray):
        x = ray[..., 0] / ray[..., 2]
        y = ray[..., 1] / ray[..., 2]
        return x[..., None] * P[..., 2, :] - P[..., 0, :], y[..., None] * P[..., 2, :] - P[..., 1, :]

    a0, a1 = rows(P1, ray1)
    a2, a3 = rows(P2, ray2)
    A = torch.stack(torch.broadcast_tensors(a0, a1, a2, a3), dim=-2)   # [..., 4, 4]
    # smallest right singular vector (SVD of A: eigh of A^T A squares the
    # condition number, too lossy in float32 for distant points)
    Xh = torch.linalg.svd(A)[2][..., 3, :]
    w = Xh[..., 3]
    w_safe = torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)
    return Xh[..., :3] / w_safe[..., None]


def triangulation_checks(K, T1_cw, T2_cw, uv1, uv2, X_w, *, min_parallax_cos=0.99998,
                         max_reproj_err=2.0):
    """Cheirality + parallax + reprojection gates; boolean mask [...]."""
    x1 = lie.se3_apply(T1_cw, X_w)
    x2 = lie.se3_apply(T2_cw, X_w)
    pos_depth = (x1[..., 2] > 0.05) & (x2[..., 2] > 0.05)

    c1 = lie.se3_t(lie.se3_inverse(T1_cw))
    c2 = lie.se3_t(lie.se3_inverse(T2_cw))
    d1 = X_w - c1
    d2 = X_w - c2
    n1 = torch.linalg.vector_norm(d1, dim=-1)
    n2 = torch.linalg.vector_norm(d2, dim=-1)
    cos_par = torch.sum(d1 * d2, dim=-1) / torch.clamp_min(n1 * n2, 1e-12)
    parallax_ok = cos_par < min_parallax_cos

    e1 = torch.linalg.vector_norm(camera.project(K, x1) - uv1, dim=-1)
    e2 = torch.linalg.vector_norm(camera.project(K, x2) - uv2, dim=-1)
    return pos_depth & parallax_ok & (e1 < max_reproj_err) & (e2 < max_reproj_err)


def essential_from_poses(T1_cw, T2_cw):
    """E_12 such that ray2^T E ray1 = 0 for corresponding rays."""
    T21 = lie.se3_compose(T2_cw, lie.se3_inverse(T1_cw))
    return lie.hat(T21[..., 4:7]) @ lie.quat_to_matrix(T21[..., :4])
