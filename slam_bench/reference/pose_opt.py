# Frozen copy of rumi_slam_tpu_torch/optim/pose_opt.py at commit 359566b (plain PyTorch,
# no kernel): the benchmark's reference.  Imports made relative; no other change.
"""Motion-only bundle adjustment: one SE(3) pose vs fixed 3D points (port of
``rumi_slam_tpu/optim/pose_opt.py``): monocular, and stereo/RGB-D with a
third residual row.

The JAX ``lax.scan``s become Python loops over a fixed schedule.  Accept and
damping decisions stay on the device as ``torch.where`` selections, and the
6x6 solve is ``torch.linalg.solve_ex``, so the loop never waits for the
device: ``torch.linalg.solve`` would check its info and sync the host on
each of the iterations.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import camera, lie
from . import robust

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


class PoseOptResult(NamedTuple):
    pose: torch.Tensor       # [7]
    inliers: torch.Tensor    # [N] bool
    n_inliers: torch.Tensor  # scalar int32
    cost: torch.Tensor       # scalar


def _normal_equations(K, pose, X, uv, w, inv_sigma2):
    r, J, _, depth = camera.reproj_residual_and_jacobians(K, pose, X, uv)
    chi2 = torch.sum(r * r, dim=-1) * inv_sigma2
    w_rob = robust.huber_weight(chi2, CHI2_MONO) * inv_sigma2
    ww = w * w_rob * (depth > 0.05)
    H = torch.einsum("nki,n,nkj->ij", J, ww, J)
    g = torch.einsum("nki,n,nk->i", J, ww, r)
    cost = torch.sum(w * robust.huber_cost(chi2, CHI2_MONO))
    return H, g, cost, chi2


def pose_optimization(K, pose0, X_w, uv, valid, inv_sigma2=None, *,
                      n_rounds: int = 4, n_iters: int = 10):
    """Optimize a single camera pose against fixed world points.

    Args:
      K: [4] intrinsics.  pose0: [7] initial T_cw.  X_w: [N, 3] fixed world
      points.  uv: [N, 2] observations.  valid: [N] bool.
      inv_sigma2: [N] per-observation information; None = 1.

    ``n_rounds`` rounds of ``n_iters`` LM iterations, with chi-square
    (5.991) outlier re-classification after each round.  Returns
    PoseOptResult; ``inliers`` is the classification at the final pose.
    """
    n = X_w.shape[0]
    dev = X_w.device
    if inv_sigma2 is None:
        inv_sigma2 = torch.ones((n,), dtype=torch.float32, device=dev)
    w0 = valid.to(torch.float32)
    eye = torch.eye(6, dtype=torch.float32, device=dev)

    pose, w = pose0, w0
    cost = None
    for _ in range(n_rounds):
        lam = torch.full((), 1e-3, dtype=torch.float32, device=dev)
        cost = torch.full((), float("inf"), dtype=torch.float32, device=dev)
        for _ in range(n_iters):
            H, g, cost_cur, _ = _normal_equations(K, pose, X_w, uv, w, inv_sigma2)
            Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-9 * eye
            tau = -torch.linalg.solve_ex(Hd, g)[0]
            cand = lie.se3_retract(pose, tau)
            _, _, cost_new, _ = _normal_equations(K, cand, X_w, uv, w, inv_sigma2)
            accept = cost_new < cost_cur
            pose = torch.where(accept, cand, pose)
            lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-8, 1e6)
            cost = torch.where(accept, cost_new, cost_cur)
        r, _, _, depth = camera.reproj_residual_and_jacobians(K, pose, X_w, uv)
        chi2 = torch.sum(r * r, dim=-1) * inv_sigma2
        w = w0 * ((chi2 <= CHI2_MONO) & (depth > 0.05)).to(torch.float32)

    inliers = w > 0
    return PoseOptResult(
        pose=pose,
        inliers=inliers,
        n_inliers=torch.sum(inliers.to(torch.int32)),
        cost=cost,
    )


def _normal_equations_stereo(K, bf, pose, X, uv, ur, w, inv_sigma2):
    """3-row residual variant: the u_r row is weighted 0 where ur < 0 (a mono
    observation), with the stereo chi2 gate 7.815 on rows that have it."""
    has_ur = ur >= 0
    r, J, _, depth = camera.reproj_residual_and_jacobians_stereo(
        K, bf, pose, X, uv, torch.clamp_min(ur, 0.0))
    ones = torch.ones_like(ur)
    row_w = torch.stack([ones, ones, has_ur.to(torch.float32)], dim=1)
    chi2 = torch.sum(r * r * row_w, dim=-1) * inv_sigma2
    th = torch.where(has_ur, CHI2_STEREO, CHI2_MONO)
    w_rob = robust.huber_weight(chi2, th) * inv_sigma2
    ww = w * w_rob * (depth > 0.05)
    Jw = J * row_w[:, :, None]
    H = torch.einsum("nki,n,nkj->ij", Jw, ww, J)
    g = torch.einsum("nki,n,nk->i", Jw, ww, r)
    cost = torch.sum(w * robust.huber_cost(chi2, th))
    return H, g, cost, chi2, depth


def pose_optimization_stereo(K, bf, pose0, X_w, uv, ur, valid, inv_sigma2=None, *,
                             n_rounds: int = 4, n_iters: int = 10):
    """Stereo/RGB-D motion-only BA: :func:`pose_optimization` with a third
    residual row u_r = u - bf / z on the observations where ``ur >= 0``, and
    the outlier gate per row (7.815 with it, 5.991 without)."""
    n = X_w.shape[0]
    dev = X_w.device
    if inv_sigma2 is None:
        inv_sigma2 = torch.ones((n,), dtype=torch.float32, device=dev)
    bf = torch.as_tensor(bf, dtype=torch.float32, device=dev)
    w0 = valid.to(torch.float32)
    th = torch.where(ur >= 0, CHI2_STEREO, CHI2_MONO)
    eye = torch.eye(6, dtype=torch.float32, device=dev)

    pose, w = pose0, w0
    cost = None
    for _ in range(n_rounds):
        lam = torch.full((), 1e-3, dtype=torch.float32, device=dev)
        cost = torch.full((), float("inf"), dtype=torch.float32, device=dev)
        for _ in range(n_iters):
            H, g, cost_cur, _, _ = _normal_equations_stereo(K, bf, pose, X_w, uv, ur, w,
                                                            inv_sigma2)
            Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-9 * eye
            tau = -torch.linalg.solve_ex(Hd, g)[0]
            cand = lie.se3_retract(pose, tau)
            _, _, cost_new, _, _ = _normal_equations_stereo(K, bf, cand, X_w, uv, ur, w,
                                                            inv_sigma2)
            accept = cost_new < cost_cur
            pose = torch.where(accept, cand, pose)
            lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-8, 1e6)
            cost = torch.where(accept, cost_new, cost_cur)
        _, _, _, chi2, depth = _normal_equations_stereo(K, bf, pose, X_w, uv, ur, w, inv_sigma2)
        w = w0 * ((chi2 <= th) & (depth > 0.05)).to(torch.float32)

    inliers = w > 0
    return PoseOptResult(
        pose=pose,
        inliers=inliers,
        n_inliers=torch.sum(inliers.to(torch.int32)),
        cost=cost,
    )
