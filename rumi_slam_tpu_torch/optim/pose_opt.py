"""Motion-only bundle adjustment: one SE(3) pose vs fixed 3D points (port of
the mono half of ``rumi_slam_tpu/optim/pose_opt.py``).

The JAX ``lax.scan``s become Python loops over a fixed schedule.  Accept and
damping decisions stay on the device as ``torch.where`` selections, and the
6x6 solve is ``torch.linalg.solve_ex``, so the loop never waits for the
device: ``torch.linalg.solve`` would check its info and sync the host on
each of the iterations.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import camera, lie
from . import robust

CHI2_MONO = 5.991


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
