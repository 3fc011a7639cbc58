"""Bundle adjustment: Levenberg-Marquardt with Schur-complement elimination
of the points (port of ``rumi_slam_tpu/optim/ba.py``), and ``marginalize``, the Schur
complement of one block of a dense system.

Problem layout (static shapes):
  poses   [C, 7]   SE(3) T_cw per camera
  points  [P, 3]   world points
  cam_idx [O]      observation -> camera row
  pt_idx  [O]      observation -> point row (invalid obs: conf == 0)
  uv      [O, 2]   measured pixels
  conf    [O]      information weight (0 disables)

Per LM iteration: block-diagonal Hcc [C,6,6] and Hpp [P,3,3], dense cross
blocks W [P,C,6,3], the reduced camera system S = Hcc - W Hpp^-1 W^T
([6C, 6C]) solved with ``torch.linalg.solve_ex`` (no host sync), then point
back-substitution.  Accept and damping decisions stay on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import camera, lie
from . import robust

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


class BAResult(NamedTuple):
    poses: torch.Tensor       # [C,7]
    points: torch.Tensor      # [P,3]
    cost: torch.Tensor        # final robust cost
    inlier_obs: torch.Tensor  # [O] bool — chi2 gate at the final estimate


def _inv3x3(M):
    """Batched closed-form 3x3 inverse; a singular block gives 0."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    ok = torch.abs(det) > 1e-10
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, torch.ones_like(det)), 0.0)
    adj = torch.stack(
        [
            A, -(b * i - c * h), (b * f - c * e),
            B, (a * i - c * g), -(a * f - c * d),
            C, -(a * h - b * g), (a * e - b * d),
        ],
        dim=-1,
    ).reshape(M.shape)
    return adj * inv_det[..., None, None]


def _problem_terms(K, poses, points, cam_idx, pt_idx, uv, conf, bf=None, ur=None):
    """Residuals, Jacobians and IRLS weights per observation.

    With ``bf``/``ur`` given, observations with ur >= 0 get the 3-row stereo
    residual (u, v, u_r) and the stereo chi2 gate; rows with ur < 0
    zero-weight the third row.
    """
    pose_o = poses[cam_idx]
    X_o = points[pt_idx]
    if ur is None:
        r, Jc, Jp, depth = camera.reproj_residual_and_jacobians(K, pose_o, X_o, uv)
        chi2 = torch.sum(r * r, dim=-1) * conf
        th = CHI2_MONO
    else:
        has_ur = ur >= 0
        r, Jc, Jp, depth = camera.reproj_residual_and_jacobians_stereo(
            K, bf, pose_o, X_o, uv, torch.clamp_min(ur, 0.0))
        ones = torch.ones_like(ur)
        row_w = torch.stack([ones, ones, has_ur.to(ur.dtype)], dim=1)
        r = r * row_w
        Jc = Jc * row_w[:, :, None]
        Jp = Jp * row_w[:, :, None]
        chi2 = torch.sum(r * r, dim=-1) * conf
        th = torch.where(has_ur, CHI2_STEREO, CHI2_MONO)
    w = conf * robust.huber_weight(chi2, th) * (depth > 0.05)
    cost = torch.sum(torch.where(conf > 0, robust.huber_cost(chi2, th), 0.0))
    return r, Jc, Jp, w, cost, chi2


def _solve_step(K, poses, points, cam_idx, pt_idx, uv, conf, cam_free, pt_free, lam,
                bf=None, ur=None):
    C, P = poses.shape[0], points.shape[0]
    dt, dev = poses.dtype, poses.device
    r, Jc, Jp, w, _, _ = _problem_terms(K, poses, points, cam_idx, pt_idx, uv, conf, bf, ur)

    def segsum(x, idx, n):
        return torch.zeros((n,) + x.shape[1:], dtype=dt, device=dev).index_add_(0, idx, x)

    Hcc = segsum(torch.einsum("oki,o,okj->oij", Jc, w, Jc), cam_idx, C)
    bc = segsum(torch.einsum("oki,o,ok->oi", Jc, w, r), cam_idx, C)
    Hpp = segsum(torch.einsum("oki,o,okj->oij", Jp, w, Jp), pt_idx, P)
    bp = segsum(torch.einsum("oki,o,ok->oi", Jp, w, r), pt_idx, P)

    # LM damping on both diagonals
    eye6 = torch.eye(6, dtype=dt, device=dev)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    Hcc_d = Hcc + lam * eye6 * torch.clamp_min(
        torch.diagonal(Hcc, dim1=-2, dim2=-1).sum(-1)[:, None, None] / 6.0, 1e-6)
    Hpp_d = Hpp + lam * eye3 * torch.clamp_min(
        torch.diagonal(Hpp, dim1=-2, dim2=-1).sum(-1)[:, None, None] / 3.0, 1e-6)

    Hpp_inv = _inv3x3(Hpp_d) * pt_free[:, None, None]

    # cross blocks W[p, c] = sum over obs (c, p) of w Jc^T Jp   [P, C, 6, 3]
    Wblk = torch.zeros((P, C, 6, 3), dtype=dt, device=dev).index_put(
        (pt_idx, cam_idx), torch.einsum("oki,o,okj->oij", Jc, w, Jp), accumulate=True)

    Y = torch.einsum("pcij,pjk->pcik", Wblk, Hpp_inv)            # W Hpp^-1
    S_corr = torch.einsum("pcik,pdmk->cidm", Y, Wblk)            # [C,6,C,6]
    eyeC = torch.eye(C, dtype=dt, device=dev)
    S = torch.einsum("cd,cij->cidj", eyeC, Hcc_d) - S_corr
    b_red = bc - torch.einsum("pcik,pk->ci", Y, bp)              # [C,6]

    # fixed cameras: identity rows/cols, zero rhs
    free = cam_free.to(dt)
    S = S * free[:, None, None, None] * free[None, None, :, None]
    S = S + torch.einsum("cd,cij->cidj", eyeC * (1.0 - free)[:, None], eye6.expand(C, 6, 6))
    b_red = b_red * free[:, None]

    Sd = S.reshape(C * 6, C * 6) + 1e-8 * torch.eye(C * 6, dtype=dt, device=dev)
    dxc = -torch.linalg.solve_ex(Sd, b_red.reshape(C * 6))[0].reshape(C, 6)
    dxc = dxc * cam_free[:, None]

    # back-substitution for points
    t_p = torch.einsum("pcik,ci->pk", Wblk, dxc)                 # W^T dxc
    dxp = -torch.einsum("pij,pj->pi", Hpp_inv, bp + t_p)
    dxp = dxp * pt_free[:, None]
    return lie.se3_retract(poses, dxc), points + dxp


def bundle_adjust(K, poses, points, cam_idx, pt_idx, uv, conf, cam_free, pt_free, *,
                  n_iters: int = 10, bf=None, ur=None) -> BAResult:
    """Run LM bundle adjustment; see the module docstring for the layout.

    Optional stereo: pass ``bf`` (fx * baseline) and per-observation ``ur``
    (virtual right u; < 0 = mono row) to add the u_r residual row.
    """
    cam_free = cam_free.to(torch.bool)
    pt_free = pt_free.to(torch.bool)
    cam_idx = torch.clamp(cam_idx.long(), 0, poses.shape[0] - 1)
    pt_idx = torch.clamp(pt_idx.long(), 0, points.shape[0] - 1)
    args = (cam_idx, pt_idx, uv, conf)

    lam = torch.full((), 1e-4, dtype=torch.float32, device=poses.device)
    for _ in range(n_iters):
        cost0 = _problem_terms(K, poses, points, *args, bf, ur)[4]
        cand_poses, cand_points = _solve_step(K, poses, points, *args, cam_free, pt_free,
                                              lam, bf, ur)
        cost1 = _problem_terms(K, cand_poses, cand_points, *args, bf, ur)[4]
        accept = cost1 < cost0
        poses = torch.where(accept, cand_poses, poses)
        points = torch.where(accept, cand_points, points)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-8, 1e4)
    _, _, _, _, cost, chi2 = _problem_terms(K, poses, points, *args, bf, ur)
    th = CHI2_MONO if ur is None else torch.where(ur >= 0, CHI2_STEREO, CHI2_MONO)
    return BAResult(poses=poses, points=points, cost=cost,
                    inlier_obs=(chi2 <= th) & (conf > 0))


def marginalize(H, b, start: int, end: int):
    """Schur-complement marginalization of block [start, end) out of a dense
    (H, b) Gauss-Newton system — the reference's Optimizer::Marginalize
    (Optimizer.h:94-96, used by its inertial sliding-window optimizers).

    Returns (H', b') of the SAME shape with the marginalized rows/cols zeroed,
    matching the reference's convention.  ``start``/``end`` are Python ints.
    """
    n = H.shape[0]
    keep = torch.ones(n, dtype=torch.bool, device=H.device)
    keep[start:end] = False
    Haa = H[start:end, start:end]
    # pseudo-inverse via eigendecomposition: the marginalized block is often
    # rank-deficient (gauge freedom), exactly why the reference uses SVD here
    w, V = torch.linalg.eigh(0.5 * (Haa + Haa.T))
    big = w > 1e-8 * torch.max(torch.abs(w))
    inv_w = torch.where(big, 1.0 / torch.where(big, w, torch.ones_like(w)), torch.zeros_like(w))
    Haa_inv = (V * inv_w[None, :]) @ V.T
    Hba = H[keep][:, start:end]
    Hbb = H[keep][:, keep]
    Hs = Hbb - Hba @ Haa_inv @ Hba.T
    bs = b[keep] - Hba @ Haa_inv @ b[start:end]
    # scatter back into full-size arrays with zeros at the marginalized block
    idx = keep.nonzero()[:, 0]
    H_out = torch.zeros_like(H)
    H_out[idx[:, None], idx[None, :]] = Hs
    b_out = torch.zeros_like(b)
    b_out[keep] = bs
    return H_out, b_out
