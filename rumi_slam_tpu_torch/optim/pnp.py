"""PnP: camera pose from 2D-3D matches via DLT-RANSAC + motion-only BA
(port of ``rumi_slam_tpu/optim/pnp.py``).

As in ``two_view``, the hypotheses' index sets come from a draw callable
(``ransac.sampler``), and ``pnp_ransac_from`` takes them explicitly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import camera, lie
from . import pose_opt


class PnPResult(NamedTuple):
    pose: torch.Tensor       # [7] T_cw
    inliers: torch.Tensor    # [N] bool
    n_inliers: torch.Tensor
    ok: torch.Tensor


def _dlt_pose(X, rays):
    """P from 6+ points, rays ~ P [X; 1]; X [..., M, 3], rays [..., M, 3].
    Returns T_cw [..., 7] (rotation orthogonalized by SVD)."""
    x = rays[..., 0] / rays[..., 2]
    y = rays[..., 1] / rays[..., 2]
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)
    zeros = torch.zeros_like(Xh)
    r1 = torch.cat([Xh, zeros, -x[..., None] * Xh], dim=-1)
    r2 = torch.cat([zeros, Xh, -y[..., None] * Xh], dim=-1)
    A = torch.cat([r1, r2], dim=-2)                                   # [..., 2M, 12]
    P = torch.linalg.eigh(A.transpose(-1, -2) @ A)[1][..., :, 0]
    P = P.reshape(P.shape[:-1] + (3, 4))
    U, S, Vt = torch.linalg.svd(P[..., :3])
    sgn = torch.sign(torch.linalg.det(U @ Vt))
    d = torch.stack([torch.ones_like(sgn), torch.ones_like(sgn), sgn], dim=-1)
    R = (U * d[..., None, :]) @ Vt
    scale = torch.sum(S * d, dim=-1) / 3.0
    scale = torch.where(torch.abs(scale) < 1e-12, torch.full_like(scale, 1e-12), scale)
    t = P[..., 3] / scale[..., None]
    return lie.se3(lie.quat_from_matrix(R), t)


def sample_logits(valid, quality=None):
    """The sampling logits: valid rows, weighted by ``quality`` if given."""
    w = valid.to(torch.float32)
    if quality is not None:
        w = w * torch.clamp_min(quality, 1e-3)
    return torch.log(torch.clamp_min(w, 1e-12))


def pnp_ransac(draw, K, X_w, uv, valid, *, quality=None, n_hyp: int = 1024, **kw):
    """Robust pose from world points + pixel observations, drawing the
    ``n_hyp`` 6-row index sets with ``draw(logits, (n_hyp, 6))``.

    ``quality``: optional [N] sampling weight (larger = more trustworthy,
    e.g. ``max_hamming - match_distance``): guided sampling keeps clean
    6-point samples likely at the 15-30% inlier rates of relocalisation.
    """
    idx = draw(sample_logits(valid, quality), (n_hyp, 6)).to(X_w.device)
    return pnp_ransac_from(idx, K, X_w, uv, valid, **kw)


def pnp_ransac_from(idx, K, X_w, uv, valid, *, reproj_thresh: float = 5.0,
                    min_inliers: int = 15):
    """Score the 6-point DLT hypotheses ``idx [H, 6]`` by reprojection
    consensus, then polish the winner on its consensus set."""
    idx = idx.long()
    rays = camera.unproject(K, uv)
    poses = _dlt_pose(X_w[idx], rays[idx])                            # [H,7]

    pc = lie.se3_apply(poses[:, None, :], X_w[None])                  # [H,N,3]
    err = torch.linalg.vector_norm(camera.project(K, pc) - uv, dim=-1)
    scores = torch.sum(((err < reproj_thresh) & (pc[..., 2] > 0.01) & valid).to(torch.int32),
                       dim=-1)
    pose0 = poses[torch.argmax(scores)]

    # polish only on the winner's consensus set
    pc0 = lie.se3_apply(pose0, X_w)
    err0 = torch.linalg.vector_norm(camera.project(K, pc0) - uv, dim=-1)
    consensus = valid & (err0 < reproj_thresh) & (pc0[:, 2] > 0.01)
    res = pose_opt.pose_optimization(K, pose0, X_w, uv, consensus)
    return PnPResult(pose=res.pose, inliers=res.inliers, n_inliers=res.n_inliers,
                     ok=res.n_inliers >= min_inliers)
