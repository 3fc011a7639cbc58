"""Closed-form Sim(3)/SE(3) point-cloud alignment: Umeyama and Horn (port of
``rumi_slam_tpu/geometry/alignment.py``)."""

from __future__ import annotations

import torch

from . import lie


def umeyama_alignment(src, dst, weights=None, *, with_scale=True):
    """Weighted Umeyama: the Sim3 S with dst ~= s R src + t.

    Args:
      src, dst: [N, 3] point sets.
      weights:  [N] nonnegative (None = uniform); zero-weight rows are ignored.
      with_scale: if False, the scale is fixed to 1.
    Returns S [8] (see ``lie``) mapping the src frame to the dst frame.
    """
    n = src.shape[0]
    w = torch.ones((n,), dtype=src.dtype, device=src.device) if weights is None else weights
    wn = w / torch.clamp_min(torch.sum(w), 1e-9)

    mu_s = torch.sum(wn[:, None] * src, dim=0)
    mu_d = torch.sum(wn[:, None] * dst, dim=0)
    sc = src - mu_s
    dc = dst - mu_d

    Sigma = torch.einsum("n,ni,nj->ij", wn, dc, sc)
    U, D, Vt = torch.linalg.svd(Sigma)
    det_sign = torch.sign(torch.linalg.det(U) * torch.linalg.det(Vt))
    diag = torch.stack([torch.ones_like(det_sign), torch.ones_like(det_sign), det_sign])
    R = U @ torch.diag(diag) @ Vt

    var_s = torch.sum(wn * torch.sum(sc * sc, dim=-1))
    trace_DS = torch.sum(D * diag)
    s = trace_DS / torch.clamp_min(var_s, 1e-12) if with_scale else torch.ones_like(var_s)

    t = mu_d - s * (R @ mu_s)
    q = lie.quat_from_matrix(R)
    return torch.cat([q, t, torch.log(torch.clamp_min(s, 1e-12))[None]], dim=-1)


def horn_alignment(src, dst, weights=None):
    """Horn's quaternion method with scale: dst ~= s R src + t.

    Same contract as :func:`umeyama_alignment`, batched over leading axes:
    ``src``, ``dst`` [..., N, 3], ``weights`` [..., N]; returns S [..., 8].
    The RANSAC callers pass all their 3-point hypotheses in one call.  The
    rotation is the top eigenvector of a 4x4 symmetric matrix (one batched
    ``eigh``), w >= 0.
    """
    w = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device) \
        if weights is None else weights
    wn = w / torch.clamp_min(torch.sum(w, dim=-1, keepdim=True), 1e-9)

    mu_s = torch.sum(wn[..., None] * src, dim=-2)
    mu_d = torch.sum(wn[..., None] * dst, dim=-2)
    sc = src - mu_s[..., None, :]
    dc = dst - mu_d[..., None, :]

    Mx = torch.einsum("...n,...ni,...nj->...ij", wn, sc, dc)  # src->dst correlation
    sxx, sxy, sxz = Mx[..., 0, 0], Mx[..., 0, 1], Mx[..., 0, 2]
    syx, syy, syz = Mx[..., 1, 0], Mx[..., 1, 1], Mx[..., 1, 2]
    szx, szy, szz = Mx[..., 2, 0], Mx[..., 2, 1], Mx[..., 2, 2]
    N = torch.stack(
        [
            sxx + syy + szz, syz - szy, szx - sxz, sxy - syx,
            syz - szy, sxx - syy - szz, sxy + syx, szx + sxz,
            szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy,
            sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz,
        ],
        dim=-1,
    ).reshape(Mx.shape[:-2] + (4, 4))
    q = torch.linalg.eigh(N)[1][..., :, -1]   # largest eigenvalue -> (w, x, y, z)
    q = lie.quat_normalize(torch.where(q[..., :1] < 0, -q, q))

    rot_sc = lie.quat_rotate(q[..., None, :], sc)
    num = torch.sum(wn * torch.sum(dc * rot_sc, dim=-1), dim=-1)
    den = torch.sum(wn * torch.sum(sc * sc, dim=-1), dim=-1)
    s = torch.clamp_min(num / torch.clamp_min(den, 1e-12), 1e-9)

    t = mu_d - s[..., None] * lie.quat_rotate(q, mu_s)
    return torch.cat([q, t, torch.log(s)[..., None]], dim=-1)
