"""Closed-form Sim(3)/SE(3) point-cloud alignment (port of ``umeyama_alignment``
of ``rumi_slam_tpu/geometry/alignment.py``; ``horn_alignment`` is not ported
yet)."""

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
