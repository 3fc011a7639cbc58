"""Pyramidal Lucas-Kanade optical flow, sparse and batched over the points
(port of ``rumi_slam_tpu/ops/optical_flow.py``).  The lost-frame sampler's
flow magnitude comes from here.  Fixed iteration counts, masked outputs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import image as im


def _gradients(img):
    """Central differences inside, one-sided at the border (``numpy.gradient``)."""
    gy, gx = torch.gradient(img, edge_order=1)
    return gx, gy


def _gather_patches(img, centers_yx, r):
    """``image.gather_patches`` for centres that may lie outside the image, as
    a displaced LK point can: the JAX package's indexing wraps a negative row
    or column of the padded canvas once and clamps what is still out of range
    (a row on its own, a column as the start of its window), and so does
    this."""
    padded = F.pad(img[None, None], (r, r, r, r), mode="reflect")[0, 0]
    hp, wp = padded.shape
    size = 2 * r + 1
    ar = torch.arange(size, device=img.device)
    rows = centers_yx[:, 0, None].long() + ar
    rows = torch.where(rows < 0, rows + hp, rows).clamp(0, hp - 1)
    x0 = centers_yx[:, 1].long()
    x0 = torch.where(x0 < 0, x0 + wp, x0).clamp(0, wp - size)
    cols = x0[:, None] + ar
    return padded[rows[:, :, None], cols[:, None, :]]


def _gather_patches_bilinear(img, yx_f, win_r):
    """Patches at fractional centres: the bilinear blend of the four
    integer-centre patches."""
    i0 = torch.floor(yx_f).to(torch.int32)
    f = yx_f - i0.to(yx_f.dtype)                # [N,2] (fy, fx)
    fy = f[:, 0][:, None, None]
    fx = f[:, 1][:, None, None]
    off = lambda dy, dx: i0 + torch.tensor([dy, dx], dtype=torch.int32, device=i0.device)
    P00 = _gather_patches(img, i0, win_r)
    P01 = _gather_patches(img, off(0, 1), win_r)
    P10 = _gather_patches(img, off(1, 0), win_r)
    P11 = _gather_patches(img, off(1, 1), win_r)
    return ((1 - fy) * (1 - fx) * P00 + (1 - fy) * fx * P01
            + fy * (1 - fx) * P10 + fy * fx * P11)


def _lk_level(prev, cur, pts, disp, *, win_r=7, iters=5):
    """One pyramid level of LK refinement.

    pts: [N,2] (x,y) in this level's coordinates.  disp: [N,2] current estimate.
    """
    gx, gy = _gradients(prev)
    # template and gradients sampled at the true fractional positions, like
    # the moving patch below
    yx = torch.stack([pts[:, 1], pts[:, 0]], -1)
    P0 = _gather_patches_bilinear(prev, yx, win_r)   # [N,w,w]
    Gx = _gather_patches_bilinear(gx, yx, win_r)
    Gy = _gather_patches_bilinear(gy, yx, win_r)

    g11 = torch.sum(Gx * Gx, dim=(1, 2))
    g12 = torch.sum(Gx * Gy, dim=(1, 2))
    g22 = torch.sum(Gy * Gy, dim=(1, 2))
    det = g11 * g22 - g12 * g12
    ok = det > 1e-6
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, torch.ones_like(det)), 0.0)

    for _ in range(iters):
        yx2 = torch.stack([pts[:, 1] + disp[:, 1], pts[:, 0] + disp[:, 0]], -1)
        P1 = _gather_patches_bilinear(cur, yx2, win_r)
        dt = P1 - P0
        b1 = torch.sum(dt * Gx, dim=(1, 2))
        b2 = torch.sum(dt * Gy, dim=(1, 2))
        du = -(g22 * b1 - g12 * b2) * inv_det
        dv = -(g11 * b2 - g12 * b1) * inv_det
        step = torch.clamp(torch.stack([du, dv], -1), -4.0, 4.0)
        disp = disp + step * ok[:, None]
    return disp, ok


def lk_flow(prev, cur, pts, valid, *, n_levels=3, win_r=7, iters=5):
    """Track points from ``prev`` to ``cur``.

    Args:
      prev, cur: [H,W] float32 images.
      pts: [N,2] (x,y) point locations in ``prev``.
      valid: [N] bool.
    Returns (flow [N,2], ok [N] bool).
    """
    pyr_p = [prev]
    pyr_c = [cur]
    for _ in range(1, n_levels):
        h, w = pyr_p[-1].shape
        pyr_p.append(im.resize_bilinear(pyr_p[-1], (h // 2, w // 2)))
        pyr_c.append(im.resize_bilinear(pyr_c[-1], (h // 2, w // 2)))

    disp = torch.zeros_like(pts)
    ok_all = valid
    for lvl in range(n_levels - 1, -1, -1):
        scale = 2.0 ** lvl
        # pixel-centre-aligned level coordinates: the resize maps source
        # pixel x to (x + 0.5)/s - 0.5 at the coarser level
        pts_l = (pts + 0.5) / scale - 0.5
        disp_l, ok = _lk_level(pyr_p[lvl], pyr_c[lvl], pts_l, disp / scale,
                               win_r=win_r, iters=iters)
        disp = disp_l * scale
        ok_all = ok_all & ok
    return disp, ok_all


def mean_flow_magnitude(prev, cur, pts, valid):
    """Mean |flow| over the valid tracked points; a 0-d tensor."""
    flow, ok = lk_flow(prev, cur, pts, valid)
    mag = torch.linalg.vector_norm(flow, dim=-1)
    n = torch.clamp_min(torch.sum(ok.to(torch.float32)), 1.0)
    return torch.sum(torch.where(ok, mag, 0.0)) / n
