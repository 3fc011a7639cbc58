"""Spatially-bucketed keypoint selection (port of
``rumi_slam_tpu/ops/select.py``): per-cell top-k over a fixed grid, then a
global top-N.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _top_k(x, k: int):
    """``lax.top_k`` along the last axis, including its tie order: equal
    values come out lowest index first.  ``torch.topk`` promises no order
    among ties, and the score maps hold many (all the zeros), so this sorts
    the negated values with a stable sort instead."""
    neg, idx = torch.sort(-x, dim=-1, stable=True)
    return -neg[..., :k], idx[..., :k]


def select_keypoints(score, n_total: int, cell: int = 32, k_cell: int = 5):
    """Pick up to ``n_total`` keypoints from a dense score map.

    Returns:
      yx:    [n_total, 2] int32 (y, x); rows past the real count are (0, 0).
      s:     [n_total] float32 scores (0 for invalid rows).
      valid: [n_total] bool.
    """
    h, w = score.shape
    ph = (h + cell - 1) // cell * cell
    pw = (w + cell - 1) // cell * cell
    sp = F.pad(score, (0, pw - w, 0, ph - h), value=0.0)

    ncy, ncx = ph // cell, pw // cell
    cells = sp.reshape(ncy, cell, ncx, cell).permute(0, 2, 1, 3).reshape(
        ncy * ncx, cell * cell
    )
    cs, ci = _top_k(cells, k_cell)                       # [ncells, k_cell]

    cell_ids = torch.arange(ncy * ncx, device=score.device)[:, None]
    gy = (cell_ids // ncx) * cell + ci // cell
    gx = (cell_ids % ncx) * cell + ci % cell

    flat_s = cs.reshape(-1)
    flat_y = gy.reshape(-1)
    flat_x = gx.reshape(-1)

    k = min(n_total, flat_s.shape[0])
    top_s, top_i = _top_k(flat_s, k)
    yx = torch.stack([flat_y[top_i], flat_x[top_i]], dim=-1)
    valid = top_s > 0.0
    if k < n_total:
        pad = n_total - k
        yx = torch.cat([yx, yx.new_zeros((pad, 2))])
        top_s = torch.cat([top_s, top_s.new_zeros((pad,))])
        valid = torch.cat([valid, valid.new_zeros((pad,))])
    yx = torch.where(valid[:, None], yx, torch.zeros_like(yx))
    top_s = torch.where(valid, top_s, torch.zeros_like(top_s))
    return yx.to(torch.int32), top_s, valid
