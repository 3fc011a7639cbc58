# Frozen copy of rumi_slam_tpu_torch/ops/fast.py at commit 359566b (plain PyTorch,
# no kernel): the benchmark's reference.  Imports made relative; no other change.
"""FAST-16/9 corner detector as a dense, branch-free tensor program (port of
``rumi_slam_tpu/ops/fast.py``): 16 shifted-image compares plus a cumulative
sum window over the circle, giving a dense score map for ``ops/select.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from .image import max_pool3x3

# Bresenham circle of radius 3 — 16 (dy, dx) offsets in contiguous ring order.
CIRCLE = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3),
        (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3),
        (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)

ARC_LEN = 9  # FAST-9: need >= 9 contiguous bright or dark circle pixels


def _circle_diffs(img):
    """[16, H, W] circle pixel minus centre.  ``torch.roll`` wraps around like
    ``jnp.roll``; the border mask removes every wrapped pixel."""
    shifted = torch.stack(
        [torch.roll(img, (-int(dy), -int(dx)), (0, 1)) for dy, dx in CIRCLE], dim=0
    )
    return shifted - img[None]


def _inside(h, w, border, device):
    yy = torch.arange(h, device=device)[:, None]
    xx = torch.arange(w, device=device)[None, :]
    return (yy >= border) & (yy < h - border) & (xx >= border) & (xx < w - border)


def _has_arc(flags):
    ext = torch.cat([flags, flags[: ARC_LEN - 1]], dim=0)      # [24, H, W]
    cs = torch.cumsum(ext, dim=0)
    cs = torch.cat([torch.zeros_like(cs[:1]), cs], dim=0)      # [25, H, W]
    win = cs[ARC_LEN:] - cs[:-ARC_LEN]                          # [16, H, W]
    return torch.amax(win, dim=0) >= ARC_LEN


def _score_at(d, threshold, inside):
    bright = (d > threshold).to(torch.int32)
    dark = (d < -threshold).to(torch.int32)
    is_corner = _has_arc(bright) | _has_arc(dark)
    sad_bright = torch.sum(torch.clamp_min(d - threshold, 0.0), dim=0)
    sad_dark = torch.sum(torch.clamp_min(-d - threshold, 0.0), dim=0)
    score = torch.maximum(sad_bright, sad_dark)
    return torch.where(is_corner & inside, score, torch.zeros_like(score))


def fast_score_pair(img, th_strong: float, th_weak: float, border: int = 16):
    """Strong- and weak-threshold score maps from ONE shared circle-difference
    pass (the iniThFAST/minThFAST retry without recomputing the shifts)."""
    d = _circle_diffs(img)
    h, w = img.shape
    inside = _inside(h, w, border, img.device)
    return _score_at(d, th_strong, inside), _score_at(d, th_weak, inside)


def fast_score(img, threshold: float, border: int = 16):
    """Dense FAST-16/9 score map [H, W]: 0 where not a corner, else the
    sum of circle differences beyond ``threshold`` on the stronger polarity;
    pixels within ``border`` of the edge are 0."""
    h, w = img.shape
    return _score_at(_circle_diffs(img), threshold, _inside(h, w, border, img.device))


def nms3x3(score):
    """Keep only 3x3-local maxima (ties all survive, as in the JAX package)."""
    dil = max_pool3x3(score)
    return torch.where((score >= dil) & (score > 0.0), score, torch.zeros_like(score))
