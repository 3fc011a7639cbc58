"""Per-frame tracking step (port of ``TrackResult`` and ``track_frame`` of
``rumi_slam_tpu/tracking/tracker.py``): project the map's points through a
pose prediction, match frame features against them inside a radius window,
filter the matches, then run motion-only BA.

The match runs through ``ops.fused_matcher.fused_match``: the CUDA kernel
for tensors on the card, its plain PyTorch version for tensors on the CPU.
There is no switch and no shape constraint.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..geometry import camera
from ..mapstate.map_state import MapState
from ..ops import matcher
from ..ops.fused_matcher import fused_match
from ..optim import pose_opt


class TrackResult(NamedTuple):
    pose: torch.Tensor          # [7] refined T_cw
    assoc: torch.Tensor         # [F] int32 feature -> point id (-1 none)
    n_inliers: torch.Tensor     # scalar int32
    n_candidates: torch.Tensor  # scalar int32 — visible map points


def match_projected(ms: MapState, K, feats, pose_pred, radius, *, img_w: int,
                    img_h: int, max_hamming=matcher.TH_HIGH, nn_ratio=0.9):
    """The matching half of ``track_frame``: projection, visibility, the
    radius-gated Hamming match, then the octave-radius and rotation
    post-filters.  Returns (idx [F] int32 point id or -1, vis [P] bool)."""
    uv_proj, depth = camera.project_world(K, pose_pred, ms.pt_xyz)
    vis = (
        ms.pt_valid
        & (ms.pt_map_id == ms.active_map)
        & (depth > 0.05)
        & (uv_proj[:, 0] >= 0)
        & (uv_proj[:, 0] < img_w)
        & (uv_proj[:, 1] >= 0)
        & (uv_proj[:, 1] < img_h)
    )
    idx, _ = fused_match(
        feats.desc, ms.pt_desc, feats.uv, uv_proj, radius, feats.valid, vis,
        max_dist=max_hamming, ratio=nn_ratio,
    )

    # per-octave search radius and rotation consistency, as adaptive
    # post-filters on the matched set (each engages only when the matches
    # carry enough redundancy for pruning to be safe)
    matched = idx >= 0
    n_matched = torch.sum(matched.to(torch.int32))
    ic = idx.clamp_min(0).long()
    pt_oct = ms.pt_octave[ic]
    r_pt = torch.clamp_max(0.5 * radius * torch.pow(1.2, pt_oct.to(torch.float32)), radius)
    d = feats.uv - uv_proj[ic]
    duv = torch.sqrt(torch.sum(d * d, dim=-1))
    matched = matched & ((duv <= r_pt) | (n_matched < 100))

    dang = feats.angle - ms.pt_angle[ic]
    bins = torch.remainder(torch.round(dang * (30.0 / (2.0 * math.pi))).to(torch.int32), 30)
    hist = torch.zeros((30,), dtype=torch.int32, device=idx.device).index_add_(
        0, bins.long(), matched.to(torch.int32))
    top3_counts = torch.topk(hist, 3).values
    dominant = hist >= torch.clamp_min(top3_counts[-1], 1)
    # engage only when the 3 dominant bins hold a majority of the matches
    concentrated = torch.sum(top3_counts) * 2 >= torch.sum(hist)
    matched = matched & (dominant[bins.long()] | ~concentrated)
    return torch.where(matched, idx, -1), vis


def track_frame(ms: MapState, K, feats, pose_pred, radius, *, img_w: int,
                img_h: int, max_hamming=matcher.TH_HIGH, nn_ratio=0.9):
    """Match frame features against the active submap's points around a pose
    prediction, then run motion-only BA (3 rounds x 6 LM iterations).

    ``radius``: projection search window in pixels (Python number).
    Returns (ms with ``pt_visible``/``pt_found`` updated, TrackResult).
    """
    idx, vis = match_projected(ms, K, feats, pose_pred, radius, img_w=img_w,
                               img_h=img_h, max_hamming=max_hamming,
                               nn_ratio=nn_ratio)
    matched = idx >= 0
    X = ms.pt_xyz[idx.clamp_min(0).long()]
    res = pose_opt.pose_optimization(K, pose_pred, X, feats.uv, matched,
                                     n_rounds=3, n_iters=6)
    assoc = torch.where(matched & res.inliers, idx, -1)

    # visibility bookkeeping for culling (MapPoint IncreaseVisible/Found)
    found = torch.zeros((ms.max_pt,), dtype=torch.float32, device=idx.device).index_add_(
        0, assoc.clamp_min(0).long(), (assoc >= 0).to(torch.float32))
    ms = ms._replace(
        pt_visible=ms.pt_visible + vis.to(torch.float32),
        pt_found=ms.pt_found + found,
    )
    return ms, TrackResult(
        pose=res.pose,
        assoc=assoc,
        n_inliers=torch.sum((assoc >= 0).to(torch.int32)),
        n_candidates=torch.sum(vis.to(torch.int32)),
    )
