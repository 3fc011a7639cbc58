"""The reference tracking step: projection matching and motion-only pose
optimisation of one frame against the map, in plain PyTorch.

``track`` follows ``rumi_slam_tpu_torch/tracking/tracker.py::track_frame``
(``match_projected`` then ``pose_optimization``, commit 359566b) with the
fused CUDA matcher replaced by its contract, the dense Hamming matrix under
the radius mask (``fused_matcher.fused_match_plain`` at that commit).
"""

from __future__ import annotations

import math

import torch

from . import camera, matcher, pose_opt


def match_projected(pts, K, feats, pose_pred, radius, *, img_w, img_h, max_hamming, nn_ratio):
    """``pts``: dict of the map's point arrays (``pt_xyz``, ``pt_valid``,
    ``pt_map_id``, ``pt_desc``, ``pt_octave``, ``pt_angle``) and its
    ``active_map``.  Returns idx [F] int32 (a point id or -1)."""
    uv_proj, depth = camera.project_world(K, pose_pred, pts["pt_xyz"])
    vis = (
        pts["pt_valid"]
        & (pts["pt_map_id"] == pts["active_map"])
        & (depth > 0.05)
        & (uv_proj[:, 0] >= 0)
        & (uv_proj[:, 0] < img_w)
        & (uv_proj[:, 1] >= 0)
        & (uv_proj[:, 1] < img_h)
    )
    idx, _ = matcher.match(
        matcher.hamming_matrix(feats["desc"], pts["pt_desc"]), feats["valid"], vis,
        mask=matcher.radius_mask(feats["uv"], uv_proj, radius),
        max_dist=max_hamming, ratio=nn_ratio,
    )
    matched = idx >= 0
    n_matched = torch.sum(matched.to(torch.int32))
    ic = idx.clamp_min(0).long()
    pt_oct = pts["pt_octave"][ic]
    r_pt = torch.clamp_max(0.5 * radius * torch.pow(1.2, pt_oct.to(torch.float32)), radius)
    d = feats["uv"] - uv_proj[ic]
    duv = torch.sqrt(torch.sum(d * d, dim=-1))
    matched = matched & ((duv <= r_pt) | (n_matched < 100))

    dang = feats["angle"] - pts["pt_angle"][ic]
    bins = torch.remainder(torch.round(dang * (30.0 / (2.0 * math.pi))).to(torch.int32), 30)
    hist = torch.zeros((30,), dtype=torch.int32, device=idx.device).index_add_(
        0, bins.long(), matched.to(torch.int32))
    top3_counts = torch.topk(hist, 3).values
    dominant = hist >= torch.clamp_min(top3_counts[-1], 1)
    concentrated = torch.sum(top3_counts) * 2 >= torch.sum(hist)
    matched = matched & (dominant[bins.long()] | ~concentrated)
    return torch.where(matched, idx, -1)


def track(pts, K, feats, pose_pred, radius, *, img_w, img_h, max_hamming, nn_ratio):
    """(pose [7], assoc [F] int32) of one frame, as ``track_frame`` gives them."""
    idx = match_projected(pts, K, feats, pose_pred, radius, img_w=img_w, img_h=img_h,
                          max_hamming=max_hamming, nn_ratio=nn_ratio)
    matched = idx >= 0
    X = pts["pt_xyz"][idx.clamp_min(0).long()]
    res = pose_opt.pose_optimization(K, pose_pred, X, feats["uv"], matched,
                                     n_rounds=3, n_iters=6)
    return res.pose, torch.where(matched & res.inliers, idx, -1)
