"""Tracking against the map (port of ``rumi_slam_tpu/tracking/tracker.py``).

``track_frame`` is the per-frame step: project the map's points through a
pose prediction, match frame features against them inside a radius window,
filter the matches, then run motion-only BA.  Its match runs through
``ops.fused_matcher.fused_match``: the CUDA kernel for tensors on the card,
its plain PyTorch version for tensors on the CPU.  There is no switch and no
shape constraint.

The fallbacks and relocalisation follow: reference-KF tracking without a
motion prior, prior-free PnP against one keyframe or the whole submap, and
retrieval of candidate keyframes.  The PnP ones take a RANSAC draw callable
(``optim.ransac``) where the JAX package takes a PRNG key.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..geometry import camera
from ..mapstate import map_state as M
from ..mapstate.map_state import MapState
from ..ops import matcher, select
from ..ops.fused_matcher import fused_match, match_bank
from ..optim import pnp, pose_opt
from ..utils.profiling import stage


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
                img_h: int, max_hamming=matcher.TH_HIGH, nn_ratio=0.9, timer=None):
    """Match frame features against the active submap's points around a pose
    prediction, then run motion-only BA (3 rounds x 6 LM iterations).

    ``radius``: projection search window in pixels (Python number).
    ``timer``: an optional ``StageTimer``; the match is its ``track_match``
    stage, the pose optimisation its ``pose_opt`` stage (with a
    ``pose_opt_graph`` stage inside it on the card).
    Returns (ms with ``pt_visible``/``pt_found`` updated, TrackResult).
    """
    with stage(timer, "track_match"):
        idx, vis = match_projected(ms, K, feats, pose_pred, radius, img_w=img_w,
                                   img_h=img_h, max_hamming=max_hamming,
                                   nn_ratio=nn_ratio)
    matched = idx >= 0
    X = ms.pt_xyz[idx.clamp_min(0).long()]
    with stage(timer, "pose_opt"):
        res = pose_opt.pose_optimization(K, pose_pred, X, feats.uv, matched,
                                         n_rounds=3, n_iters=6, timer=timer)
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


def track_reference_kf(ms: MapState, K, feats, kf_id, pose_init, *,
                       max_hamming=matcher.TH_LOW, nn_ratio=0.8, timer=None):
    """Match frame descriptors against ONE keyframe's features (no spatial
    window), take its feature->point associations, pose-optimize.
    ``timer``: an optional ``StageTimer``; the pose optimisation is its
    ``pose_opt`` stage."""
    kf_assoc = ms.kf_point[kf_id]
    has_pt = kf_assoc >= 0
    dist = matcher.hamming_matrix(feats.desc, ms.kf_desc[kf_id])
    idx, _ = matcher.match(dist, feats.valid, ms.kf_feat_valid[kf_id] & has_pt,
                           max_dist=max_hamming, ratio=nn_ratio)
    pt = torch.where(idx >= 0, kf_assoc[idx.clamp_min(0).long()], -1)
    matched = pt >= 0
    X = ms.pt_xyz[pt.clamp_min(0).long()]
    with stage(timer, "pose_opt"):
        res = pose_opt.pose_optimization(K, pose_init, X, feats.uv, matched, timer=timer)
    assoc = torch.where(matched & res.inliers, pt, -1)
    return TrackResult(
        pose=res.pose,
        assoc=assoc,
        n_inliers=torch.sum((assoc >= 0).to(torch.int32)),
        n_candidates=torch.sum(has_pt.to(torch.int32)),
    )


def relocalize_pnp(draw, ms: MapState, K, feats, kf_id):
    """Relocalisation against one candidate KF without a pose prior:
    descriptor match to the KF's point-bearing features, then DLT-RANSAC PnP
    and motion-only BA."""
    kf_assoc = ms.kf_point[kf_id]
    has_pt = kf_assoc >= 0
    dist = matcher.hamming_matrix(feats.desc, ms.kf_desc[kf_id])
    # looser gate than in-track matching: the PnP RANSAC is the outlier filter
    idx, mdist = matcher.match(dist, feats.valid, ms.kf_feat_valid[kf_id] & has_pt,
                               max_dist=80.0, ratio=0.9)
    pt = torch.where(idx >= 0, kf_assoc[idx.clamp_min(0).long()], -1)
    matched = pt >= 0
    X = ms.pt_xyz[pt.clamp_min(0).long()]
    res = pnp.pnp_ransac(draw, K, X, feats.uv, matched, quality=80.0 - mdist)
    assoc = torch.where(matched & res.inliers, pt, -1)
    return TrackResult(
        pose=res.pose,
        assoc=assoc,
        n_inliers=res.n_inliers,
        n_candidates=torch.sum(matched.to(torch.int32)),
    )


def relocalize_map(draw, ms: MapState, K, feats, *, max_hamming=80.0, nn_ratio=0.9,
                   map_id=None):
    """Prior-free relocalisation against the whole active submap: match the
    frame against every stored observation descriptor (``kf_desc``
    flattened; ``match_bank``: the kernel's gate-off mode on the card, on the
    CPU ``min(16, max_kf)`` chunks with a running top-2), PnP RANSAC on the
    point-bearing matches, polish on the consensus set.

    Returns (TrackResult, ref_kf 0-d: the KF sharing most recovered points).
    """
    mid = ms.active_map if map_id is None else map_id
    obs_desc = ms.kf_desc.reshape(-1, 8)
    obs_pt = torch.where(ms.kf_valid[:, None], ms.kf_point, -1).reshape(-1)
    opc = obs_pt.clamp_min(0).long()
    obs_ok = (obs_pt >= 0) & ms.pt_valid[opc] & (ms.pt_map_id[opc] == mid)
    idx, mdist = match_bank(
        feats.desc, feats.valid, obs_desc, obs_ok,
        n_chunks=min(16, ms.max_kf), max_dist=max_hamming, ratio=nn_ratio)
    idx = torch.where(idx >= 0, obs_pt[idx.clamp_min(0).long()], -1)
    matched = idx >= 0
    X = ms.pt_xyz[idx.clamp_min(0).long()]
    res = pnp.pnp_ransac(draw, K, X, feats.uv, matched, quality=max_hamming - mdist)
    res2 = pose_opt.pose_optimization(K, res.pose, X, feats.uv, matched & res.inliers)
    assoc = torch.where(matched & res.inliers & res2.inliers, idx, -1)
    hit = M.put_rows(torch.zeros_like(ms.pt_valid), assoc.clamp_min(0),
                     torch.ones_like(assoc, dtype=torch.bool), assoc >= 0)
    shared = torch.sum(hit[ms.kf_point.clamp_min(0).long()] & (ms.kf_point >= 0), dim=1) \
        * ms.kf_valid
    ref_kf = torch.argmax(shared)
    return TrackResult(
        pose=res2.pose,
        assoc=assoc,
        n_inliers=torch.sum((assoc >= 0).to(torch.int32)),
        n_candidates=torch.sum(matched.to(torch.int32)),
    ), ref_kf


def covis_group_rank(ms: MapState, score, eligible, top_k: int):
    """Sum each candidate's score over its covisibility group, rank the
    groups, and represent each winning group by its best member.

    Returns (kf_ids [top_k] int32, accumulated scores [top_k] float32).
    """
    score = torch.where(eligible, score, 0).to(torch.float32)
    Wgt = M.covisibility(ms)
    nb = (Wgt >= M.MIN_COVIS_WEIGHT) & eligible[None, :] & eligible[:, None]
    acc = score + nb.to(torch.float32) @ score
    acc = torch.where(eligible, acc, 0.0)
    vals, gids = select.top_k(acc, top_k)
    self_or_nb = nb[gids].index_put((torch.arange(top_k, device=gids.device), gids),
                                    torch.tensor(True, device=gids.device))
    member_score = torch.where(self_or_nb, score[None, :], -1.0)
    return torch.argmax(member_score, dim=1).to(torch.int32), vals


def relocalization_candidates(ms: MapState, feats, *, top_k=3):
    """Score every KF by how many of its points have a strong Hamming match
    (< 50) in the frame, accumulate over covisibility groups, rank.

    Returns (kf_ids [top_k], group-accumulated scores [top_k]).
    """
    dist = matcher.hamming_matrix(feats.desc, ms.pt_desc)
    strong = (dist < 50.0) & feats.valid[:, None] & ms.pt_valid[None, :]
    per_point = torch.any(strong, dim=0)
    score = torch.sum(M.incidence(ms) & per_point[None, :], dim=1)
    return covis_group_rank(ms, score, ms.kf_valid, top_k)
