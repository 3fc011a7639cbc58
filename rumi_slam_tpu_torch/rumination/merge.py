"""Submap merging: timestamp association, dual Sim(3) hypotheses, welding BA
(port of ``rumi_slam_tpu/rumination/merge.py``).

KFs of the two submaps are paired at (near-)identical timestamps; keypoints
of a pair within a pixel radius that both carry map points give 3D-3D pairs;
a global Sim(3) comes from Umeyama on the matched KF centres against Horn
RANSAC on the 3D-3D pairs (winner by reprojection inliers), refined by a
single-Sim(3) reprojection LM; then the source submap is transformed,
duplicate points fused, the submap relabelled and the seam bundle-adjusted.

Because the map is one MapState with ``map_id`` labels, the migration is a
masked Sim(3) apply, a relabel and a fuse look-up table.

Pose correction under a world Sim(3): for a source pose T_cw and the world
map S (src -> dst), Q = T_cw o S^-1 has scale s; the corrected SE(3) pose is
(R_q, t_q / s_q).

``compute_submap_sim3`` takes a RANSAC draw callable (``optim.ransac``) where
the JAX package takes a PRNG key; ``compute_submap_sim3_from`` takes the
index sets.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import MergeConfig
from ..geometry import alignment, camera, lie
from ..mapstate import map_state as M
from ..ops.select import top_k
from ..optim import ba, robust
from ..optim.pose_graph import tangent_jacobians


class KFMatches(NamedTuple):
    dst_kf: torch.Tensor  # [Mk] int32, -1 pad
    src_kf: torch.Tensor  # [Mk]
    valid: torch.Tensor   # [Mk] bool


class PointPairs(NamedTuple):
    """3D-3D correspondences induced by pixel-radius keypoint association
    inside matched KF pairs."""

    dst_kf: torch.Tensor   # [N] observing dst keyframe
    dst_uv: torch.Tensor   # [N,2] observed pixel in the dst KF
    dst_pt: torch.Tensor   # [N] dst point row
    src_pt: torch.Tensor   # [N] src point row
    valid: torch.Tensor    # [N]


def match_kfs_by_time(kf_time, kf_valid, kf_map_id, dst_id, src_id, *, max_pairs: int,
                      tol=1e-4):
    """Pair dst-map KFs with src-map KFs at (near-)identical timestamps."""
    inf = float("inf")
    dst_sel = kf_valid & (kf_map_id == dst_id)
    src_sel = kf_valid & (kf_map_id == src_id)
    dt = torch.abs(kf_time[:, None] - kf_time[None, :])  # [K,K]
    dt = torch.where(dst_sel[:, None] & src_sel[None, :], dt, inf)
    best_dt, best_src = torch.min(dt, dim=1)
    good = best_dt <= tol
    # top max_pairs by recency (largest timestamps near the seam first)
    _, top = top_k(torch.where(good, kf_time, -inf), max_pairs)
    valid = good[top]
    return KFMatches(
        dst_kf=torch.where(valid, top, -1).to(torch.int32),
        src_kf=torch.where(valid, best_src[top], -1).to(torch.int32),
        valid=valid,
    )


def associate_points(ms: M.MapState, matches: KFMatches, *, radius=3.0):
    """Per matched KF pair, associate keypoints within ``radius`` px whose
    features both carry map points -> 3D-3D pairs."""
    F = ms.max_feat
    kd = matches.dst_kf.clamp_min(0).long()
    ks = matches.src_kf.clamp_min(0).long()
    uv_d, uv_s = ms.kf_uv[kd], ms.kf_uv[ks]                     # [Mk,F,2]
    pt_d, pt_s = ms.kf_point[kd], ms.kf_point[ks]
    has_d = (pt_d >= 0) & ms.kf_feat_valid[kd]
    has_s = (pt_s >= 0) & ms.kf_feat_valid[ks]
    d2 = torch.sum((uv_d[:, :, None, :] - uv_s[:, None, :, :]) ** 2, dim=-1)
    d2 = torch.where(has_d[:, :, None] & has_s[:, None, :], d2, float("inf"))
    bd, best = torch.min(d2, dim=2)
    good = (bd <= radius * radius) & matches.valid[:, None]
    return PointPairs(
        dst_kf=kd.to(torch.int32)[:, None].expand(-1, F).reshape(-1),
        dst_uv=uv_d.reshape(-1, 2),
        dst_pt=torch.where(good, pt_d, -1).reshape(-1),
        src_pt=torch.where(good, torch.gather(pt_s, 1, best), -1).reshape(-1),
        valid=good.reshape(-1),
    )


def _pair_valid(pairs: PointPairs):
    return pairs.valid & (pairs.dst_pt >= 0) & (pairs.src_pt >= 0)


def compute_submap_sim3(draw, K, ms: M.MapState, matches: KFMatches, pairs: PointPairs, *,
                        n_hyp: int = 64, n_iters: int = 8, thresh_px: float = 6.0):
    """Solve S (src world -> dst world) from KF matches and point pairs,
    drawing the ``n_hyp`` Horn triples with ``draw(logits, (n_hyp, 3))``.
    See ``compute_submap_sim3_from``."""
    logits = torch.log(torch.clamp_min(_pair_valid(pairs).to(torch.float32), 1e-12))
    idx = draw(logits, (n_hyp, 3)).to(ms.kf_pose.device)
    return compute_submap_sim3_from(idx, K, ms, matches, pairs, n_iters=n_iters,
                                    thresh_px=thresh_px)


def compute_submap_sim3_from(idx, K, ms: M.MapState, matches: KFMatches, pairs: PointPairs,
                             *, n_iters: int = 8, thresh_px: float = 6.0):
    """Two closed-form hypotheses: (a) Umeyama on the matched KF camera
    centres; (b) Horn on the RANSAC triples ``idx [H, 3]`` of 3D-3D point
    pairs; the winner by reprojection-inlier count, then a global-Sim(3)
    reprojection LM with Huber weights.
    Returns (S [8], inlier ratio, inlier mask [N])."""
    idx = idx.long()
    dt, dev = ms.pt_xyz.dtype, ms.pt_xyz.device
    valid = _pair_valid(pairs)
    X_dst = ms.pt_xyz[pairs.dst_pt.clamp_min(0).long()]
    X_src = ms.pt_xyz[pairs.src_pt.clamp_min(0).long()]
    T_dst = ms.kf_pose[pairs.dst_kf.clamp_min(0).long()]

    def reproject(S):
        X_hat = lie.sim3_apply(S[..., None, :], X_src)
        return camera.project_world(K, T_dst, X_hat)

    def inlier_mask(S):
        uv_hat, depth = reproject(S)
        err = torch.linalg.vector_norm(uv_hat - pairs.dst_uv, dim=-1)
        return valid & (err < thresh_px) & (depth > 0.05)

    n_valid = torch.clamp_min(torch.sum(valid.to(torch.int32)), 1)

    # (a) Umeyama on the camera centres of the matched KF pairs
    c_dst = lie.se3_t(lie.se3_inverse(ms.kf_pose[matches.dst_kf.clamp_min(0).long()]))
    c_src = lie.se3_t(lie.se3_inverse(ms.kf_pose[matches.src_kf.clamp_min(0).long()]))
    S_um = alignment.umeyama_alignment(c_src, c_dst, matches.valid.to(dt))

    # (b) Horn RANSAC on the 3D-3D point pairs
    S_h = alignment.horn_alignment(X_src[idx], X_dst[idx])
    scores_h = torch.sum(inlier_mask(S_h), dim=-1)
    best_h = torch.argmax(scores_h)
    n_um = torch.sum(inlier_mask(S_um))
    S = torch.where(n_um >= scores_h[best_h], S_um, S_h[best_h])

    # global-Sim(3) LM refinement
    w_rob0 = inlier_mask(S).to(dt)
    n = X_src.shape[0]
    eye7 = torch.eye(7, dtype=dt, device=dev)
    zero7 = torch.zeros(7, dtype=dt, device=dev)

    def residuals(tau, S_base):
        return reproject(lie.sim3_retract(S_base, tau))[0] - pairs.dst_uv

    lam = torch.full((), 1e-3, dtype=dt, device=dev)
    for _ in range(n_iters):
        S_it = S
        r, (J,) = tangent_jacobians(
            lambda tau: residuals(tau, S_it).reshape(7, 2 * n), (7,), (), dtype=dt, device=dev)
        r, J = r.reshape(n, 2), J.reshape(n, 2, 7)
        chi2 = torch.sum(r * r, dim=-1)
        w = w_rob0 * robust.huber_weight(chi2, 25.0)
        H = torch.einsum("nki,n,nkj->ij", J, w, J) + lam * eye7
        g = torch.einsum("nki,n,nk->i", J, w, r)
        tau = -torch.linalg.solve_ex(H + 1e-8 * eye7, g)[0]
        S_new = lie.sim3_retract(S, tau)
        c0 = torch.sum(w * chi2)
        r1 = residuals(zero7, S_new)
        c1 = torch.sum(w * torch.sum(r1 * r1, dim=-1))
        accept = c1 < c0
        S = torch.where(accept, S_new, S)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 5.0), 1e-8, 1e6)

    inl = inlier_mask(S)
    return S, torch.sum(inl) / n_valid.to(dt), inl


def correct_poses(T_cw, S):
    """Camera poses [..., 7] re-expressed after their world was transformed by
    the Sim(3) S [8]."""
    Q = lie.sim3_compose(lie.sim3_from_se3(T_cw), lie.sim3_inverse(S))
    return lie.se3(Q[..., :4], Q[..., 4:7] / lie.sim3_scale(Q)[..., None])


def transform_submap(ms: M.MapState, map_id, S):
    """Apply the world Sim(3) S to every KF pose and point of one submap."""
    sel_kf = ms.kf_valid & (ms.kf_map_id == map_id)
    sel_pt = ms.pt_valid & (ms.pt_map_id == map_id)
    new_xyz = torch.where(sel_pt[:, None], lie.sim3_apply(S, ms.pt_xyz), ms.pt_xyz)
    new_pose = torch.where(sel_kf[:, None], correct_poses(ms.kf_pose, S), ms.kf_pose)
    return ms._replace(kf_pose=new_pose, pt_xyz=new_xyz)


def fuse_points(ms: M.MapState, pairs: PointPairs, inliers):
    """Duplicate-point fusion: src points of inlier pairs are replaced by
    their dst partners everywhere.  Where a src point sits in several pairs,
    the highest dst row wins (a max reduction, so order-free)."""
    P = ms.max_pt
    ok = pairs.valid & inliers & (pairs.src_pt >= 0) & (pairs.dst_pt >= 0)
    fuse_to = torch.full((P,), -1, dtype=torch.int32, device=ms.pt_xyz.device).scatter_reduce(
        0, pairs.src_pt.clamp_min(0).long(), torch.where(ok, pairs.dst_pt, -1), "amax")
    kp = ms.kf_point
    tgt = fuse_to[kp.clamp_min(0).long()]
    kp = torch.where((kp >= 0) & (tgt >= 0), tgt, kp)
    return ms._replace(kf_point=kp, pt_valid=ms.pt_valid & (fuse_to < 0))


def _welding_window(matches: KFMatches, w: int, ms: M.MapState = None, covis: int = 0):
    """Fixed-size welding window: alternate dst/src matched KFs, then (with
    ``covis`` > 0 and ``ms`` given) the strongest covisible neighbours of the
    matched set, so the BA seam includes the keyframes whose points the merge
    just rewired.  Returns (ids [w + covis], valid)."""
    ids = torch.stack([matches.dst_kf, matches.src_kf], dim=1).reshape(-1)
    valid = torch.stack([matches.valid, matches.valid], dim=1).reshape(-1)
    dev = ids.device
    key = torch.where(valid, torch.arange(ids.shape[0], device=dev), 1 << 30)
    _, order = top_k(-key, w)
    ids, valid = ids[order], valid[order]
    if covis > 0 and ms is not None:
        Wgt = M.covisibility(ms)
        in_window = M.put_rows(torch.zeros((ms.max_kf,), dtype=torch.bool, device=dev),
                               ids.clamp_min(0), torch.ones_like(valid), valid)
        # covisibility weight accumulated toward the matched window
        wsum = torch.sum(Wgt * in_window[:, None], dim=0) * ms.kf_valid * ~in_window
        vals, nb = top_k(wsum, covis)
        ids = torch.cat([ids, nb.to(ids.dtype)])
        valid = torch.cat([valid, vals >= M.MIN_COVIS_WEIGHT])
    return ids, valid


def welding_ba(ms: M.MapState, K, matches: KFMatches, *, window: int = 16, n_iters: int = 5,
               covis: int = 0):
    """Welding bundle adjustment over the seam: adjust the matched dst+src
    KFs plus ``covis`` covisible expanders, hold the two oldest as anchors,
    free all their points."""
    ids, valid_w = _welding_window(matches, window, ms, covis)
    ids = ids.clamp_min(0).long()
    F = ms.max_feat
    W = window + covis
    dev = ids.device

    cam_idx = torch.arange(W, device=dev).repeat_interleave(F)
    pt = ms.kf_point[ids].reshape(-1)
    uv = ms.kf_uv[ids].reshape(-1, 2)
    conf = ((pt >= 0) & ms.kf_feat_valid[ids].reshape(-1)
            & valid_w.repeat_interleave(F)).to(torch.float32)
    # cloud observations weigh less (as in global_bundle_adjustment)
    conf = conf * torch.where(ms.kf_is_cloud[ids], 0.3, 1.0).repeat_interleave(F)

    big = 1 << 30
    order = torch.where(valid_w, ids, big)
    a1 = torch.min(order)
    a2 = torch.min(torch.where(order == a1, big, order))
    cam_free = valid_w & (ids != a1) & (ids != a2)

    res = ba.bundle_adjust(K, ms.kf_pose[ids], ms.pt_xyz, cam_idx, pt.clamp_min(0), uv, conf,
                           cam_free, ms.pt_valid, n_iters=n_iters)
    # only the rows that changed write; an id can sit in the window twice
    # (padding rows clamp onto slot 0), and those rows keep the old pose
    new_pose = M.put_rows(ms.kf_pose, ids, res.poses, valid_w & cam_free)
    return ms._replace(kf_pose=new_pose, pt_xyz=res.points)


def merge_submaps(ms: M.MapState, K, src_id, dst_id, cfg: MergeConfig, draw):
    """Full merge of submap ``src_id`` into ``dst_id``.

    Returns (ms, ok, info).  On failure the map comes back untouched.
    """
    matches = match_kfs_by_time(ms.kf_time, ms.kf_valid, ms.kf_map_id, dst_id, src_id,
                                max_pairs=cfg.max_match_kf, tol=cfg.time_tolerance_s)
    n_matched = int(torch.sum(matches.valid))
    # 2 matched KFs suffice: the Sim(3) hypotheses come from Horn triples over
    # the per-feature 3D-3D pairs, not from the KF centres alone
    if n_matched < 2:
        return ms, False, {"n_kf_matches": n_matched, "reason": "no_kf_matches"}

    pairs = associate_points(ms, matches, radius=cfg.pixel_radius)
    n_pairs = int(torch.sum(pairs.valid))
    if n_pairs < 10:
        return ms, False, {"n_kf_matches": n_matched, "n_pt_pairs": n_pairs,
                           "reason": "no_point_pairs"}

    S, ratio, inliers = compute_submap_sim3(draw, K, ms, matches, pairs,
                                            n_iters=cfg.sim3_iters)
    ratio = float(ratio)
    if ratio <= cfg.min_inlier_ratio:
        return ms, False, {"n_kf_matches": n_matched, "n_pt_pairs": n_pairs,
                           "inlier_ratio": ratio, "reason": "low_inliers"}

    ms = transform_submap(ms, src_id, S)
    ms = fuse_points(ms, pairs, inliers)
    ms = M.relabel_map(ms, src_id, dst_id)
    ms = welding_ba(ms, K, matches, covis=cfg.welding_covis)
    return ms, True, {
        "n_kf_matches": n_matched,
        "n_pt_pairs": n_pairs,
        "inlier_ratio": ratio,
        "scale": float(lie.sim3_scale(S)),
    }
