"""Loop closing: place recognition, Sim(3) verification, pose-graph
correction (port of ``rumi_slam_tpu/tracking/loop_closing.py``).

* detection: Hamming retrieval of the query keyframe's features against the
  map's points, scored per keyframe through the incidence, masked to exclude
  covisible neighbours and temporally recent slots, accumulated over
  covisibility groups;
* verification: descriptor-matched 3D-3D Horn RANSAC plus a reprojection
  inlier gate, then two weighted Horn refits on the consensus set;
* correction: the Sim(3) essential-graph optimiser (``optim.pose_graph``),
  then the points move with their reference keyframes.

``verify_loop`` takes a RANSAC draw callable (``optim.ransac``) where the JAX
package takes a PRNG key; ``verify_loop_from`` takes the index sets.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import alignment, camera, lie
from ..mapstate import map_state as M
from ..ops import matcher
from ..optim import pose_graph
from . import tracker


class LoopCandidate(NamedTuple):
    kf_id: torch.Tensor
    score: torch.Tensor


def detect_loop_candidates(ms: M.MapState, kf_id, *, top_k: int = 3,
                           min_time_gap_slots: int = 20):
    """Retrieval-based loop candidates for one keyframe, excluding its
    covisibility neighbourhood and temporally near slots."""
    dev = ms.kf_pose.device
    kf = torch.as_tensor(kf_id, device=dev).long()
    feats_desc = ms.kf_desc[kf]
    feats_valid = ms.kf_feat_valid[kf]

    dist = matcher.hamming_matrix(feats_desc, ms.pt_desc)  # [F,P]
    strong = (dist < 50.0) & feats_valid[:, None] & ms.pt_valid[None, :]
    per_point = torch.any(strong, dim=0)
    score = torch.sum(M.incidence(ms) & per_point[None, :], dim=1)

    covis = M.covisibility(ms)[kf] >= M.MIN_COVIS_WEIGHT
    slot_gap = torch.abs(torch.arange(ms.max_kf, device=dev) - kf) < min_time_gap_slots
    same_map = ms.kf_map_id == ms.kf_map_id[kf]
    eligible = ms.kf_valid & same_map & ~covis & ~slot_gap
    ids, vals = tracker.covis_group_rank(ms, score, eligible, top_k)
    return LoopCandidate(kf_id=ids, score=vals)


def _loop_pairs(ms: M.MapState, kf_query, kf_cand, max_hamming, nn_ratio):
    """Descriptor matches between the point-bearing features of two KFs:
    (matched [F], Xq [F,3], Xc [F,3])."""
    pt_q = ms.kf_point[kf_query]
    pt_c = ms.kf_point[kf_cand]
    has_q = (pt_q >= 0) & ms.kf_feat_valid[kf_query]
    has_c = (pt_c >= 0) & ms.kf_feat_valid[kf_cand]
    dist = matcher.hamming_matrix(ms.kf_desc[kf_query], ms.kf_desc[kf_cand])
    idx, _ = matcher.match(dist, has_q, has_c, max_dist=max_hamming, ratio=nn_ratio)
    Xq = ms.pt_xyz[pt_q.clamp_min(0).long()]
    Xc = ms.pt_xyz[pt_c[idx.clamp_min(0).long()].clamp_min(0).long()]
    return idx >= 0, Xq, Xc


def verify_loop(draw, K, ms: M.MapState, kf_query, kf_cand, *, n_hyp: int = 256,
                thresh_px: float = 6.0, max_hamming=matcher.TH_LOW, nn_ratio=0.85):
    """Descriptor-matched Sim(3) verification between two KFs, drawing the
    ``n_hyp`` 3-pair index sets with ``draw(logits, (n_hyp, 3))``.

    Returns (S [8] mapping the candidate-side world onto the query side: for
    an intra-map loop both share the world, so S is the accumulated drift;
    n_inliers; inlier mask [F]).
    """
    matched, _, _ = _loop_pairs(ms, kf_query, kf_cand, max_hamming, nn_ratio)
    logits = torch.log(torch.clamp_min(matched.to(torch.float32), 1e-12))
    hyp_idx = draw(logits, (n_hyp, 3)).to(ms.kf_pose.device)
    return verify_loop_from(hyp_idx, K, ms, kf_query, kf_cand, thresh_px=thresh_px,
                            max_hamming=max_hamming, nn_ratio=nn_ratio)


def verify_loop_from(hyp_idx, K, ms: M.MapState, kf_query, kf_cand, *,
                     thresh_px: float = 6.0, max_hamming=matcher.TH_LOW, nn_ratio=0.85):
    """``verify_loop`` on given index sets ``hyp_idx [H, 3]`` (rows of the
    query KF's feature axis)."""
    hyp_idx = hyp_idx.long()
    matched, Xq, Xc = _loop_pairs(ms, kf_query, kf_cand, max_hamming, nn_ratio)
    S_h = alignment.horn_alignment(Xc[hyp_idx], Xq[hyp_idx])         # [H,8]

    T_q = ms.kf_pose[kf_query]
    uv_q = ms.kf_uv[kf_query]

    def inliers_at(S, t):
        X_hat = lie.sim3_apply(S[..., None, :], Xc)
        uv_hat, depth = camera.project_world(K, T_q, X_hat)
        err = torch.linalg.vector_norm(uv_hat - uv_q, dim=-1)
        return matched & (err < t) & (depth > 0.05)

    scores = torch.sum(inliers_at(S_h, thresh_px), dim=-1)
    S = S_h[torch.argmax(scores)]
    # refinement: a minimal 3-point hypothesis rarely nails the Sim(3) under
    # scale drift, so refit weighted Horn on the consensus set at a relaxed
    # gate, then once at the final gate (no minimum-inlier floor on the
    # relaxed refit beyond 3, as in the JAX package)
    for relax in (2.0, 1.0):
        w = inliers_at(S, relax * thresh_px).to(torch.float32)
        S_ref = alignment.horn_alignment(Xc, Xq, w)
        S = torch.where(torch.sum(w) >= 3, S_ref, S)
    inl = inliers_at(S, thresh_px)
    return S, torch.sum(inl), inl


def close_loop(ms: M.MapState, K, kf_query: int, kf_cand: int, S_drift, *,
               min_covis_edge: int = 100):
    """Correct the map after a verified loop: essential-graph edges from the
    current poses, the loop edge overridden with the drift-corrected
    measurement, optimise, move the points."""
    dev = ms.kf_pose.device
    kf_sim3 = lie.sim3_from_se3(ms.kf_pose)
    edges = pose_graph.build_edges_from_covisibility(
        kf_sim3, M.covisibility(ms), ms.kf_valid, min_weight=min_covis_edge)
    # the verified Sim(3) maps the candidate-side geometry onto the query
    # side, so the corrected query pose is S_q * S_drift^-1 and the loop edge
    # (q, c) measures S_q_corr * S_c^-1
    S_q_corr = lie.sim3_compose(kf_sim3[kf_query], lie.sim3_inverse(S_drift))
    loop_meas = lie.sim3_compose(S_q_corr, lie.sim3_inverse(kf_sim3[kf_cand]))
    i32 = dict(dtype=torch.int32, device=dev)
    edges = pose_graph.PoseGraphEdges(
        i=torch.cat([edges.i, torch.tensor([kf_query], **i32)]),
        j=torch.cat([edges.j, torch.tensor([kf_cand], **i32)]),
        S_ij=torch.cat([edges.S_ij, loop_meas[None]], dim=0),
        weight=torch.cat([edges.weight, torch.tensor([5.0], device=dev)]))

    slot = torch.arange(ms.max_kf, device=dev)
    fixed = (slot == kf_cand) | ~ms.kf_valid
    S_new = pose_graph.optimize_pose_graph(kf_sim3, edges, fixed, n_iters=8)

    new_pt = pose_graph.correct_points(ms.pt_xyz, ms.pt_ref_kf, ms.pt_valid, kf_sim3, S_new)
    # back to SE(3): divide the translation by the scale
    s = lie.sim3_scale(S_new)
    new_pose = lie.se3(S_new[:, :4], S_new[:, 4:7] / s[:, None])
    new_pose = torch.where(ms.kf_valid[:, None], new_pose, ms.kf_pose)
    return ms._replace(kf_pose=new_pose, pt_xyz=new_pt)
