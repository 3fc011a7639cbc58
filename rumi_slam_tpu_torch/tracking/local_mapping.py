"""Local mapping: new-point triangulation, duplicate fusion, windowed BA,
culling, and the global BA over one submap, dense or sharded (port of
``rumi_slam_tpu/tracking/local_mapping.py``).

Each function is MapState -> MapState and writes no tensor of its input.
Points keep their global slot inside the BA problem; local BA compacts only
the cameras (the window and its fixed ring).  Top-k selections break ties
toward the lowest index, as ``lax.top_k`` does (``ops.select.top_k``).
"""

from __future__ import annotations

import torch

from ..geometry import camera, lie, triangulation
from ..mapstate import map_state as M
from ..ops import matcher
from ..ops.select import top_k
from ..optim import ba


def octave_inv_sigma2(octave, scale_factor=1.2):
    return 1.0 / (scale_factor ** (2.0 * octave.to(torch.float32)))


def _scatter_max_row(row, idx, val):
    """``full_like(row, -1).at[idx].max(val)``: order-free."""
    return torch.full_like(row, -1).scatter_reduce(0, idx.long(), val.to(row.dtype), "amax")


def triangulate_with_neighbor(ms: M.MapState, K, kf_new, kf_ref, *,
                              max_hamming=matcher.TH_LOW, nn_ratio=0.75,
                              epipolar_eps=2e-3):
    """Create new map points between two keyframes: match the unassociated
    features of both under an epipolar gate, triangulate, check
    cheirality/parallax/reprojection, append.  Returns (ms, n_new)."""
    T1 = ms.kf_pose[kf_new]
    T2 = ms.kf_pose[kf_ref]
    free1 = ms.kf_feat_valid[kf_new] & (ms.kf_point[kf_new] < 0)
    free2 = ms.kf_feat_valid[kf_ref] & (ms.kf_point[kf_ref] < 0)

    r1 = camera.unproject(K, ms.kf_uv[kf_new])
    r2 = camera.unproject(K, ms.kf_uv[kf_ref])
    E = triangulation.essential_from_poses(T1, T2)
    # normalized epipolar residual |r2^T E r1| / |(E r1)_xy|
    Er1 = r1 @ E.T
    epi = torch.abs(Er1 @ r2.T)
    n1 = torch.linalg.vector_norm(Er1[:, :2], dim=-1, keepdim=True)
    epi = epi / torch.clamp_min(n1, 1e-9)

    dist = matcher.hamming_matrix(ms.kf_desc[kf_new], ms.kf_desc[kf_ref])
    idx, _ = matcher.match(dist, free1, free2, mask=epi < epipolar_eps,
                           max_dist=max_hamming, ratio=nn_ratio)
    matched = idx >= 0
    i2 = idx.clamp_min(0).long()

    n = r1.shape[0]
    X = triangulation.triangulate_dlt(T1.expand(n, 7), T2.expand(n, 7), r1, r2[i2])
    ok = matched & triangulation.triangulation_checks(
        K, T1, T2, ms.kf_uv[kf_new], ms.kf_uv[kf_ref][i2], X)

    ms, ids = M.add_points(ms, X, ms.kf_desc[kf_new], ok, kf_new,
                           octave=ms.kf_octave[kf_new], angle=ms.kf_angle[kf_new])
    assoc_new = torch.where(ids >= 0, ids, ms.kf_point[kf_new])
    kf_point = M.put_row(ms.kf_point, kf_new, assoc_new)
    ref_row = kf_point[kf_ref]
    upd = _scatter_max_row(ref_row, i2, torch.where(ok, ids, -1))
    kf_point = M.put_row(kf_point, kf_ref, torch.where(upd >= 0, upd, ref_row))
    return ms._replace(kf_point=kf_point), torch.sum(ok.to(torch.int32))


def local_bundle_adjustment(ms: M.MapState, K, kf_id, *, window: int = 8,
                            n_iters: int = 6, use_stereo: bool = False, bf=0.0,
                            fixed_ring: int = 6):
    """Windowed BA around ``kf_id``: the covisibility window is free (minus
    its two lowest-slot members, the gauge), all observed points are free,
    and the ``fixed_ring`` out-of-window KFs with the most observations of
    window points add those observations with their camera held fixed."""
    W = window
    ids, valid_w = M.local_window(ms, kf_id, window=W)
    F = ms.max_feat
    dev = ms.kf_pose.device
    idl = ids.long()
    kf = torch.as_tensor(kf_id, device=dev).long()

    Rng = fixed_ring
    if Rng > 0:
        # points observed by the window (only the True slots are written)
        win_pt = ms.kf_point[idl].reshape(-1)
        wpt = M.put_rows(torch.zeros_like(ms.pt_valid), win_pt.clamp_min(0),
                         torch.ones_like(win_pt, dtype=torch.bool), win_pt >= 0)
        wpt = wpt & ms.pt_valid
        obs_w = (ms.kf_point >= 0) & wpt[ms.kf_point.clamp_min(0).long()]
        ov = torch.sum(obs_w, dim=1).to(torch.int32)
        # window ids are distinct (top-k), so this set cannot race
        in_win = torch.zeros((ms.max_kf,), dtype=torch.bool, device=dev).index_put(
            (idl,), valid_w)
        eligible = ms.kf_valid & ~in_win & (ms.kf_map_id == ms.kf_map_id[kf])
        ring_ov, ring_ids = top_k(torch.where(eligible, ov, -1), Rng)
        all_ids = torch.cat([idl, ring_ids])
        all_valid = torch.cat([valid_w, ring_ov > 0])
    else:
        all_ids, all_valid = idl, valid_w
    C = W + max(Rng, 0)

    cam_idx = torch.arange(C, device=dev).repeat_interleave(F)
    pt = ms.kf_point[all_ids].reshape(-1)
    uv = ms.kf_uv[all_ids].reshape(-1, 2)
    octv = ms.kf_octave[all_ids].reshape(-1)
    conf_b = (pt >= 0) & ms.kf_feat_valid[all_ids].reshape(-1) & all_valid.repeat_interleave(F)
    if Rng > 0:
        # ring observations take part only for window points
        ring_rows = (torch.arange(C, device=dev) >= W).repeat_interleave(F)
        conf_b = conf_b & (~ring_rows | wpt[pt.clamp_min(0).long()])
    conf = conf_b.to(torch.float32) * octave_inv_sigma2(octv)

    # gauge: hold the two oldest (smallest slot id) valid window members
    big = 1 << 30
    order = torch.where(valid_w, ids, big)
    anchor1 = torch.min(order)
    anchor2 = torch.min(torch.where(order == anchor1, big, order))
    cam_free = all_valid & (all_ids != anchor1) & (all_ids != anchor2)
    if Rng > 0:
        cam_free = cam_free & (torch.arange(C, device=dev) < W)

    ur = ms.kf_ur[all_ids].reshape(-1) if use_stereo else None
    res = ba.bundle_adjust(
        K, ms.kf_pose[all_ids], ms.pt_xyz, cam_idx, pt.clamp_min(0), uv, conf,
        cam_free, ms.pt_valid, n_iters=n_iters,
        bf=torch.tensor(bf, dtype=torch.float32, device=dev) if use_stereo else None, ur=ur,
    )

    # write back the window poses (ring poses were fixed) and all points
    kf_pose = ms.kf_pose.index_put(
        (idl,), torch.where(valid_w[:, None], res.poses[:W], ms.kf_pose[idl]))
    # drop outlier observations of the window rows
    inl = res.inlier_obs.reshape(C, F)[:W]
    conf_w = conf.reshape(C, F)[:W]
    rows = ms.kf_point[idl]
    new_rows = torch.where(valid_w[:, None] & (conf_w > 0) & ~inl, -1, rows)
    kf_point = ms.kf_point.index_put((idl,), new_rows)
    return ms._replace(kf_pose=kf_pose, pt_xyz=res.points, kf_point=kf_point)


def fuse_with_neighbors(ms: M.MapState, K, kf_id, *, window: int = 4, radius: float = 3.0,
                        max_hamming=matcher.TH_LOW, img_w: float = 1e6, img_h: float = 1e6):
    """In-map duplicate-point fusion and observation extension.

    For each neighbour of ``kf_id`` (the covisible KFs plus the two
    preceding slots): project the points ``kf_id`` observes, match them to
    the neighbour's features inside a pixel radius; a feature bound to a
    different point that lies close in space marks a duplicate (fused into
    the lower slot), an unbound feature gains the observation.
    Returns (ms, n_fused).
    """
    P = ms.max_pt
    dev = ms.kf_pose.device
    kf = torch.as_tensor(kf_id, device=dev).long()
    Wgt = M.covisibility(ms)
    slot = torch.arange(ms.max_kf, device=dev)
    eligible = ms.kf_valid & (ms.kf_map_id == ms.kf_map_id[kf]) & (slot != kf)
    recent = eligible & (slot < kf) & (slot >= kf - 2)
    score = Wgt[kf] * eligible.to(torch.int32) + recent.to(torch.int32) * (1 << 20)
    vals, nb_ids = top_k(score, window - 1)
    ids = torch.cat([kf.reshape(1), nb_ids])
    valid_w = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev), vals > 0])
    pt_k = ms.kf_point[kf]
    has_pt = pt_k >= 0
    pt_rows = pt_k.clamp_min(0)
    desc_k = ms.pt_desc[pt_rows.long()]
    X_k = ms.pt_xyz[pt_rows.long()]

    fuse_to = torch.full((P + 1,), P, dtype=torch.int32, device=dev)   # min-scatter target
    kf_point = ms.kf_point
    for w in range(1, window):
        nb = ids[w]
        ok_w = valid_w[w] & (nb != kf)
        uv_proj, depth = camera.project_world(K, ms.kf_pose[nb], X_k)
        cand = (has_pt & ok_w & (depth > 0.05)
                & (uv_proj[:, 0] >= 0) & (uv_proj[:, 0] < img_w)
                & (uv_proj[:, 1] >= 0) & (uv_proj[:, 1] < img_h))
        mask = matcher.radius_mask(uv_proj, ms.kf_uv[nb], radius)
        dist = matcher.hamming_matrix(desc_k, ms.kf_desc[nb])
        idx, _ = matcher.match(dist, cand, ms.kf_feat_valid[nb], mask=mask,
                               max_dist=max_hamming, ratio=1.0)
        matched = idx >= 0
        i2 = idx.clamp_min(0).long()
        nb_pt = kf_point[nb][i2]
        # duplicate pair (pt_k[f], nb_pt), gated on 3D closeness
        X_nb = ms.pt_xyz[nb_pt.clamp_min(0).long()]
        close3d = torch.linalg.vector_norm(X_nb - X_k, dim=-1) < 0.08 * torch.clamp_min(depth, 0.5)
        dup = matched & (nb_pt >= 0) & (nb_pt != pt_rows) & close3d
        lo = torch.minimum(pt_rows, nb_pt.clamp_min(0))
        hi = torch.maximum(pt_rows, nb_pt.clamp_min(0))
        fuse_to = fuse_to.scatter_reduce(0, torch.where(dup, hi, P).long(),
                                         torch.where(dup, lo, P), "amin")
        # extend the observation into the unbound neighbour feature
        add = matched & (nb_pt < 0)
        row = kf_point[nb]
        upd = _scatter_max_row(row, i2, torch.where(add, pt_k, -1))
        kf_point = M.put_row(kf_point, nb, torch.where(upd >= 0, upd, row))
    fuse_to = fuse_to[:P]

    # resolve transitive chains, then relabel every reference of a dropped
    # point and kill it
    for _ in range(3):
        nxt = fuse_to[fuse_to.clamp(0, P - 1).long()]
        fuse_to = torch.where((fuse_to < P) & (nxt < P), nxt, fuse_to)
    have_target = fuse_to < P
    tgt = torch.where(have_target, fuse_to, -1)
    ref = tgt[kf_point.clamp_min(0).long()]
    kf_point = torch.where((kf_point >= 0) & (ref >= 0), ref, kf_point)
    return (ms._replace(kf_point=kf_point, pt_valid=ms.pt_valid & ~have_target),
            torch.sum(have_target.to(torch.int32)))


def _kill_keyframes(ms: M.MapState, score, n, floor):
    """Invalidate the top-``n`` KFs of ``score`` whose score is above
    ``floor`` and detach their observations."""
    _, top = top_k(score, n)
    kill = torch.zeros((ms.max_kf,), dtype=torch.bool, device=score.device).index_put(
        (top,), score[top] > floor)
    return ms._replace(kf_valid=ms.kf_valid & ~kill,
                       kf_point=torch.where(kill[:, None], -1, ms.kf_point))


def _redundancy(ms: M.MapState, min_obs):
    """Per KF, the share of its observed points seen by >= ``min_obs`` KFs."""
    obs = M.point_obs_count(ms)
    has_pt = ms.kf_point >= 0
    red = torch.sum(has_pt & (obs >= min_obs)[ms.kf_point.clamp_min(0).long()], dim=1)
    tot = torch.clamp_min(torch.sum(has_pt, dim=1).to(torch.float32), 1.0)
    return red.to(torch.float32) / tot


def cull_keyframes(ms: M.MapState, kf_current, *, redundancy=0.9, min_redundant_obs=4,
                   protect_recent=3, max_cull: int = 4):
    """Keyframe culling: a KF is redundant when more than ``redundancy`` of
    its points are seen by >= ``min_redundant_obs`` KFs.  Cloud KFs, the
    most recent ``protect_recent`` slots and the two origin KFs stay; at
    most ``max_cull`` go per call, the most redundant first."""
    ratio = _redundancy(ms, min_redundant_obs)
    slot = torch.arange(ms.max_kf, device=ratio.device)
    cullable = (ms.kf_valid & ~ms.kf_is_cloud & (ratio > redundancy)
                & (slot < kf_current - protect_recent) & (slot >= 2))
    return _kill_keyframes(ms, torch.where(cullable, ratio, -1.0), max_cull, 0.0)


def evict_for_capacity(ms: M.MapState, kf_current, *, n_evict: int = 4, protect_recent=6):
    """Forced keyframe eviction when the map is full: the most redundant
    (ties: oldest) non-cloud, non-origin, non-recent KFs go."""
    ratio = _redundancy(ms, 3)
    slot = torch.arange(ms.max_kf, device=ratio.device)
    eligible = (ms.kf_valid & ~ms.kf_is_cloud & (slot < kf_current - protect_recent)
                & (slot >= 2))
    score = torch.where(eligible, ratio - 1e-4 * slot.to(torch.float32), -1e9)
    return _kill_keyframes(ms, score, n_evict, -1e8)


def cull_points(ms: M.MapState, *, min_found_ratio=0.25, min_obs=2, grace_obs=3):
    """Map-point culling: drop points whose found/visible ratio is poor or
    that have too few observations; points seen by >= ``grace_obs`` KFs
    keep their place regardless of the ratio."""
    obs = M.point_obs_count(ms)
    ratio = ms.pt_found / torch.clamp_min(ms.pt_visible, 1.0)
    bad = ms.pt_valid & (((ratio < min_found_ratio) & (obs < grace_obs)) | (obs < min_obs))
    bad_ref = bad[ms.kf_point.clamp_min(0).long()] & (ms.kf_point >= 0)
    return ms._replace(pt_valid=ms.pt_valid & ~bad,
                       kf_point=torch.where(bad_ref, -1, ms.kf_point))


def _round_up(n, step=32):
    return max(step, ((n + step - 1) // step) * step)


def gba_problem(ms: M.MapState, map_id):
    """The compacted global-BA problem of one submap: its live keyframes and
    points renumbered to a prefix and padded to 32-buckets.

    Returns None when the submap has fewer than 3 keyframes or 8 points,
    else a dict with the row indices (``kf_rows``, ``pt_rows``: LongTensors
    on the map's device), the padded sizes ``C``, ``P``, the observation
    count ``n_obs`` (0-d tensor) and the arguments of
    ``ba.bundle_adjust`` (``poses, points, cam_idx, pt_idx, uv, conf,
    cam_free, pt_free``).  One host read (the two membership masks) sizes
    the problem; everything else stays on the device.
    """
    dev = ms.kf_pose.device
    kf_sel = (ms.kf_map_id == map_id) & ms.kf_valid
    pt_sel = (ms.pt_map_id == map_id) & ms.pt_valid
    kf_rows = torch.nonzero(kf_sel)[:, 0]
    pt_rows = torch.nonzero(pt_sel)[:, 0]
    nk, npt = int(kf_rows.shape[0]), int(pt_rows.shape[0])
    if nk < 3 or npt < 8:
        return None
    C, P, F = _round_up(nk), _round_up(npt), ms.max_feat

    pt_local = torch.full((ms.max_pt,), -1, dtype=torch.int64, device=dev)
    pt_local[pt_rows] = torch.arange(npt, device=dev)
    kp = ms.kf_point[kf_rows]                                        # [nk, F]
    obs_pt = torch.where(kp >= 0, pt_local[kp.clamp_min(0).long()], -1)
    conf = ((obs_pt >= 0) & ms.kf_feat_valid[kf_rows]).to(torch.float32) \
        * octave_inv_sigma2(ms.kf_octave[kf_rows])
    # cloud-KF observations (keypoints detected on blur-homogenised bundle
    # frames) are noisier than live ones and, after a merge, as many
    conf = conf * torch.where(ms.kf_is_cloud[kf_rows], 0.3, 1.0)[:, None]

    pad = (C - nk) * F
    poses = torch.cat([ms.kf_pose[kf_rows],
                       lie.se3_identity(device=dev).expand(C - nk, 7)])
    points = torch.cat([ms.pt_xyz[pt_rows], torch.zeros((P - npt, 3), device=dev)])
    zl = torch.zeros((pad,), dtype=torch.int64, device=dev)
    return {
        "kf_rows": kf_rows, "pt_rows": pt_rows, "C": C, "P": P,
        "n_obs": torch.sum(conf > 0),
        "args": (
            poses, points,
            torch.cat([torch.arange(nk, device=dev).repeat_interleave(F), zl]),
            torch.cat([obs_pt.clamp_min(0).reshape(-1), zl]),
            torch.cat([ms.kf_uv[kf_rows].reshape(-1, 2), torch.zeros((pad, 2), device=dev)]),
            torch.cat([conf.reshape(-1), torch.zeros((pad,), device=dev)]),
            (torch.arange(C, device=dev) >= 2) & (torch.arange(C, device=dev) < nk),
            torch.arange(P, device=dev) < npt,
        ),
    }


def global_bundle_adjustment(ms: M.MapState, K, map_id, *, n_iters: int = 12, mesh=None):
    """Full BA over one submap: the problem is compacted to the submap's live
    keyframes and points (``gba_problem``) and handed to the dense
    Schur-complement LM engine, so memory follows the live map and not the
    capacity.  Gauge: the two oldest KFs stay fixed.  It runs rarely: after
    a loop closure and after a rumination merge.

    ``mesh``: a ``parallel.distributed.BaMesh`` routes the solve through the
    sharded matrix-free PCG engine (``_global_ba_sharded``), the post-merge
    GBA path when more than one card is visible.  None = the dense solve.
    """
    if mesh is not None:
        return _global_ba_sharded(ms, K, map_id, mesh, n_iters=n_iters)
    prob = gba_problem(ms, map_id)
    if prob is None:
        return ms
    res = ba.bundle_adjust(K, *prob["args"], n_iters=n_iters)
    kf_rows, pt_rows = prob["kf_rows"], prob["pt_rows"]
    return ms._replace(
        kf_pose=ms.kf_pose.index_put((kf_rows,), res.poses[: kf_rows.shape[0]]),
        pt_xyz=ms.pt_xyz.index_put((pt_rows,), res.points[: pt_rows.shape[0]]))


def _global_ba_sharded(ms: M.MapState, K, map_id, mesh, *, n_iters: int,
                       max_obs_per_point: int = 16):
    """Sharded GBA: compact the submap (``C`` = its keyframes, no bucket
    padding; only the valid observations), group observations by point (R
    slots), shard points round-robin over ``mesh.size`` shards and run the
    matrix-free PCG Schur solve on ``mesh.device``.  Observations beyond
    ``max_obs_per_point`` for one landmark are dropped with a log line.  The
    compaction runs on the host, as in the JAX package (GBA runs rarely)."""
    import numpy as np

    from ..parallel import sharded_ba
    from ..utils import verbose

    def host(x):
        return x.detach().cpu().numpy()

    D = mesh.size
    kf_rows = np.flatnonzero(host((ms.kf_map_id == map_id) & ms.kf_valid))
    pt_rows = np.flatnonzero(host((ms.pt_map_id == map_id) & ms.pt_valid))
    if len(kf_rows) < 3 or len(pt_rows) < 8:
        return ms
    C = len(kf_rows)
    pt_local = np.full(ms.max_pt, -1, np.int64)
    pt_local[pt_rows] = np.arange(len(pt_rows))

    kp = host(ms.kf_point[kf_rows])                       # [C, F]
    feat_ok = host(ms.kf_feat_valid[kf_rows])
    obs_sel = (kp >= 0) & feat_ok & (pt_local[np.clip(kp, 0, None)] >= 0)
    cam_idx = np.repeat(np.arange(C), ms.max_feat).reshape(kp.shape)[obs_sel]
    pt_idx = pt_local[np.clip(kp, 0, None)][obs_sel]
    uv = host(ms.kf_uv[kf_rows]).reshape(-1, 2)[obs_sel.reshape(-1)]
    conf = host(octave_inv_sigma2(ms.kf_octave[kf_rows]))
    # the dense path's down-weight of cloud-keyframe observations
    conf = (conf * np.where(host(ms.kf_is_cloud[kf_rows])[:, None], 0.3, 1.0))[obs_sel]

    part = sharded_ba.partition_problem_grouped(
        cam_idx.astype(np.int32), pt_idx.astype(np.int32), uv.astype(np.float32),
        conf.astype(np.float32), len(pt_rows), D, obs_per_point=max_obs_per_point)
    if part["dropped_obs"]:
        verbose.print_mess(
            f"[gba] sharded GBA dropped {part['dropped_obs']} observations "
            f"beyond {max_obs_per_point}/point", verbose.Level.QUIET)
    Pl = part["pts_per_shard"]
    X = host(ms.pt_xyz[pt_rows])
    pts_sh = np.zeros((D, Pl, 3), np.float32)
    rows = part["point_rows"]
    for d in range(D):
        ok = rows[d] < len(pt_rows)
        pts_sh[d, ok] = X[rows[d][ok]]

    mdev = ms.kf_pose.device
    kf_t = torch.from_numpy(kf_rows).to(mdev)
    res_poses, res_pts, _ = sharded_ba.sharded_bundle_adjust_pcg(
        mesh, K, ms.kf_pose[kf_t], torch.from_numpy(pts_sh.reshape(D * Pl, 3)),
        torch.from_numpy(part["cam_idx"].reshape(D * Pl, -1)),
        torch.from_numpy(part["uv"].reshape(D * Pl, -1, 2)),
        torch.from_numpy(part["conf"].reshape(D * Pl, -1)),
        torch.arange(C) >= 2, n_iters=n_iters)

    X_new = host(res_pts).reshape(D, Pl, 3)
    X_out = X.copy()
    for d in range(D):
        ok = rows[d] < len(pt_rows)
        X_out[rows[d][ok]] = X_new[d][ok]
    pt_t = torch.from_numpy(pt_rows).to(mdev)
    return ms._replace(kf_pose=ms.kf_pose.index_put((kf_t,), res_poses.to(mdev)),
                       pt_xyz=ms.pt_xyz.index_put((pt_t,), torch.from_numpy(X_out).to(mdev)))
