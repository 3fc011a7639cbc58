"""Sharded global bundle adjustment: the Schur reduction summed over point
shards (port of ``rumi_slam_tpu/parallel/sharded_ba.py``).

Sharding contract (the JAX package's):
  * POINTS are sharded in blocks; every observation of a point lives on that
    point's shard.  Per-shard Hpp blocks are complete, per-shard cross blocks
    W are disjoint, and the reduced camera system is additive over shards:
    S = sum_d [ Hcc_d - W_d Hpp_d^-1 W_d^T ].
  * Cameras are replicated; the reduced system is solved once after the sum.
  * Point updates are local to their shard.

Where the JAX package runs one program per device under ``shard_map`` and
sums with ``psum``, the port keeps the ``D = mesh.size`` shards of a
``distributed.BaMesh`` batched on a leading ``[D, ...]`` axis of one device:
every per-shard term is computed for all shards at once and the psum is a
``sum(0)``.  The global arrays keep the JAX layout (shard-major leading axis
``D * Pl``), so the same partitioned inputs feed both packages.

Accept and damping decisions, and the CG guards, stay on the device
(``torch.where`` on 0-d tensors), so neither loop reads the device.  The
sums of ``index_add_`` / ``index_put_(accumulate=True)`` run in a varying
order on the card: hold card results to bounds, never to one reading.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry import camera, lie
from ..optim import robust
from ..optim.ba import _inv3x3

CHI2_MONO = 5.991


def partition_problem(cam_idx, pt_idx, uv, conf, n_points, n_shards):
    """Host-side repartition: points round-robin by block to shards; every
    observation follows its point.  Pads per-shard obs counts to the max.

    Returns dict of numpy arrays shaped [D, ...], plus the point permutation
    (shard-major) used to scatter points.
    """
    cam_idx = np.asarray(cam_idx)
    pt_idx = np.asarray(pt_idx)
    uv = np.asarray(uv)
    conf = np.asarray(conf)

    pt_shard = pt_idx % n_shards
    pt_local = pt_idx // n_shards
    pts_per_shard = (n_points + n_shards - 1) // n_shards

    counts = np.bincount(pt_shard, minlength=n_shards)
    obs_per_shard = max(int(counts.max()), 1)

    D = n_shards
    cam_s = np.zeros((D, obs_per_shard), np.int32)
    ptl_s = np.zeros((D, obs_per_shard), np.int32)
    uv_s = np.zeros((D, obs_per_shard, 2), np.float32)
    conf_s = np.zeros((D, obs_per_shard), np.float32)
    for d in range(D):
        sel = pt_shard == d
        n = int(sel.sum())
        cam_s[d, :n] = cam_idx[sel]
        ptl_s[d, :n] = pt_local[sel]
        uv_s[d, :n] = uv[sel]
        conf_s[d, :n] = conf[sel]

    # point scatter: global point g lives at shard g%D, local row g//D
    perm = np.arange(pts_per_shard * D).reshape(pts_per_shard, D).T  # [D, ppS]
    return {
        "cam_idx": cam_s,
        "pt_local": ptl_s,
        "uv": uv_s,
        "conf": conf_s,
        "pts_per_shard": pts_per_shard,
        "point_rows": perm,  # [D, pts_per_shard] global row per local slot
    }


def _segsum(x, idx, n):
    """``jax.ops.segment_sum(x, idx, num_segments=n)`` over a flat ``idx``."""
    out = torch.zeros((n,) + x.shape[1:], dtype=x.dtype, device=x.device)
    return out.index_add_(0, idx, x)


def _shard_offsets(idx, n):
    """Flat segment ids ``d * n + idx`` of a ``[D, ...]`` index tensor."""
    D = idx.shape[0]
    off = torch.arange(D, device=idx.device).reshape((D,) + (1,) * (idx.ndim - 1)) * n
    return (idx.long() + off).reshape(-1)


def _damp(H, lam):
    """``H + lam * I * max(trace(H) / n, 1e-6)`` per block."""
    n = H.shape[-1]
    eye = torch.eye(n, dtype=H.dtype, device=H.device)
    tr = torch.diagonal(H, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    return H + lam * eye * torch.clamp_min(tr / n, 1e-6)


def _cost(K, poses, pts_l, cam_idx, ptl_idx, uv, conf):
    """Robust cost summed over every shard (``eval_cost``'s psum)."""
    r, _, _, _ = camera.reproj_residual_and_jacobians(
        K, poses[cam_idx.reshape(-1).long()],
        torch.gather(pts_l, 1, ptl_idx.long()[..., None].expand(-1, -1, 3)).reshape(-1, 3),
        uv.reshape(-1, 2))
    conf_f = conf.reshape(-1)
    chi2 = torch.sum(r * r, dim=-1) * conf_f
    return torch.sum(torch.where(conf_f > 0, robust.huber_cost(chi2, CHI2_MONO), 0.0))


def _shard_terms(K, poses, pts_l, cam_idx, ptl_idx, uv, conf, lam):
    """Per-shard assembly of the Schur terms, for all shards at once.

    pts_l [D,Pl,3]; cam_idx/ptl_idx/conf [D,Od]; uv [D,Od,2].  Returns
    (S_local [D,C,6,C,6], b_local [D,C,6], Wblk [D,Pl,C,6,3],
    Hpp_inv [D,Pl,3,3], bp [D,Pl,3], cost [D]).  Each shard damps its own
    Hcc before the sum, so the summed system carries D copies of the
    damping, as in the JAX package.
    """
    C = poses.shape[0]
    D, Pl = pts_l.shape[:2]
    dt, dev = poses.dtype, poses.device
    cam_f = cam_idx.reshape(-1).long()
    X_o = torch.gather(pts_l, 1, ptl_idx.long()[..., None].expand(-1, -1, 3)).reshape(-1, 3)
    r, Jc, Jp, depth = camera.reproj_residual_and_jacobians(
        K, poses[cam_f], X_o, uv.reshape(-1, 2))
    conf_f = conf.reshape(-1)
    chi2 = torch.sum(r * r, dim=-1) * conf_f
    w = conf_f * robust.huber_weight(chi2, CHI2_MONO) * (depth > 0.05)
    cost = torch.where(conf_f > 0, robust.huber_cost(chi2, CHI2_MONO), 0.0).reshape(D, -1).sum(1)

    seg_c = _shard_offsets(cam_idx, C)
    seg_p = _shard_offsets(ptl_idx, Pl)
    Hcc = _segsum(torch.einsum("oki,o,okj->oij", Jc, w, Jc), seg_c, D * C).reshape(D, C, 6, 6)
    bc = _segsum(torch.einsum("oki,o,ok->oi", Jc, w, r), seg_c, D * C).reshape(D, C, 6)
    Hpp = _segsum(torch.einsum("oki,o,okj->oij", Jp, w, Jp), seg_p, D * Pl).reshape(D, Pl, 3, 3)
    bp = _segsum(torch.einsum("oki,o,ok->oi", Jp, w, r), seg_p, D * Pl).reshape(D, Pl, 3)

    Hcc_d = _damp(Hcc, lam)
    Hpp_inv = _inv3x3(_damp(Hpp, lam))

    d_o = torch.arange(D, device=dev).repeat_interleave(cam_idx.shape[1])
    Wblk = torch.zeros((D, Pl, C, 6, 3), dtype=dt, device=dev).index_put_(
        (d_o, ptl_idx.reshape(-1).long(), cam_f),
        torch.einsum("oki,o,okj->oij", Jc, w, Jp), accumulate=True)
    Y = torch.einsum("dpcij,dpjk->dpcik", Wblk, Hpp_inv)
    S_local = -torch.einsum("dpcik,dpemk->dciem", Y, Wblk)
    diag = torch.arange(C, device=dev)
    S_local[:, diag, :, diag, :] += Hcc_d.transpose(0, 1)
    b_local = bc - torch.einsum("dpcik,dpk->dci", Y, bp)
    return S_local, b_local, Wblk, Hpp_inv, bp, cost


def _as_shards(mesh, *arrays):
    """Global ``[D*n, ...]`` arrays -> ``[D, n, ...]`` tensors on the mesh's device."""
    D = mesh.size
    return [a.to(mesh.device).reshape((D, a.shape[0] // D) + tuple(a.shape[1:]))
            for a in arrays]


def sharded_bundle_adjust(mesh, K, poses, points_sh, cam_idx_sh, ptl_idx_sh, uv_sh, conf_sh,
                          cam_free, *, n_iters: int = 8):
    """LM-BA with the dense reduced camera system summed over the shards.

    Args (sh = global arrays whose leading axis is ``D`` shard-major blocks,
    ``D = mesh.size``): points_sh [D*Pl, 3]; cam_idx_sh/ptl_idx_sh [D*Od];
    uv_sh [D*Od, 2]; conf_sh [D*Od]; poses [C,7] and cam_free [C].
    Returns (poses [C,7], points_sh [D*Pl, 3], the last proposed step's cost)
    on ``mesh.device``.
    """
    dev = mesh.device
    K, poses = K.to(dev), poses.to(dev)
    free = cam_free.to(dev).to(torch.float32)
    pts, cam, ptl, uv, conf = _as_shards(mesh, points_sh, cam_idx_sh, ptl_idx_sh, uv_sh,
                                         conf_sh)
    C = poses.shape[0]
    eye6 = torch.eye(6, dtype=poses.dtype, device=poses.device)
    diag = torch.arange(C, device=poses.device)

    def step(poses, pts, lam):
        S_local, b_local, Wblk, Hpp_inv, bp, _ = _shard_terms(
            K, poses, pts, cam, ptl, uv, conf, lam)
        S = S_local.sum(0)
        b_red = b_local.sum(0)
        # gauge: fixed cameras become identity rows of the system
        S = S * free[:, None, None, None] * free[None, None, :, None]
        S[diag, :, diag, :] += eye6 * (1.0 - free)[:, None, None]
        b_red = b_red * free[:, None]
        Sd = S.reshape(C * 6, C * 6) + 1e-8 * torch.eye(C * 6, dtype=S.dtype, device=S.device)
        dxc = -torch.linalg.solve_ex(Sd, b_red.reshape(C * 6))[0].reshape(C, 6)
        dxc = dxc * free[:, None]
        t_p = torch.einsum("dpcik,ci->dpk", Wblk, dxc)
        dxp = -torch.einsum("dpij,dpj->dpi", Hpp_inv, bp + t_p)
        return lie.se3_retract(poses, dxc), pts + dxp

    lam = torch.full((), 1e-4, dtype=torch.float32, device=poses.device)
    cost1 = None
    for _ in range(n_iters):
        cost0 = _cost(K, poses, pts, cam, ptl, uv, conf)
        new_poses, new_pts = step(poses, pts, lam)
        cost1 = _cost(K, new_poses, new_pts, cam, ptl, uv, conf)
        accept = cost1 < cost0
        poses = torch.where(accept, new_poses, poses)
        pts = torch.where(accept, new_pts, pts)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-8, 1e4)
    return poses, pts.reshape(-1, 3), cost1


# ---------------------------------------------------------------------------
# Matrix-free Schur solve (PCG).  The dense solver above sums the whole
# reduced camera system S [6C,6C] and solves it; past a few hundred cameras
# that is the wall.  Here S is never built: preconditioned conjugate
# gradients on the reduced system apply  S x = Hcc_d x - sum_p W_p Hpp^-1 W_p^T x
# matrix-free, every term summed over point shards, with the block diagonal
# Hcc [C,6,6] (summed once per LM iteration) as the block-Jacobi
# preconditioner.
#
# Observation layout ("grouped"): observations are grouped by point, R slots
# per point (conf=0 padding), so Hpp/bp reduce over the slot axis and the
# cross blocks A[p,r] = Jc^T w Jp stay point-local.
# partition_problem_grouped() builds it from the flat (cam_idx, pt_idx) form.
# ---------------------------------------------------------------------------


def partition_problem_grouped(cam_idx, pt_idx, uv, conf, n_points, n_shards,
                              obs_per_point: int):
    """Group observations by point (R slots each, conf-0 padded), then shard
    points round-robin exactly like partition_problem.

    Returns dict with [D, Pl*R] obs arrays and the [D, Pl] point row map.
    Observations beyond ``obs_per_point`` for one point are dropped (callers
    size R to the max multiplicity; a count is returned for visibility).
    """
    cam_idx = np.asarray(cam_idx)
    pt_idx = np.asarray(pt_idx)
    uv = np.asarray(uv)
    conf = np.asarray(conf)
    R = obs_per_point
    D = n_shards
    Pl = (n_points + D - 1) // D

    cam_g = np.zeros((n_points, R), np.int32)
    uv_g = np.zeros((n_points, R, 2), np.float32)
    conf_g = np.zeros((n_points, R), np.float32)
    slot = np.zeros(n_points, np.int32)
    dropped = 0
    order = np.argsort(pt_idx, kind="stable")
    for o in order:
        if conf[o] <= 0:
            continue
        p = pt_idx[o]
        s = slot[p]
        if s >= R:
            dropped += 1
            continue
        cam_g[p, s] = cam_idx[o]
        uv_g[p, s] = uv[o]
        conf_g[p, s] = conf[o]
        slot[p] = s + 1

    # shard: global point g -> shard g % D, local row g // D
    cam_s = np.zeros((D, Pl, R), np.int32)
    uv_s = np.zeros((D, Pl, R, 2), np.float32)
    conf_s = np.zeros((D, Pl, R), np.float32)
    rows = np.full((D, Pl), n_points, np.int64)
    for d in range(D):
        g = np.arange(d, n_points, D)
        cam_s[d, : len(g)] = cam_g[g]
        uv_s[d, : len(g)] = uv_g[g]
        conf_s[d, : len(g)] = conf_g[g]
        rows[d, : len(g)] = g
    return {
        "cam_idx": cam_s,
        "uv": uv_s,
        "conf": conf_s,
        "pts_per_shard": Pl,
        "point_rows": rows,
        "dropped_obs": dropped,
    }


def _grouped_residuals(K, poses, pts_l, cam_idx, uv):
    """Residuals and Jacobians of every (point, slot): ``repeat_interleave``
    is ``jnp.repeat(pts_l, R, axis=0)``."""
    R = cam_idx.shape[-1]
    X_o = pts_l.repeat_interleave(R, dim=1).reshape(-1, 3)
    return camera.reproj_residual_and_jacobians(
        K, poses[cam_idx.reshape(-1).long()], X_o, uv.reshape(-1, 2))


def _grouped_terms(K, poses, pts_l, cam_idx, uv, conf, lam):
    """Per-shard terms in the grouped layout, for all shards at once.

    pts_l [D,Pl,3]; cam_idx/conf [D,Pl,R]; uv [D,Pl,R,2].
    Returns (Hcc_local [D,C,6,6], bc_corr_local [D,C,6] = bc - W Hpp^-1 bp,
             A [D,Pl,R,6,3], Hpp_inv [D,Pl,3,3], bp [D,Pl,3], cost_local [D]).
    """
    C = poses.shape[0]
    D, Pl, R = cam_idx.shape
    r, Jc, Jp, depth = _grouped_residuals(K, poses, pts_l, cam_idx, uv)
    conf_f = conf.reshape(-1)
    chi2 = torch.sum(r * r, dim=-1) * conf_f
    w = conf_f * robust.huber_weight(chi2, CHI2_MONO) * (depth > 0.05)
    cost = torch.where(conf_f > 0, robust.huber_cost(chi2, CHI2_MONO), 0.0).reshape(D, -1).sum(1)

    seg_c = _shard_offsets(cam_idx, C)
    Hcc = _segsum(torch.einsum("oki,o,okj->oij", Jc, w, Jc), seg_c, D * C).reshape(D, C, 6, 6)
    bc = _segsum(torch.einsum("oki,o,ok->oi", Jc, w, r), seg_c, D * C).reshape(D, C, 6)

    JpR = Jp.reshape(D, Pl, R, 2, 3)
    wR = w.reshape(D, Pl, R)
    rR = r.reshape(D, Pl, R, 2)
    Hpp = torch.einsum("dprki,dpr,dprkj->dpij", JpR, wR, JpR)
    bp = torch.einsum("dprki,dpr,dprk->dpi", JpR, wR, rR)
    Hpp_inv = _inv3x3(_damp(Hpp, lam))

    A = torch.einsum("oki,o,okj->oij", Jc, w, Jp).reshape(D, Pl, R, 6, 3)
    # b_reduced correction: bc[c] -= sum_{p,r:cam=c} A[p,r] Hpp^-1 bp[p]
    u = torch.einsum("dpij,dpj->dpi", Hpp_inv, bp)
    corr = torch.einsum("dprij,dpj->dpri", A, u).reshape(-1, 6)
    bc_corr = bc - _segsum(corr, seg_c, D * C).reshape(D, C, 6)
    return Hcc, bc_corr, A, Hpp_inv, bp, cost


def sharded_bundle_adjust_pcg(mesh, K, poses, points_sh, cam_idx_sh, uv_sh, conf_sh, cam_free,
                              *, n_iters: int = 8, cg_iters: int = 32):
    """LM-BA with a matrix-free PCG Schur solve over the shards.

    Args (leading axis ``D`` shard-major blocks, ``D = mesh.size``):
      points_sh  [D*Pl, 3]     — point positions, round-robin sharded
      cam_idx_sh [D*Pl, R]     — camera index per (point, obs-slot)
      uv_sh      [D*Pl, R, 2]  — measured pixels
      conf_sh    [D*Pl, R]     — information weight, 0 = padding slot
      poses [C,7], cam_free [C].
    Returns (poses [C,7], points_sh [D*Pl,3], the last proposed step's cost)
    on ``mesh.device``.  Unlike the dense solver, Hcc is damped once, after
    the sum over shards.
    """
    dev = mesh.device
    K, poses = K.to(dev), poses.to(dev)
    free = cam_free.to(dev).to(torch.float32)[:, None]
    pts, cam, uv, conf = _as_shards(mesh, points_sh, cam_idx_sh, uv_sh, conf_sh)
    C = poses.shape[0]
    cam_f = cam.reshape(-1).long()

    def S_mv(x, Hcc_d, A, Hpp_inv):
        # x [C,6]; returns S x summed over the shards
        x = x * free
        hx = torch.einsum("cij,cj->ci", Hcc_d, x)
        xg = x[cam_f].reshape(cam.shape + (6,))                  # [D,Pl,R,6]
        t = torch.einsum("dprij,dpri->dpj", A, xg)               # [D,Pl,3]
        u = torch.einsum("dpij,dpj->dpi", Hpp_inv, t)
        back = torch.einsum("dprij,dpj->dpri", A, u).reshape(-1, 6)
        return (hx - _segsum(back, cam_f, C)) * free

    def lm_step(poses, pts, lam):
        Hcc_l, b_l, A, Hpp_inv, bp, _ = _grouped_terms(K, poses, pts, cam, uv, conf, lam)
        Hcc_d = _damp(Hcc_l.sum(0), lam)
        b = b_l.sum(0) * free          # gauge: fixed cameras become identity rows
        Minv = _inv6x6(Hcc_d)          # block-Jacobi preconditioner

        # PCG on S dx = -b
        x = torch.zeros_like(b)
        r = -b
        z = torch.einsum("cij,cj->ci", Minv, r) * free
        p = z
        for _ in range(cg_iters):
            Sp = S_mv(p, Hcc_d, A, Hpp_inv)
            pSp = torch.sum(p * Sp)
            rz = torch.sum(r * z)
            ok_p = torch.abs(pSp) > 1e-12
            alpha = torch.where(ok_p, rz / torch.where(ok_p, pSp, 1.0), 0.0)
            x = x + alpha * p
            r = r - alpha * Sp
            z = torch.einsum("cij,cj->ci", Minv, r) * free
            ok_r = torch.abs(rz) > 1e-12
            beta = torch.where(ok_r, torch.sum(r * z) / torch.where(ok_r, rz, 1.0), 0.0)
            p = z + beta * p
        dxc = x * free

        # back-substitute points: dxp = -Hpp^-1 (bp + W^T dxc)
        dg = dxc[cam_f].reshape(cam.shape + (6,))
        t_p = torch.einsum("dprij,dpri->dpj", A, dg)
        dxp = -torch.einsum("dpij,dpj->dpi", Hpp_inv, bp + t_p)
        return lie.se3_retract(poses, dxc), pts + dxp

    def eval_cost(poses, pts):
        r, _, _, _ = _grouped_residuals(K, poses, pts, cam, uv)
        conf_f = conf.reshape(-1)
        chi2 = torch.sum(r * r, dim=-1) * conf_f
        return torch.sum(torch.where(conf_f > 0, robust.huber_cost(chi2, CHI2_MONO), 0.0))

    lam = torch.full((), 1e-4, dtype=torch.float32, device=poses.device)
    cost1 = None
    for _ in range(n_iters):
        cost0 = eval_cost(poses, pts)
        new_poses, new_pts = lm_step(poses, pts, lam)
        cost1 = eval_cost(new_poses, new_pts)
        accept = cost1 < cost0
        poses = torch.where(accept, new_poses, poses)
        pts = torch.where(accept, new_pts, pts)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-8, 1e4)
    return poses, pts.reshape(-1, 3), cost1


def _inv6x6(M):
    """Batched 6x6 inverse by a solve against the identity (C is small)."""
    eye = torch.eye(6, dtype=M.dtype, device=M.device)
    return torch.linalg.solve_ex(M + 1e-8 * eye, eye.expand(M.shape))[0]
