"""Monocular two-view initialisation: essential and homography RANSAC with
cheirality-checked model selection (port of
``rumi_slam_tpu/optim/two_view.py``).

All hypotheses of both models are solved and scored in one batched program
(fixed iteration count, no early exit).  The JAX package draws the
hypotheses' index sets with ``jax.random.categorical``, which torch cannot
reproduce, so the port splits the function: ``two_view_init_from`` takes the
index sets ``idx [H, 8]`` explicitly, and ``two_view_init`` draws them with
a callable ``draw(logits, (H, m)) -> LongTensor`` (``ransac.sampler``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import lie, triangulation


class TwoViewResult(NamedTuple):
    T_21: torch.Tensor       # [7] pose of view 2 in the view-1 frame (world = view 1)
    points: torch.Tensor     # [N,3] triangulated in the view-1 frame
    inliers: torch.Tensor    # [N] bool
    n_inliers: torch.Tensor  # scalar int32
    ok: torch.Tensor         # scalar bool — enough support to accept


def _smallest_eigvec(A, w=None):
    """Eigenvector of A^T A for the smallest eigenvalue, batched over A [..., R, 9]."""
    if w is not None:
        A = A * w[..., :, None]
    return torch.linalg.eigh(A.transpose(-1, -2) @ A)[1][..., :, 0]


def _plane(r):
    return r[..., 0] / r[..., 2], r[..., 1] / r[..., 2]


def _eight_point(r1, r2, w=None):
    """E from >= 8 normalized-ray pairs [..., M, 3] via DLT; optional row
    weights ``w`` [..., M] make it the weighted refinement."""
    x1, y1 = _plane(r1)
    x2, y2 = _plane(r2)
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, torch.ones_like(x1)],
                    dim=-1)
    return _smallest_eigvec(A, w).reshape(A.shape[:-2] + (3, 3))


def _to_essential(E):
    """Project onto the essential manifold (two equal singular values)."""
    U, _, Vt = torch.linalg.svd(E)
    d = torch.tensor([1.0, 1.0, 0.0], dtype=E.dtype, device=E.device)
    return (U * d) @ Vt


def _sampson_err(E, r1, r2):
    """Squared Sampson distance in normalized coordinates; E [..., 3, 3],
    rays [N, 3] -> [..., N]."""
    x1 = r1 / r1[:, 2:3]
    x2 = r2 / r2[:, 2:3]
    Ex1 = x1 @ E.transpose(-1, -2)
    Etx2 = x2 @ E
    num = torch.sum(x2 * Ex1, dim=-1) ** 2
    den = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    return num / torch.clamp_min(den, 1e-12)


def _decompose_E(E):
    """E -> 4 candidate T_21 = (R, t), ||t|| = 1."""
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))
    Vt = Vt * torch.sign(torch.linalg.det(Vt))
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    t = U[:, 2]
    cands = []
    for R in (U @ W @ Vt, U @ W.T @ Vt):
        for s in (1.0, -1.0):
            cands.append(lie.se3(lie.quat_from_matrix(R), s * t))
    return torch.stack(cands)


def _four_point_h(r1, r2, w=None):
    """Homography from >= 4 normalized-plane pairs via DLT (x2 ~ H x1);
    rays [..., M, 3], optional weights [..., M]."""
    x1, y1 = _plane(r1)
    x2, y2 = _plane(r2)
    z = torch.zeros_like(x1)
    o = torch.ones_like(x1)
    rows_a = torch.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], dim=-1)
    rows_b = torch.stack([z, z, z, x1, y1, o, -y2 * x1, -y2 * y1, -y2], dim=-1)
    A = torch.cat([rows_a, rows_b], dim=-2)
    if w is not None:
        w = torch.cat([w, w], dim=-1)
    return _smallest_eigvec(A, w).reshape(A.shape[:-2] + (3, 3))


def _sym_transfer_err(Hm, r1, r2):
    """Symmetric transfer error (normalized coordinates, squared); Hm
    [..., 3, 3] -> [..., N]."""
    x1 = r1 / r1[:, 2:3]
    x2 = r2 / r2[:, 2:3]

    def dehom(x):
        z = x[..., 2:3]
        return x / torch.where(torch.abs(z) < 1e-12, torch.full_like(z, 1e-12), z)

    eye = torch.eye(3, dtype=Hm.dtype, device=Hm.device)
    Hinv = torch.linalg.inv_ex(Hm + 1e-12 * eye)[0]
    Hx1 = dehom(x1 @ Hm.transpose(-1, -2))
    Hix2 = dehom(x2 @ Hinv.transpose(-1, -2))
    e12 = torch.sum((Hx1[..., :2] - x2[:, :2]) ** 2, dim=-1)
    e21 = torch.sum((Hix2[..., :2] - x1[:, :2]) ** 2, dim=-1)
    return 0.5 * (e12 + e21)


def _decompose_H(Hm):
    """Calibrated homography -> 8 candidate T_21 poses (Faugeras SVD
    method); translations are normalized to unit length."""
    U, d, Vt = torch.linalg.svd(Hm)
    s = torch.linalg.det(U) * torch.linalg.det(Vt)
    d1, d2, d3 = d[0], d[1], d[2]
    denom = torch.clamp_min(d1 * d1 - d3 * d3, 1e-12)
    aux1 = torch.sqrt(torch.clamp_min(d1 * d1 - d2 * d2, 0.0) / denom)
    aux3 = torch.sqrt(torch.clamp_min(d2 * d2 - d3 * d3, 0.0) / denom)
    d2s = torch.clamp_min(d2, 1e-12)
    zero, one = torch.zeros_like(d1), torch.ones_like(d1)

    out = []
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            x1, x3 = e1 * aux1, e3 * aux3
            # case d' = +d2
            st = (d1 - d3) * x1 * x3 / d2s
            ct = (d1 * x3 * x3 + d3 * x1 * x1) / d2s
            Rp = torch.stack([ct, zero, -st, zero, one, zero, st, zero, ct]).reshape(3, 3)
            tp = (d1 - d3) * torch.stack([x1, zero, -x3])
            cand_p = (s * (U @ Rp @ Vt), U @ tp)
            # case d' = -d2
            sp = (d1 + d3) * x1 * x3 / d2s
            cp = (d3 * x1 * x1 - d1 * x3 * x3) / d2s
            Rn = torch.stack([cp, zero, sp, zero, -one, zero, sp, zero, -cp]).reshape(3, 3)
            tn = (d1 + d3) * torch.stack([x1, zero, x3])
            cand_n = (s * (U @ Rn @ Vt), U @ tn)
            for R, t in (cand_p, cand_n):
                t = t / torch.clamp_min(torch.linalg.vector_norm(t), 1e-12)
                out.append(lie.se3(lie.quat_from_matrix(R), t))
    return torch.stack(out)


def _nanmedian(x):
    """``jnp.nanmedian``: linear interpolation between the two middle values
    of the non-NaN entries (``torch.nanmedian`` takes the lower one)."""
    v = torch.sort(x).values                     # NaNs sort last
    n = torch.sum(~torch.isnan(x)).to(x.dtype)
    q = 0.5 * (n - 1.0)
    lo, hi = torch.floor(q), torch.ceil(q)
    last = x.shape[0] - 1
    v_lo = v[torch.clamp(lo, 0, last).long()]
    v_hi = v[torch.clamp(hi, 0, last).long()]
    return v_lo * (1.0 - (q - lo)) + v_hi * (q - lo)


def sample_logits(valid):
    """The sampling logits of the hypotheses: uniform over the valid rows."""
    probs = valid.to(torch.float32)
    probs = probs / torch.clamp_min(torch.sum(probs), 1.0)
    return torch.log(torch.clamp_min(probs, 1e-12))


def two_view_init(draw, ray1, ray2, valid, *, n_hyp: int = 256, **kw):
    """Estimate relative pose + structure from matched rays, drawing the
    ``n_hyp`` 8-row index sets with ``draw(logits, (n_hyp, 8))``.  See
    ``two_view_init_from`` for the rest."""
    idx = draw(sample_logits(valid), (n_hyp, 8)).to(ray1.device)
    return two_view_init_from(idx, ray1, ray2, valid, **kw)


def two_view_init_from(idx, ray1, ray2, valid, *, focal: float = 525.0,
                       px_thresh: float = 2.0, min_inliers: int = 50,
                       min_parallax_deg: float = 0.4):
    """Two-view initialisation from given hypothesis index sets.

    Args:
      idx: [H, 8] row indices of each hypothesis (its first 4 rows also
        seed a homography).
      ray1, ray2: [N, 3] normalized camera rays of the matches.
      valid: [N] bool.
      focal, px_thresh: the Sampson inlier gate is (px_thresh/focal)^2,
        stated in pixels.
    """
    from . import ba

    dev, f32 = ray1.device, torch.float32
    n = ray1.shape[0]
    idx = idx.long()
    sampson_thresh = (torch.tensor(px_thresh, dtype=f32) / torch.tensor(focal, dtype=f32)) ** 2
    sampson_thresh = sampson_thresh.to(dev)

    Es = _eight_point(ray1[idx], ray2[idx])                       # [H,3,3]
    inl = (_sampson_err(Es, ray1, ray2) < sampson_thresh) & valid[None, :]
    best = torch.argmax(torch.sum(inl.to(torch.int32), dim=-1))
    E = _to_essential(Es[best])

    # homography model from the first 4 rows of the same draws; symmetric
    # transfer error is 2-dof against Sampson's 1-dof
    h_thresh = sampson_thresh * (5.991 / 3.841)
    Hs = _four_point_h(ray1[idx[:, :4]], ray2[idx[:, :4]])
    inl_h = (_sym_transfer_err(Hs, ray1, ray2) < h_thresh) & valid[None, :]
    best_h = torch.argmax(torch.sum(inl_h.to(torch.int32), dim=-1))
    Hmat = Hs[best_h]

    # weighted least-squares refinement on each consensus set, 2 rounds
    for _ in range(2):
        w = ((_sampson_err(E, ray1, ray2) < sampson_thresh) & valid).to(f32)
        E = _to_essential(_eight_point(ray1, ray2, w))
    for _ in range(2):
        w = ((_sym_transfer_err(Hmat, ray1, ray2) < h_thresh) & valid).to(f32)
        Hmat = _four_point_h(ray1, ray2, w)

    # model selection on truncated-quadratic scores (RH = SH/(SH+SE) > 0.40)
    e_h = _sym_transfer_err(Hmat, ray1, ray2) / h_thresh
    e_e = _sampson_err(E, ray1, ray2) / sampson_thresh
    SH = torch.sum(torch.where(valid & (e_h < 1.0), 1.0 - e_h, 0.0))
    SE = torch.sum(torch.where(valid & (e_e < 1.0), 1.0 - e_e, 0.0))
    prefer_h = SH > 0.40 * (SH + SE)

    cands = torch.cat([_decompose_E(E), _decompose_H(Hmat)], dim=0)   # [12,7]
    cand_is_h = torch.arange(12, device=dev) >= 4
    inl_of_model = torch.stack([e_e < 1.0, e_h < 1.0])               # [2,N]
    T1 = lie.se3_identity(device=dev).expand(n, 7)
    Xs = triangulation.triangulate_dlt(T1[None], cands[:, None, :].expand(12, n, 7),
                                       ray1[None], ray2[None])        # [12,N,3]
    z2 = lie.se3_apply(cands[:, None, :], Xs)[..., 2]
    goods = (valid[None] & (Xs[..., 2] > 1e-3) & (z2 > 1e-3)
             & inl_of_model[cand_is_h.long()])
    counts = torch.sum(goods.to(torch.int32), dim=-1)

    def pick(active, ratio):
        c = torch.where(active, counts, -1)
        cs = torch.sort(c).values
        distinct = cs[-1].to(f32) > ratio * torch.clamp_min(cs[-2].to(f32), 0.0)
        return torch.argmax(c), distinct

    bi_e, distinct_e = pick(~cand_is_h, 1.7)
    bi_h, distinct_h = pick(cand_is_h, 1.0 / 0.75)
    # cross-model fallback: an ambiguous preferred model yields to a clearly
    # dominant other one
    use_h = torch.where(prefer_h, distinct_h | ~distinct_e, distinct_h & ~distinct_e)
    distinct = torch.where(use_h, distinct_h, distinct_e)
    bi = torch.where(use_h, bi_h, bi_e)
    T_21 = cands[bi]
    X = Xs[bi]
    good = goods[bi]

    # two-view BA on the reprojection error in normalized coordinates
    # (K = identity, view 1 fixed)
    poses2 = torch.stack([lie.se3_identity(device=dev), T_21])
    x1n = ray1[:, :2] / ray1[:, 2:3]
    x2n = ray2[:, :2] / ray2[:, 2:3]
    conf = good.to(f32) * (torch.tensor(focal, dtype=f32, device=dev) ** 2)
    rows = torch.arange(n, device=dev)
    bres = ba.bundle_adjust(
        torch.tensor([1.0, 1.0, 0.0, 0.0], dtype=f32, device=dev), poses2, X,
        torch.cat([torch.zeros(n, dtype=torch.long, device=dev),
                   torch.ones(n, dtype=torch.long, device=dev)]),
        torch.cat([rows, rows]), torch.cat([x1n, x2n]), torch.cat([conf, conf]),
        torch.tensor([False, True], device=dev), good, n_iters=8,
    )
    T_21 = bres.poses[1]
    X = bres.points
    gscale = 1.0 / torch.clamp_min(torch.linalg.vector_norm(T_21[4:7]), 1e-9)
    T_21 = lie.se3(T_21[:4], T_21[4:7] * gscale)
    X = X * gscale
    good = good & bres.inlier_obs[:n] & bres.inlier_obs[n:]
    z2 = lie.se3_apply(T_21.expand(n, 7), X)[:, 2]
    good = good & (X[:, 2] > 1e-3) & (z2 > 1e-3)

    # aggregate parallax gate
    c2 = lie.se3_t(lie.se3_inverse(T_21))
    d2 = X - c2
    cosp = torch.sum(X * d2, -1) / torch.clamp_min(
        torch.linalg.vector_norm(X, dim=-1) * torch.linalg.vector_norm(d2, dim=-1), 1e-12)
    min_parallax_cos = torch.cos(torch.deg2rad(torch.tensor(min_parallax_deg, dtype=f32)))
    n_parallax = torch.sum((good & (cosp < min_parallax_cos.to(dev))).to(torch.int32))

    n_inl = torch.sum(good.to(torch.int32))
    ok = (n_inl >= min_inliers) & distinct & (n_parallax >= min_inliers // 8)

    # normalize the scene scale: median inlier depth -> 1
    med = _nanmedian(torch.where(good, X[:, 2], float("nan")))
    scale = torch.where(torch.isfinite(med) & (med > 1e-6), 1.0 / med, 1.0)
    X = X * scale
    T_21 = lie.se3(T_21[:4], T_21[4:] * scale)
    return TwoViewResult(T_21=T_21, points=X, inliers=good, n_inliers=n_inl, ok=ok)
