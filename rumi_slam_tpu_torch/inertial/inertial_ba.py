"""Visual-inertial optimization problems (port of
``rumi_slam_tpu/inertial/inertial_ba.py``), the reference's inertial g2o
problems (Optimizer.cc):

* ``inertial_only_optimization``  — InertialOptimization (:3340/:3512/:3664):
  gravity direction + scale + per-KF velocities + one shared bias from
  preintegrated deltas, visual poses held fixed (the IMU-initialization step).
* ``pose_inertial_optimization``  — PoseInertialOptimizationLastKeyFrame /
  LastFrame (:4675/:5031): motion-only optimization of the current frame's
  pose/velocity/bias against reprojection edges plus one inertial edge to the
  (fixed) previous state, with bias random-walk priors.
* ``visual_inertial_ba``          — FullInertialBA (:352) / LocalInertialBA
  (:2745): a temporal KF window with reprojection + inertial + bias-walk
  edges, optimized jointly over poses/velocities/biases and map points.

Each problem is a fixed-shape residual stack whose Gauss-Newton / LM system
is dense (windows are small; the reference's LocalInertialBA caps the window
at 10 temporal KFs); map points move by batched 3x3 point steps.  Inertial
residuals are whitened by the preintegrated covariance (Cholesky of the 9x9
information), bias-walk residuals by ``cov_walk``.

The JAX package takes the Jacobians with ``jax.jacfwd`` inside ``lax.scan``.
Here ``jacobian`` uses ``optim.pose_graph.tangent_jacobians``: one
forward-mode pass whose tangent has a leading axis of basis directions, one
per unknown; the residual functions broadcast over it.  The iterations are a
Python loop whose accept/reject is a ``torch.where``, so nothing waits for
the card inside the loop.  Everything follows the device of the inputs.

States are body poses T_wb (hamilton quat + position) + velocity; the camera
extrinsic T_cb maps body to camera for the reprojection terms.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import camera, lie
from ..optim import robust
from ..optim.ba import _inv3x3
from ..optim.pose_graph import tangent_jacobians
from . import preintegration as P

CHI2_MONO = 5.991


def _whiten(cov, eps=1e-6):
    """Cholesky factor W of the information matrix: W^T r is the whitened
    residual (r^T inv(cov) r == |W^T r|^2).

    ``eps`` floors the covariance eigenvalues, capping the information at
    1/eps — necessary in float32 when mixing near-noiseless preintegration
    rows (cov ~ 1e-8) with unit-weight pixel rows in one Gauss-Newton system
    (the reference runs g2o in float64 and does not need this)."""
    n = cov.shape[-1]
    info = torch.linalg.inv(cov + eps * torch.eye(n, dtype=cov.dtype, device=cov.device))
    # symmetrize before cholesky for numerical safety
    info = 0.5 * (info + info.transpose(-1, -2))
    return torch.linalg.cholesky(info)


def _wt(W, r):
    """W^T r over leading axes."""
    return (W.transpose(-1, -2) @ r[..., None])[..., 0]


def stack_preintegrated(pres: list[P.Preintegrated]) -> P.Preintegrated:
    """Stack a python list of Preintegrated into one batched tuple [E, ...]."""
    bias = P.ImuBias(torch.stack([p.bias.bg for p in pres]),
                     torch.stack([p.bias.ba for p in pres]))
    return P.Preintegrated(
        *(torch.stack([getattr(p, f) for p in pres]) for f in P.Preintegrated._fields[:-1]),
        bias)


def jacobian(residuals, theta):
    """(r, J) of ``residuals`` at ``theta`` [n]: ``jax.jacfwd``'s counterpart,
    by forward-mode AD over n basis directions (``residuals`` must broadcast
    over a leading axis of ``theta``)."""
    r, (J,) = tangent_jacobians(lambda tau: residuals(theta + tau), [theta.shape[-1]], (),
                                dtype=theta.dtype, device=theta.device)
    return r, J


def _lm_damp(H, lam):
    return H + lam * torch.diag(torch.clamp_min(torch.diagonal(H), 1e-6))


def _lm_update(accept, lam):
    return torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-10, 1e6)


class InertialInit(NamedTuple):
    """Result of inertial-only optimization (reference InertialOptimization)."""

    scale: torch.Tensor       # [] visual-to-metric scale
    q_wg: torch.Tensor        # [4] gravity rotation: g_world = R(q_wg) @ (0,0,-9.81)
    velocities: torch.Tensor  # [N,3] body velocities in world
    bias: P.ImuBias
    cost: torch.Tensor


def inertial_only_problem(q_wb, p_wb, pres: P.Preintegrated, *, fix_scale: bool = False,
                          prior_bias_info: float = 1e2):
    """(unpack, residuals) of ``inertial_only_optimization`` over its unknown
    theta = (gravity tilt [2], log scale, velocities [3N], bg, ba)."""
    N = q_wb.shape[0]
    g0 = P.gravity_vector(q_wb)
    W = _whiten(pres.cov)                                     # [N-1, 9, 9]

    def unpack(theta):
        phi_g = torch.cat([theta[..., 0:2], torch.zeros_like(theta[..., :1])], -1)  # yaw unobservable
        v = theta[..., 3:3 + 3 * N].reshape(theta.shape[:-1] + (N, 3))
        bias = P.ImuBias(theta[..., 3 + 3 * N:6 + 3 * N], theta[..., 6 + 3 * N:9 + 3 * N])
        s = torch.ones_like(theta[..., 2]) if fix_scale else torch.exp(theta[..., 2])
        return phi_g, s, v, bias

    def residuals(theta):
        phi_g, s, v, bias = unpack(theta)
        g = lie.quat_rotate(lie.so3_exp(phi_g), g0)[..., None, :]
        p = s[..., None, None] * p_wb
        b = P.ImuBias(bias.bg[..., None, :], bias.ba[..., None, :])
        r = P.inertial_residual(pres, q_wb[:-1], p[..., :-1, :], v[..., :-1, :],
                                q_wb[1:], p[..., 1:, :], v[..., 1:, :], b, gravity=g)
        r_in = _wt(W, r).reshape(theta.shape[:-1] + (-1,))
        # weak bias prior (reference adds EdgePriorGyro/Acc in init)
        r_b = prior_bias_info ** 0.5 * torch.cat([bias.bg, bias.ba], -1)
        return torch.cat([r_in, r_b], -1)

    return unpack, residuals


def inertial_only_optimization(q_wb, p_wb, pres: P.Preintegrated, *, n_iters: int = 20,
                               fix_scale: bool = False,
                               prior_bias_info: float = 1e2) -> InertialInit:
    """Solve gravity direction, scale, velocities, and one shared bias with
    the visual poses fixed — the reference's InertialOptimization
    (Optimizer.cc:3340: VertexGDir + VertexScale + velocity/bias vertices,
    all pose vertices fixed).  ``q_wb`` [N,4], ``p_wb`` [N,3] up to scale,
    ``pres`` batched [N-1] deltas i -> i+1."""
    dev = q_wb.device
    unpack, residuals = inertial_only_problem(q_wb, p_wb, pres, fix_scale=fix_scale,
                                              prior_bias_info=prior_bias_info)
    theta = torch.zeros(9 + 3 * q_wb.shape[0], dtype=torch.float32, device=dev)
    lam = torch.tensor(1e-4, dtype=torch.float32, device=dev)
    for _ in range(n_iters):
        r, J = jacobian(residuals, theta)
        H = _lm_damp(J.T @ J, lam)
        cand = theta - torch.linalg.solve(H, J.T @ r)
        accept = torch.sum(residuals(cand) ** 2) < torch.sum(r * r)
        theta = torch.where(accept, cand, theta)
        lam = _lm_update(accept, lam)
    phi_g, s, v, bias = unpack(theta)
    return InertialInit(scale=s, q_wg=lie.so3_exp(phi_g), velocities=v, bias=bias,
                        cost=torch.sum(residuals(theta) ** 2))


class PoseVIResult(NamedTuple):
    q_wb: torch.Tensor
    p_wb: torch.Tensor
    v: torch.Tensor
    bias: P.ImuBias
    n_inliers: torch.Tensor


def _camera_points(T_cb, q, p, X_w):
    """Camera-frame points of ``X_w`` seen from body pose (q, p)."""
    T_cw = lie.se3_compose(T_cb, lie.se3_inverse(lie.se3(q, p)))
    return lie.se3_apply(T_cw, X_w)


def pose_inertial_problem(K, T_cb, q_wb_prev, p_wb_prev, v_prev, pre: P.Preintegrated,
                          q_wb, p_wb, v, bias: P.ImuBias, X_w, uv, valid, gravity=None):
    """(unpack, residuals) of ``pose_inertial_optimization`` over its unknown
    theta = (rotation [3], position, velocity, bg, ba) increments."""
    g = P.gravity_vector(q_wb) if gravity is None else gravity
    W_in = _whiten(pre.cov)
    W_walk = _whiten(pre.cov_walk)
    validf = valid.to(torch.float32)

    def unpack(theta):
        q = lie.quat_normalize(lie.quat_mul(q_wb, lie.so3_exp(theta[..., 0:3])))
        p = p_wb + theta[..., 3:6]
        vv = v + theta[..., 6:9]
        b = P.ImuBias(bias.bg + theta[..., 9:12], bias.ba + theta[..., 12:15])
        return q, p, vv, b

    def residuals(theta):
        q, p, vv, b = unpack(theta)
        r_in = _wt(W_in, P.inertial_residual(pre, q_wb_prev, p_wb_prev, v_prev, q, p, vv, b,
                                             gravity=g))
        # bias random walk from the linearization bias
        r_walk = _wt(W_walk, torch.cat([b.bg - pre.bias.bg, b.ba - pre.bias.ba], -1))
        # reprojection (camera pose from body pose)
        pc = _camera_points(T_cb, q[..., None, :], p[..., None, :], X_w)
        r_uv = camera.project(K, pc) - uv
        chi2 = torch.sum(r_uv * r_uv, dim=-1)
        w = torch.sqrt(validf * robust.huber_weight(chi2, CHI2_MONO) * (pc[..., 2] > 0.05))
        return torch.cat([r_in, r_walk, (w[..., None] * r_uv).flatten(-2)], -1)

    return unpack, residuals


def pose_inertial_optimization(K, T_cb, q_wb_prev, p_wb_prev, v_prev, pre: P.Preintegrated,
                               q_wb, p_wb, v, bias: P.ImuBias, X_w, uv, valid, *,
                               n_iters: int = 10, gravity=None) -> PoseVIResult:
    """Motion-only visual-inertial optimization of the CURRENT frame given a
    fixed previous state — reference PoseInertialOptimizationLastKeyFrame /
    LastFrame (Optimizer.cc:4675/:5031): reprojection edges + EdgeInertial +
    gyro/acc random-walk edges weighted by the preintegration covariances.
    ``X_w`` [M,3] world points seen at ``uv`` [M,2], ``valid`` [M] bool."""
    unpack, residuals = pose_inertial_problem(K, T_cb, q_wb_prev, p_wb_prev, v_prev, pre,
                                              q_wb, p_wb, v, bias, X_w, uv, valid, gravity)
    theta = torch.zeros(15, dtype=torch.float32, device=q_wb.device)
    lam = torch.tensor(1e-3, dtype=torch.float32, device=q_wb.device)
    eye = torch.eye(15, dtype=torch.float32, device=q_wb.device)
    for _ in range(n_iters):
        r, J = jacobian(residuals, theta)
        cand = theta - torch.linalg.solve(J.T @ J + lam * eye, J.T @ r)
        accept = torch.sum(residuals(cand) ** 2) < torch.sum(r * r)
        theta = torch.where(accept, cand, theta)
        lam = _lm_update(accept, lam)
    q, p, vv, b = unpack(theta)
    pc = _camera_points(T_cb, q, p, X_w)
    err = torch.sum((camera.project(K, pc) - uv) ** 2, dim=-1)
    n_in = torch.sum(valid & (err <= CHI2_MONO) & (pc[:, 2] > 0.05))
    return PoseVIResult(q_wb=q, p_wb=p, v=vv, bias=b, n_inliers=n_in)


class VIBAResult(NamedTuple):
    q_wb: torch.Tensor   # [N,4]
    p_wb: torch.Tensor   # [N,3]
    v: torch.Tensor      # [N,3]
    bg: torch.Tensor     # [N,3]
    ba: torch.Tensor     # [N,3]
    points: torch.Tensor  # [Pt,3]
    cost: torch.Tensor   # the last iteration's candidate motion cost, as in JAX
    cost0: torch.Tensor  # the motion cost at the initial state (the port's addition)


def vi_ba_problem(K, T_cb, pres: P.Preintegrated, cam_idx, pt_idx, uv, conf, kf_free,
                  pt_free, gravity=None):
    """(unpack, motion_residuals, motion_jacobian, point_step) of
    ``visual_inertial_ba``: ``motion_residuals(theta, q0, p0, v0, bg0, ba0,
    pts)`` over the stacked motion increments theta [15N] at the state (q0
    ... ba0) and points ``pts``; ``motion_jacobian(q0, ..., pts)`` its value
    and Jacobian at theta = 0; ``point_step(q, p, pts)`` the batched 3x3
    point update.

    The JAX package differentiates every row with respect to all 15N
    unknowns.  Here only the inertial and bias-walk rows do; each
    reprojection row depends on its keyframe's rotation and position alone,
    so those rows take forward-mode AD over 6 directions per observation and
    land in their keyframe's columns.  The matrix is the same; the work on
    the reprojection rows falls by 15N / 6."""
    g = P.gravity_vector(pres.dv) if gravity is None else gravity
    N, dev = pres.dv.shape[0] + 1, pres.dv.device
    kf_freef = kf_free.to(torch.float32)
    W_in = _whiten(pres.cov)           # [N-1,9,9]
    W_walk = _whiten(pres.cov_walk)    # [N-1,6,6]
    cam_idx = torch.clamp(cam_idx.long(), 0, N - 1)
    pt_idx = pt_idx.long()
    O = cam_idx.shape[0]

    def unpack(theta, q0, p0, v0, bg0, ba0):
        th = theta.reshape(theta.shape[:-1] + (N, 15)) * kf_freef[:, None]
        q = lie.quat_normalize(lie.quat_mul(q0, lie.so3_exp(th[..., 0:3])))
        return q, p0 + th[..., 3:6], v0 + th[..., 6:9], bg0 + th[..., 9:12], ba0 + th[..., 12:15]

    def edge_residuals(theta, q0, p0, v0, bg0, ba0):
        q, p, vv, bgs, bas = unpack(theta, q0, p0, v0, bg0, ba0)
        r_in = _wt(W_in, P.inertial_residual(
            pres, q[..., :-1, :], p[..., :-1, :], vv[..., :-1, :], q[..., 1:, :],
            p[..., 1:, :], vv[..., 1:, :], P.ImuBias(bgs[..., :-1, :], bas[..., :-1, :]),
            gravity=g))
        db = torch.cat([bgs[..., 1:, :] - bgs[..., :-1, :], bas[..., 1:, :] - bas[..., :-1, :]], -1)
        return torch.cat([r_in, _wt(W_walk, db)], -1).flatten(-2)

    def visual_residuals(q_obs, p_obs, pts):
        """[..., O, 2] weighted reprojection rows from each observation's
        keyframe orientation and position."""
        pc = _camera_points(T_cb, q_obs, p_obs, pts[torch.clamp(pt_idx, 0, pts.shape[0] - 1)])
        r_uv = camera.project(K, pc) - uv
        chi2 = torch.sum(r_uv * r_uv, dim=-1) * conf
        w = torch.sqrt(conf * robust.huber_weight(chi2, CHI2_MONO) * (pc[..., 2] > 0.05))
        return w[..., None] * r_uv

    def motion_residuals(theta, q0, p0, v0, bg0, ba0, pts):
        q, p, _, _, _ = unpack(theta, q0, p0, v0, bg0, ba0)
        r_uv = visual_residuals(q[..., cam_idx, :], p[..., cam_idx, :], pts)
        return torch.cat([edge_residuals(theta, q0, p0, v0, bg0, ba0), r_uv.flatten(-2)], -1)

    def motion_jacobian(q0, p0, v0, bg0, ba0, pts):
        theta0 = torch.zeros(N * 15, dtype=torch.float32, device=dev)
        r_e, J_e = jacobian(lambda th: edge_residuals(th, q0, p0, v0, bg0, ba0), theta0)
        free = kf_freef[cam_idx][:, None]

        def obs_rows(tau):                 # tau [6, O, 6]: (rotation, position)
            tau = tau * free
            q = lie.quat_normalize(lie.quat_mul(q0[cam_idx], lie.so3_exp(tau[..., 0:3])))
            return visual_residuals(q, p0[cam_idx] + tau[..., 3:6], pts)

        r_v, (J_v,) = tangent_jacobians(obs_rows, [6], (O,), dtype=torch.float32, device=dev)
        cols = (cam_idx * 15)[:, None] + torch.arange(6, device=dev)        # [O, 6]
        J_uv = torch.zeros((O, 2, N * 15), dtype=torch.float32, device=dev).scatter_(
            2, cols[:, None, :].expand(O, 2, 6), J_v)
        return torch.cat([r_e, r_v.flatten()]), torch.cat([J_e, J_uv.reshape(2 * O, N * 15)])

    def point_step(q, p, pts):
        """Batched GN update of points with poses fixed (3x3 solves)."""
        Pt = pts.shape[0]
        pi = torch.clamp(pt_idx, 0, Pt - 1)
        T_cw = lie.se3_compose(T_cb, lie.se3_inverse(lie.se3(q, p)))
        r, _, Jp, depth = camera.reproj_residual_and_jacobians(K, T_cw[cam_idx], pts[pi], uv)
        chi2 = torch.sum(r * r, dim=-1) * conf
        w = conf * robust.huber_weight(chi2, CHI2_MONO) * (depth > 0.05)
        Hpp = torch.zeros((Pt, 3, 3), dtype=pts.dtype, device=dev).index_add_(
            0, pi, torch.einsum("oki,o,okj->oij", Jp, w, Jp))
        bp = torch.zeros((Pt, 3), dtype=pts.dtype, device=dev).index_add_(
            0, pi, torch.einsum("oki,o,ok->oi", Jp, w, r))
        Hpp = Hpp + 1e-6 * torch.eye(3, dtype=pts.dtype, device=dev)
        dxp = -torch.einsum("pij,pj->pi", _inv3x3(Hpp), bp)
        return pts + dxp * pt_free[:, None].to(pts.dtype)

    return unpack, motion_residuals, motion_jacobian, point_step


def visual_inertial_ba(K, T_cb, q_wb, p_wb, v, bg, ba, pres: P.Preintegrated, points,
                       cam_idx, pt_idx, uv, conf, kf_free, pt_free, *, n_iters: int = 8,
                       gravity=None) -> VIBAResult:
    """Windowed visual-inertial BA — reference FullInertialBA (:352) /
    LocalInertialBA (:2745): per-KF pose/velocity/bias states joined by
    inertial + bias-random-walk edges, reprojection edges to map points.

    Solved by block-coordinate LM: a dense GN step on the stacked motion
    states (15 dof per KF) alternating with batched 3x3 point updates — the
    same camera/point elimination ordering as the Schur solver in optim.ba,
    with the motion block solved exactly.  ``q_wb, p_wb, v, bg, ba`` [N,...];
    ``pres`` batched [N-1], linearized at KF i's bias; observations
    ``cam_idx, pt_idx, uv, conf`` as in ``optim.ba``."""
    unpack, motion_residuals, motion_jacobian, point_step = vi_ba_problem(
        K, T_cb, pres, cam_idx, pt_idx, uv, conf, kf_free, pt_free, gravity)
    kf_freef = kf_free.to(torch.float32)
    fixed = torch.diag(torch.repeat_interleave(1.0 - kf_freef, 15))
    lam = torch.tensor(1e-3, dtype=torch.float32, device=q_wb.device)
    q, p, vv, bgs, bas, pts = q_wb, p_wb, v, bg, ba, points
    cost0 = cost = None
    for _ in range(n_iters):
        state = (q, p, vv, bgs, bas)
        r, J = motion_jacobian(*state, pts)
        # pin fixed KFs (rows zeroed by the kf_free mask in unpack; keep H SPD)
        H = _lm_damp(J.T @ J, lam) + fixed
        d = -torch.linalg.solve(H, J.T @ r)
        c0 = torch.sum(r * r)
        cost = torch.sum(motion_residuals(d, *state, pts) ** 2)
        cost0 = c0 if cost0 is None else cost0
        accept = cost < c0
        d = torch.where(accept, d, torch.zeros_like(d))
        lam = _lm_update(accept, lam)
        q, p, vv, bgs, bas = unpack(d, *state)
        pts = point_step(q, p, pts)
    return VIBAResult(q_wb=q, p_wb=p, v=vv, bg=bgs, ba=bas, points=pts, cost=cost,
                      cost0=cost0)
