# Frozen copy of rumi_slam_tpu_torch/geometry/lie.py at commit 359566b (plain PyTorch,
# no kernel): the benchmark's reference.  Imports made relative; no other change.
"""SO(3), SE(3) and Sim(3) as plain tensor functions (port of
``rumi_slam_tpu/geometry/lie.py``).

Storage conventions are the JAX package's:

* quaternion ``q``: ``[..., 4]`` in (w, x, y, z) Hamilton convention, unit norm.
* SE(3) ``T``:      ``[..., 7]`` = concat(q, t).  ``T @ x = R x + t``.
* Sim(3) ``S``:     ``[..., 8]`` = concat(q, t, log_s).  ``S @ x = s R x + t``.
* tangents: SO(3) ``[..., 3]`` (omega), SE(3) ``[..., 6]`` = (omega, v),
  Sim(3) ``[..., 7]`` = (omega, v, sigma).

Every function works on the trailing axes and broadcasts over leading ones.
Poses follow the ``Tcw`` convention (world -> camera) unless a name says
otherwise.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _safe_norm(x, dim=-1, keepdim=False):
    """||x|| with a well-defined (zero) gradient at x = 0 (double-where: the
    sqrt never sees 0, so autograd through exp/log at tau = 0 stays finite)."""
    n2 = torch.sum(x * x, dim=dim, keepdim=keepdim)
    small = n2 < 1e-24
    n2_safe = torch.where(small, torch.ones_like(n2), n2)
    return torch.where(small, torch.zeros_like(n2), torch.sqrt(n2_safe))


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


# ---------------------------------------------------------------------------
# quaternion / SO(3)
# ---------------------------------------------------------------------------

def quat_identity(dtype=torch.float32, device="cpu"):
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


def quat_normalize(q):
    return q / torch.clamp_min(torch.linalg.vector_norm(q, dim=-1, keepdim=True), _EPS)


def quat_mul(a, b):
    """Hamilton product a*b, shapes [..., 4]."""
    aw, ax, ay, az = torch.unbind(a, -1)
    bw, bx, by, bz = torch.unbind(b, -1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_conj(q):
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def quat_rotate(q, v):
    """Rotate vectors v [..., 3] by unit quaternions q [..., 4]."""
    qv = q[..., 1:]
    w = q[..., :1]
    t = 2.0 * _cross(qv, v)
    return v + w * t + _cross(qv, t)


def quat_to_matrix(q):
    w, x, y, z = torch.unbind(q, -1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def quat_from_matrix(R):
    """Rotation matrix [..., 3, 3] -> unit quaternion [..., 4], w >= 0
    (numerically stable 4-branch construction, selected per element)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    s0 = torch.sqrt(torch.clamp_min(1.0 + tr, _EPS)) * 2.0
    q0 = torch.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0], -1)
    s1 = torch.sqrt(torch.clamp_min(1.0 + m00 - m11 - m22, _EPS)) * 2.0
    q1 = torch.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1], -1)
    s2 = torch.sqrt(torch.clamp_min(1.0 - m00 + m11 - m22, _EPS)) * 2.0
    q2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2], -1)
    s3 = torch.sqrt(torch.clamp_min(1.0 - m00 - m11 + m22, _EPS)) * 2.0
    q3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3], -1)

    cond0 = tr > 0.0
    cond1 = (m00 >= m11) & (m00 >= m22)
    cond2 = m11 >= m22
    q = torch.where(
        cond0[..., None],
        q0,
        torch.where(cond1[..., None], q1, torch.where(cond2[..., None], q2, q3)),
    )
    q = torch.where(q[..., :1] < 0, -q, q)
    return quat_normalize(q)


def so3_exp(omega):
    """Axis-angle [..., 3] -> quaternion [..., 4]."""
    theta = _safe_norm(omega, keepdim=True)
    half = 0.5 * theta
    small = theta < 1e-6
    k = torch.where(small, 0.5 - theta * theta / 48.0,
                    torch.sin(half) / torch.clamp_min(theta, _EPS))
    w = torch.cos(half)
    return torch.cat([w, k * omega], dim=-1)


def so3_log(q):
    """Unit quaternion [..., 4] -> axis-angle [..., 3]."""
    q = torch.where(q[..., :1] < 0, -q, q)
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    v = q[..., 1:]
    n = _safe_norm(v, keepdim=True)
    theta = 2.0 * torch.atan2(n[..., 0], w)[..., None]
    small = n < 1e-7
    k = torch.where(small, 2.0 / torch.clamp_min(w[..., None], _EPS),
                    theta / torch.clamp_min(n, _EPS))
    return k * v


def hat(omega):
    """[..., 3] -> skew matrices [..., 3, 3]."""
    ox, oy, oz = torch.unbind(omega, -1)
    zero = torch.zeros_like(ox)
    m = torch.stack([zero, -oz, oy, oz, zero, -ox, -oy, ox, zero], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


# ---------------------------------------------------------------------------
# SE(3)
# ---------------------------------------------------------------------------

def se3_identity(dtype=torch.float32, device="cpu"):
    return torch.tensor([1.0, 0, 0, 0, 0, 0, 0], dtype=dtype, device=device)


def se3(q, t):
    return torch.cat([q, t], dim=-1)


def se3_q(T):
    return T[..., :4]


def se3_t(T):
    return T[..., 4:7]


def se3_apply(T, x):
    """Apply [..., 7] to points [..., 3]."""
    return quat_rotate(T[..., :4], x) + T[..., 4:7]


def se3_compose(A, B):
    """A after B:  (A*B) @ x = A @ (B @ x)."""
    q = quat_mul(A[..., :4], B[..., :4])
    t = quat_rotate(A[..., :4], B[..., 4:7]) + A[..., 4:7]
    return se3(quat_normalize(q), t)


def se3_inverse(T):
    qi = quat_conj(T[..., :4])
    return se3(qi, -quat_rotate(qi, T[..., 4:7]))


def _so3_left_jacobian(omega):
    """V matrix of SE(3) exp: t = V v.  [..., 3] -> [..., 3, 3]."""
    theta = _safe_norm(omega)
    th2 = theta * theta
    small = theta < 1e-5
    A = torch.where(small, 0.5 - th2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.clamp_min(th2, _EPS))
    B = torch.where(small, 1.0 / 6.0 - th2 / 120.0,
                    (theta - torch.sin(theta)) / torch.clamp_min(th2 * theta, _EPS))
    W = hat(omega)
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand(W.shape)
    return eye + A[..., None, None] * W + B[..., None, None] * (W @ W)


def se3_exp(tau):
    """Tangent [..., 6] = (omega, v) -> SE(3) [..., 7]."""
    omega, v = tau[..., :3], tau[..., 3:6]
    q = so3_exp(omega)
    V = _so3_left_jacobian(omega)
    t = torch.einsum("...ij,...j->...i", V, v)
    return se3(q, t)


def se3_log(T):
    """SE(3) [..., 7] -> tangent [..., 6] = (omega, v)."""
    omega = so3_log(T[..., :4])
    V = _so3_left_jacobian(omega)
    v = torch.linalg.solve(V, T[..., 4:7, None])[..., 0]
    return torch.cat([omega, v], dim=-1)


def se3_to_matrix(T):
    R = quat_to_matrix(T[..., :4])
    t = T[..., 4:7]
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=T.dtype, device=T.device)
    bottom = bottom.expand(top.shape[:-2] + (4,))[..., None, :]
    return torch.cat([top, bottom], dim=-2)


def se3_from_matrix(M):
    return se3(quat_from_matrix(M[..., :3, :3]), M[..., :3, 3])


def se3_retract(T, tau):
    """Left-multiplicative update exp(tau) * T (the optimizers' LM update)."""
    return se3_compose(se3_exp(tau), T)


# ---------------------------------------------------------------------------
# Sim(3)
# ---------------------------------------------------------------------------

def sim3_identity(dtype=torch.float32, device="cpu"):
    return torch.tensor([1.0, 0, 0, 0, 0, 0, 0, 0.0], dtype=dtype, device=device)


def sim3_make(q, t, scale):
    """Build from rotation quat, translation, *linear* scale."""
    scale = torch.as_tensor(scale, dtype=q.dtype, device=q.device)
    return torch.cat([q, t, torch.log(scale)[..., None]], dim=-1)


def sim3_scale(S):
    return torch.exp(S[..., 7])


def sim3_apply(S, x):
    return sim3_scale(S)[..., None] * quat_rotate(S[..., :4], x) + S[..., 4:7]


def sim3_compose(A, B):
    """(A*B) @ x = A @ (B @ x)."""
    q = quat_normalize(quat_mul(A[..., :4], B[..., :4]))
    t = sim3_scale(A)[..., None] * quat_rotate(A[..., :4], B[..., 4:7]) + A[..., 4:7]
    log_s = A[..., 7] + B[..., 7]
    return torch.cat([q, t, log_s[..., None]], dim=-1)


def sim3_inverse(S):
    qi = quat_conj(S[..., :4])
    inv_s = torch.exp(-S[..., 7])
    t = -inv_s[..., None] * quat_rotate(qi, S[..., 4:7])
    return torch.cat([qi, t, -S[..., 7:8]], dim=-1)


def sim3_from_se3(T, scale=1.0):
    log_s = torch.log(torch.full(T.shape[:-1] + (1,), scale, dtype=T.dtype, device=T.device))
    return torch.cat([T, log_s], dim=-1)


def sim3_to_se3(S):
    """Drop the scale (keep rotation+translation)."""
    return S[..., :7]


def sim3_exp(tau):
    """Tangent [..., 7] = (omega, v, sigma) -> Sim(3) [..., 8], the closed
    form with the scale terms of the W matrix and their Taylor limits."""
    omega, v, sigma = tau[..., :3], tau[..., 3:6], tau[..., 6]
    q = so3_exp(omega)
    theta = _safe_norm(omega)
    s = torch.exp(sigma)

    W = hat(omega)
    W2 = W @ W
    eye = torch.eye(3, dtype=tau.dtype, device=tau.device).expand(W.shape)

    th2 = theta * theta
    sig2 = sigma * sigma
    small_sig = torch.abs(sigma) < 1e-5
    small_th = theta < 1e-5

    A = torch.where(small_sig, 1.0 + sigma / 2.0 + sig2 / 6.0,
                    (s - 1.0) / torch.where(small_sig, torch.ones_like(sigma), sigma))
    denom = (sig2 + th2) * torch.clamp_min(theta, _EPS)
    sin_th, cos_th = torch.sin(theta), torch.cos(theta)
    a_ = s * sin_th
    b_ = s * cos_th
    B_gen = (a_ * sigma + (1.0 - b_) * theta) / torch.clamp_min(denom, _EPS)
    C_gen = (A - ((b_ - 1.0) * sigma + a_ * theta) / torch.clamp_min(sig2 + th2, _EPS)) \
        / torch.clamp_min(th2, _EPS)
    B_sig0 = torch.where(small_th, 0.5 - th2 / 24.0, (1.0 - cos_th) / torch.clamp_min(th2, _EPS))
    C_sig0 = torch.where(small_th, 1.0 / 6.0 - th2 / 120.0,
                         (theta - sin_th) / torch.clamp_min(th2 * theta, _EPS))
    B_th0 = torch.where(small_sig, 0.5 + sigma / 6.0,
                        ((sigma - 1.0) * s + 1.0) / torch.clamp_min(sig2, _EPS))
    C_th0 = torch.where(small_sig, 1.0 / 6.0 + sigma / 24.0,
                        (s * (0.5 * sig2 - sigma + 1.0) - 1.0) / torch.clamp_min(sig2 * sigma, _EPS))
    B = torch.where(small_th, B_th0, torch.where(small_sig, B_sig0, B_gen))
    C = torch.where(small_th, C_th0, torch.where(small_sig, C_sig0, C_gen))

    Wm = A[..., None, None] * eye + B[..., None, None] * W + C[..., None, None] * W2
    t = torch.einsum("...ij,...j->...i", Wm, v)
    return torch.cat([q, t, sigma[..., None]], dim=-1)


def sim3_log(S):
    """Sim(3) [..., 8] -> tangent [..., 7], solving t = Wm v; the columns of
    Wm come from ``sim3_exp`` of the unit v basis."""
    omega = so3_log(S[..., :4])
    sigma = S[..., 7]
    eye = torch.eye(3, dtype=S.dtype, device=S.device)
    cols = [sim3_exp(torch.cat([omega, eye[i].expand(omega.shape), sigma[..., None]],
                               dim=-1))[..., 4:7] for i in range(3)]
    Wm = torch.stack(cols, dim=-1)
    v = torch.linalg.solve(Wm, S[..., 4:7, None])[..., 0]
    return torch.cat([omega, v, sigma[..., None]], dim=-1)


def sim3_retract(S, tau):
    return sim3_compose(sim3_exp(tau), S)
