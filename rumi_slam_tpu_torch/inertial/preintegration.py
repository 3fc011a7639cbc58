"""IMU preintegration (port of ``rumi_slam_tpu/inertial/preintegration.py``),
the reference's IMU::Preintegrated (ImuTypes.cc:106-421:
IntegrateNewMeasurement, delta-R/V/P accumulation, bias Jacobians
JRg/JVg/JVa/JPg/JPa, covariance propagation, and the first-order bias-update
corrections of GetDeltaRotation/Velocity/Position, ImuTypes.cc:296-344).

The JAX package scans the samples with ``lax.scan``; here a Python loop over
the samples is the plain form.  Every function broadcasts over leading axes,
so several keyframe intervals of equal sample count integrate in one loop
(``gyro [..., N, 3]``).  Padding rows (``dt == 0``) leave the state as it
was, through ``torch.where`` and not a host branch, so the loop never waits
for the card.  Everything is float32, as in the JAX package, and lives on
the device of the inputs.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geometry import lie

GRAVITY = (0.0, 0.0, -9.81)


def gravity_vector(like: torch.Tensor) -> torch.Tensor:
    """``GRAVITY`` as a float32 tensor on ``like``'s device."""
    return torch.tensor(GRAVITY, dtype=torch.float32, device=like.device)


class ImuBias(NamedTuple):
    """Gyro + accelerometer bias (reference IMU::Bias, ImuTypes.h)."""

    bg: torch.Tensor  # [..., 3]
    ba: torch.Tensor  # [..., 3]

    @classmethod
    def from_numpy(cls, b, device="cuda") -> "ImuBias":
        """From any (bg, ba) pair of arrays (the JAX package's ``ImuBias``),
        on the card unless ``device`` says otherwise."""
        return cls(*(torch.as_tensor(np.array(x), dtype=torch.float32, device=device)
                     for x in b))

    def to_numpy(self) -> "ImuBias":
        return ImuBias(*(x.detach().cpu().numpy() for x in self))


def zero_bias(dtype=torch.float32, device="cuda") -> ImuBias:
    """A zero bias on the card unless ``device`` says otherwise."""
    return ImuBias(torch.zeros(3, dtype=dtype, device=device),
                   torch.zeros(3, dtype=dtype, device=device))


class Preintegrated(NamedTuple):
    """Preintegrated IMU delta between two frames/keyframes: dR (as a
    quaternion), dV, dP, the five bias Jacobians, the 9x9 covariance of
    (phi, v, p), the bias random-walk covariance, total dt, and the
    linearization bias.  A leading axis stacks intervals."""

    dq: torch.Tensor  # [..., 4] quaternion of delta rotation body_i <- body_j
    dv: torch.Tensor  # [..., 3]
    dp: torch.Tensor  # [..., 3]
    JRg: torch.Tensor  # [..., 3, 3] d(dR)/d(bg)
    JVg: torch.Tensor  # [..., 3, 3]
    JVa: torch.Tensor  # [..., 3, 3]
    JPg: torch.Tensor  # [..., 3, 3]
    JPa: torch.Tensor  # [..., 3, 3]
    cov: torch.Tensor  # [..., 9, 9] order (phi, v, p)
    cov_walk: torch.Tensor  # [..., 6, 6] accumulated bias random-walk covariance
    dt: torch.Tensor  # [...] total time
    bias: ImuBias  # linearization point

    @classmethod
    def from_numpy(cls, pre, device="cuda") -> "Preintegrated":
        """From any tuple with these fields in this order (the JAX package's
        ``Preintegrated``, or ``to_numpy``'s result), on the card unless
        ``device`` says otherwise."""
        *fields, bias = pre
        return cls(*(torch.as_tensor(np.array(x), dtype=torch.float32, device=device)
                     for x in fields), ImuBias.from_numpy(bias, device))

    def to_numpy(self) -> "Preintegrated":
        """The same fields as numpy arrays; ``JaxPreintegrated(*p[:-1],
        JaxImuBias(*p[-1]))`` rebuilds the JAX package's tuple."""
        *fields, bias = self
        return Preintegrated(*(x.detach().cpu().numpy() for x in fields), bias.to_numpy())


def _mv(M, v):
    """Batched matrix-vector product [..., m, n] x [..., n] -> [..., m]."""
    return (M @ v[..., None])[..., 0]


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _right_jacobian_so3(phi):
    """Right Jacobian of SO(3) (reference RightJacobianSO3, ImuTypes.cc:74)."""
    theta2 = torch.sum(phi * phi, dim=-1)[..., None, None]
    theta = torch.sqrt(theta2 + 1e-24)
    W = lie.hat(phi)
    small = theta2 < 1e-10
    A = torch.where(small, 0.5, (1.0 - torch.cos(theta)) / (theta2 + 1e-24))
    B = torch.where(small, 1.0 / 6.0, (theta - torch.sin(theta)) / (theta2 * theta + 1e-24))
    return _eye(3, phi) - A * W + B * (W @ W)


def preintegrate(
    gyro,  # [..., N, 3] rad/s
    acc,   # [..., N, 3] m/s^2
    dt,    # [..., N] s (0 entries = padding, ignored)
    bias: ImuBias,
    *,
    gyro_noise: float = 1.7e-4,
    acc_noise: float = 2.0e-3,
    gyro_walk: float = 1.9e-5,
    acc_walk: float = 3.0e-3,
) -> Preintegrated:
    """Integrate a (padded) batch of IMU samples into one Preintegrated delta
    (per leading index).  Equivalent to looping
    IMU::Preintegrated::IntegrateNewMeasurement (ImuTypes.cc:184-294) over
    the samples.  Padding rows must have dt == 0 (they contribute nothing)."""
    gyro = torch.as_tensor(gyro, dtype=torch.float32)
    dev = gyro.device
    acc = torch.as_tensor(acc, dtype=torch.float32, device=dev)
    dt = torch.as_tensor(dt, dtype=torch.float32, device=dev)
    bg, ba = (torch.as_tensor(b, dtype=torch.float32, device=dev) for b in bias)
    batch = dt.shape[:-1]
    Ng2 = gyro_noise * gyro_noise
    Na2 = acc_noise * acc_noise
    # per-sample bias random-walk covariance = walk_density^2 * dt
    # (reference Calib CovWalk = diag(ngw^2, naw^2)/freq, accumulated into
    # C.block<6,6>(9,9) each IntegrateNewMeasurement, ImuTypes.cc:249)
    walk_diag = torch.tensor([gyro_walk**2] * 3 + [acc_walk**2] * 3, dtype=torch.float32,
                             device=dev)
    nga_diag = torch.tensor([Ng2, Ng2, Ng2, Na2, Na2, Na2], dtype=torch.float32, device=dev)
    I3 = _eye(3, gyro)

    def z(*shape):
        return torch.zeros(batch + shape, dtype=torch.float32, device=dev)

    # all bias Jacobians start at ZERO (reference Preintegrated::Initialize)
    dq = lie.quat_identity(device=dev).expand(batch + (4,))
    dv, dp = z(3), z(3)
    JRg, JVg, JVa, JPg, JPa = z(3, 3), z(3, 3), z(3, 3), z(3, 3), z(3, 3)
    cov, cov_walk, T = z(9, 9), z(6, 6), z()
    for k in range(dt.shape[-1]):
        w = gyro[..., k, :] - bg
        a = acc[..., k, :] - ba
        h = dt[..., k]
        hv, hm = h[..., None], h[..., None, None]
        R = lie.quat_to_matrix(dq)
        ah = lie.hat(a)
        Ra = _mv(R, a)

        # position/velocity updates use the pre-update rotation (ImuTypes.cc:208-216)
        dp_new = dp + dv * hv + 0.5 * Ra * hv * hv
        dv_new = dv + Ra * hv

        # covariance propagation A/B matrices (ImuTypes.cc:220-249)
        phi = w * hv
        dR_inc = lie.so3_exp(phi)
        Rinc = lie.quat_to_matrix(dR_inc)
        Jr = _right_jacobian_so3(phi)
        Rah = R @ ah
        Z3 = torch.zeros_like(R)
        A = torch.cat([
            torch.cat([Rinc.transpose(-1, -2), Z3, Z3], -1),
            torch.cat([-Rah * hm, I3.expand_as(R), Z3], -1),
            torch.cat([-0.5 * Rah * hm * hm, I3 * hm, I3.expand_as(R)], -1),
        ], -2)
        B = torch.cat([
            torch.cat([Jr * hm, Z3], -1),
            torch.cat([Z3, R * hm], -1),
            torch.cat([Z3, 0.5 * R * hm * hm], -1),
        ], -2)
        Nga = torch.diag_embed(nga_diag / torch.clamp_min(h, 1e-9)[..., None])
        cov_new = A @ cov @ A.transpose(-1, -2) + B @ Nga @ B.transpose(-1, -2)
        cov_walk_new = cov_walk + torch.diag_embed(walk_diag * hv)

        # bias Jacobians (ImuTypes.cc:252-258)
        JPa_new = JPa + JVa * hm - 0.5 * R * hm * hm
        JPg_new = JPg + JVg * hm - 0.5 * Rah @ JRg * hm * hm
        JVa_new = JVa - R * hm
        JVg_new = JVg - Rah @ JRg * hm
        JRg_new = Rinc.transpose(-1, -2) @ JRg - Jr * hm

        dq_new = lie.quat_normalize(lie.quat_mul(dq, dR_inc))

        live = h > 0
        lv, lm = live[..., None], live[..., None, None]
        dq = torch.where(lv, dq_new, dq)
        dv = torch.where(lv, dv_new, dv)
        dp = torch.where(lv, dp_new, dp)
        JRg = torch.where(lm, JRg_new, JRg)
        JVg = torch.where(lm, JVg_new, JVg)
        JVa = torch.where(lm, JVa_new, JVa)
        JPg = torch.where(lm, JPg_new, JPg)
        JPa = torch.where(lm, JPa_new, JPa)
        cov = torch.where(lm, cov_new, cov)
        cov_walk = torch.where(lm, cov_walk_new, cov_walk)
        T = torch.where(live, T + h, T)
    return Preintegrated(dq, dv, dp, JRg, JVg, JVa, JPg, JPa, cov, cov_walk, T,
                         ImuBias(bg.expand(batch + (3,)), ba.expand(batch + (3,))))


def delta_with_bias(pre: Preintegrated, bias: ImuBias):
    """First-order bias-corrected deltas (GetDeltaRotation/Velocity/Position,
    ImuTypes.cc:296-323).  Returns (dq, dv, dp) at the new bias."""
    dbg = bias.bg - pre.bias.bg
    dba = bias.ba - pre.bias.ba
    dq = lie.quat_mul(pre.dq, lie.so3_exp(_mv(pre.JRg, dbg)))
    dv = pre.dv + _mv(pre.JVg, dbg) + _mv(pre.JVa, dba)
    dp = pre.dp + _mv(pre.JPg, dbg) + _mv(pre.JPa, dba)
    return lie.quat_normalize(dq), dv, dp


def inertial_residual(pre: Preintegrated, q_wb_i, p_wb_i, v_i, q_wb_j, p_wb_j, v_j,
                      bias: ImuBias, gravity=None):
    """9-vector residual (r_phi, r_v, r_p) of one inertial edge (per leading
    index) — the reference's EdgeInertial::computeError (G2oTypes.cc:569-600).
    ``gravity`` defaults to ``GRAVITY``."""
    g = gravity_vector(pre.dv) if gravity is None else gravity
    dq, dv, dp = delta_with_bias(pre, bias)
    Ri_t = lie.quat_to_matrix(lie.quat_conj(q_wb_i))
    dt = pre.dt[..., None]
    er_q = lie.quat_mul(lie.quat_conj(dq), lie.quat_mul(lie.quat_conj(q_wb_i), q_wb_j))
    r_phi = lie.so3_log(er_q)
    r_v = _mv(Ri_t, v_j - v_i - g * dt) - dv
    r_p = _mv(Ri_t, p_wb_j - p_wb_i - v_i * dt - 0.5 * g * dt * dt) - dp
    return torch.cat(torch.broadcast_tensors(r_phi, r_v, r_p), dim=-1)
