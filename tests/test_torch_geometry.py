"""Parity of the port's geometry and robust-loss functions with the JAX
package: the same seeded numpy inputs through both, float32 allclose with
rtol = atol = 1e-5 (both compute in float32; only the order of a few
operations and the transcendental implementations differ)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rumi_slam_tpu.geometry import camera as jcam
from rumi_slam_tpu.geometry import lie as jlie
from rumi_slam_tpu.optim import robust as jrob
from rumi_slam_tpu_torch.geometry import camera as tcam
from rumi_slam_tpu_torch.geometry import lie as tlie
from rumi_slam_tpu_torch.optim import robust as trob

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
K = np.asarray([260.0, 255.0, 159.5, 119.5], np.float32)


def _rng():
    return np.random.default_rng(0)


def quat(n):
    q = _rng().normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def se3(n):
    rng = _rng()
    return np.concatenate([quat(n), rng.normal(size=(n, 3)).astype(np.float32)], -1)


def vec(n, d=3, scale=1.0, seed=1):
    return (np.random.default_rng(seed).normal(size=(n, d)) * scale).astype(np.float32)


def omega_with_zero(n):
    """Tangents including exactly zero and tiny angles (the _safe_norm and
    Taylor branches)."""
    w = vec(n, 3)
    w[0] = 0.0
    w[1] = [1e-9, 0.0, 0.0]
    w[2] = [0.0, 3e-7, 0.0]
    return w


def tau_with_zero(n):
    t = vec(n, 6, 0.3, seed=2)
    t[0] = 0.0
    t[1, :3] = 0.0
    return t


def points_in_front(n):
    X = vec(n, 3, 1.0, seed=3)
    X[:, 2] = np.abs(X[:, 2]) + 2.0
    return X


# (name, jax fn, torch fn, input factory returning a tuple of numpy arrays)
CASES = [
    ("quat_normalize", jlie.quat_normalize, tlie.quat_normalize, lambda: (vec(32, 4),)),
    ("quat_mul", jlie.quat_mul, tlie.quat_mul, lambda: (quat(32), quat(32)[::-1].copy())),
    ("quat_conj", jlie.quat_conj, tlie.quat_conj, lambda: (quat(32),)),
    ("quat_rotate", jlie.quat_rotate, tlie.quat_rotate, lambda: (quat(32), vec(32))),
    ("quat_to_matrix", jlie.quat_to_matrix, tlie.quat_to_matrix, lambda: (quat(32),)),
    ("quat_from_matrix", jlie.quat_from_matrix, tlie.quat_from_matrix,
     lambda: (np.asarray(jlie.quat_to_matrix(jnp.asarray(quat(64)))),)),
    ("so3_exp", jlie.so3_exp, tlie.so3_exp, lambda: (omega_with_zero(32),)),
    ("so3_log", jlie.so3_log, tlie.so3_log,
     lambda: (np.asarray(jlie.so3_exp(jnp.asarray(omega_with_zero(32)))),)),
    ("hat", jlie.hat, tlie.hat, lambda: (vec(16),)),
    ("se3_apply", jlie.se3_apply, tlie.se3_apply, lambda: (se3(32), vec(32))),
    ("se3_compose", jlie.se3_compose, tlie.se3_compose,
     lambda: (se3(32), se3(32)[::-1].copy())),
    ("se3_inverse", jlie.se3_inverse, tlie.se3_inverse, lambda: (se3(32),)),
    ("so3_left_jacobian", jlie._so3_left_jacobian, tlie._so3_left_jacobian,
     lambda: (omega_with_zero(32),)),
    ("se3_exp", jlie.se3_exp, tlie.se3_exp, lambda: (tau_with_zero(32),)),
    ("se3_log", jlie.se3_log, tlie.se3_log,
     lambda: (np.asarray(jlie.se3_exp(jnp.asarray(tau_with_zero(32)))),)),
    ("se3_to_matrix", jlie.se3_to_matrix, tlie.se3_to_matrix, lambda: (se3(8),)),
    ("se3_from_matrix", jlie.se3_from_matrix, tlie.se3_from_matrix,
     lambda: (np.asarray(jlie.se3_to_matrix(jnp.asarray(se3(8)))),)),
    ("se3_retract", jlie.se3_retract, tlie.se3_retract, lambda: (se3(32), tau_with_zero(32))),
    ("project", jcam.project, tcam.project, lambda: (K, points_in_front(64))),
    ("unproject", jcam.unproject, tcam.unproject,
     lambda: (K, vec(64, 2, 100.0), np.abs(vec(64, 1, 3.0, seed=4))[:, 0] + 0.5)),
    ("project_jacobian_point", jcam.project_jacobian_point, tcam.project_jacobian_point,
     lambda: (K, points_in_front(64))),
    ("project_world", jcam.project_world, tcam.project_world,
     lambda: (K, se3(1)[0] * np.asarray([1, 1, 1, 1, 0.1, 0.1, 0.1], np.float32),
              points_in_front(64))),
    ("reproj_residual_and_jacobians", jcam.reproj_residual_and_jacobians,
     tcam.reproj_residual_and_jacobians,
     lambda: (K, se3(1)[0] * np.asarray([1, 1, 1, 1, 0.1, 0.1, 0.1], np.float32),
              points_in_front(64), vec(64, 2, 50.0) + 150.0)),
    ("huber_weight", lambda c: jrob.huber_weight(c, 5.991),
     lambda c: trob.huber_weight(c, 5.991),
     lambda: (np.concatenate([[0.0, 5.991], np.abs(vec(62, 1, 8.0)[:, 0])]).astype(np.float32),)),
    ("huber_cost", lambda c: jrob.huber_cost(c, 5.991),
     lambda c: trob.huber_cost(c, 5.991),
     lambda: (np.concatenate([[0.0, 5.991], np.abs(vec(62, 1, 8.0)[:, 0])]).astype(np.float32),)),
]


def _as_tuple(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


@pytest.mark.parametrize("name,jfn,tfn,make", CASES, ids=[c[0] for c in CASES])
def test_matches_jax(name, jfn, tfn, make):
    args = make()
    out_j = _as_tuple(jfn(*[jnp.asarray(a) for a in args]))
    out_t = _as_tuple(tfn(*[torch.from_numpy(np.array(a)) for a in args]))
    assert len(out_j) == len(out_t)
    for a, b in zip(out_j, out_t):
        assert b.dtype == torch.float32
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


def test_exp_at_zero_is_identity_with_finite_gradient():
    """_safe_norm's zero guard: exp(0) is the identity and its gradient is
    finite, as in the JAX package."""
    tau = torch.zeros(6, requires_grad=True)
    T = tlie.se3_exp(tau)
    np.testing.assert_array_equal(T.detach().numpy(), [1, 0, 0, 0, 0, 0, 0])
    T.sum().backward()
    assert torch.isfinite(tau.grad).all()
