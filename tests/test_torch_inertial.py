"""The port's inertial subsystem (``inertial/preintegration.py``,
``inertial/inertial_ba.py``) and ``optim/ba.marginalize`` against the JAX
package on the same numpy inputs, and against the numpy reference of
``tests/test_inertial.py``.

Tolerances (float32 in both packages): preintegration fields within 1e-5
absolute plus 1e-5 of the field's magnitude; the Jacobians of the three
solvers' residual stacks within 1e-3 of each matrix's largest entry of
``jax.jacfwd``'s (whitened inertial rows reach 1e3); solver outputs within
the bounds given at each test; ``marginalize`` within 1e-4 of the largest
entry (the pseudo-inverse's eigenvalue cut is the same in both).  Every
bound is at least ten times the largest gap measured on these inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rumi_slam_tpu.geometry import camera as jcam
from rumi_slam_tpu.geometry import lie as jlie
from rumi_slam_tpu.inertial import inertial_ba as jiba
from rumi_slam_tpu.inertial import preintegration as JP
from rumi_slam_tpu.optim import ba as jba
from rumi_slam_tpu.optim import robust as jrobust
from rumi_slam_tpu_torch.inertial import inertial_ba as tiba
from rumi_slam_tpu_torch.inertial import preintegration as TP
from rumi_slam_tpu_torch.optim import ba as tba
from test_inertial import _sample_imu, _simulate, _vi_observations, np_preintegrate

NOISE = dict(gyro_noise=1.7e-3, acc_noise=2.0e-2, gyro_walk=1e-4, acc_walk=1e-3)


def t(x):
    return torch.from_numpy(np.asarray(x, np.float32).copy())


def zero_bias():
    return TP.zero_bias(device="cpu")


def close(a, b, rel, abs_=0.0):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(np.abs(b).max(initial=0.0), 1.0)
    np.testing.assert_allclose(a, b, atol=abs_ + rel * scale, rtol=0)


def jax_pre(pre_np):
    """The JAX package's Preintegrated from the port's ``to_numpy``."""
    return JP.Preintegrated(*(jnp.asarray(x) for x in pre_np[:-1]),
                            JP.ImuBias(*(jnp.asarray(x) for x in pre_np[-1])))


@pytest.mark.parametrize("padded", [False, True])
def test_preintegrate_matches_jax_and_numpy(padded):
    gyro, acc, dts = _sample_imu(n=40, seed=1)
    if padded:
        gyro = np.concatenate([gyro, np.full((8, 3), 77.0, np.float32)])
        acc = np.concatenate([acc, np.full((8, 3), -55.0, np.float32)])
        dts = np.concatenate([dts, np.zeros(8, np.float32)])
    bg = np.array([0.01, -0.02, 0.005], np.float32)
    ba = np.array([0.1, 0.05, -0.08], np.float32)
    jp = JP.preintegrate(gyro, acc, dts, JP.ImuBias(jnp.asarray(bg), jnp.asarray(ba)), **NOISE)
    tp = TP.preintegrate(t(gyro), t(acc), t(dts), TP.ImuBias(t(bg), t(ba)), **NOISE)
    for f, a, b in zip(TP.Preintegrated._fields[:-1], tp[:-1], jp[:-1]):
        close(a.numpy(), b, 1e-5, 1e-5), f
    ref = np_preintegrate(gyro.astype(np.float64), acc.astype(np.float64),
                          dts.astype(np.float64), bg, ba, **NOISE)
    dR, dV, dP, JRg, JVg, JVa, JPg, JPa, C, Cw, T = ref
    # the bounds of tests/test_inertial.py::test_preintegrate_vs_numpy
    np.testing.assert_allclose(TP.lie.quat_to_matrix(tp.dq).numpy(), dR, atol=1e-5)
    np.testing.assert_allclose(tp.dv.numpy(), dV, atol=1e-4)
    np.testing.assert_allclose(tp.dp.numpy(), dP, atol=1e-4)
    np.testing.assert_allclose(tp.JRg.numpy(), JRg, atol=1e-4)
    np.testing.assert_allclose(tp.JVg.numpy(), JVg, atol=1e-3)
    np.testing.assert_allclose(tp.JVa.numpy(), JVa, atol=1e-4)
    np.testing.assert_allclose(tp.JPg.numpy(), JPg, atol=1e-4)
    np.testing.assert_allclose(tp.JPa.numpy(), JPa, atol=1e-4)
    np.testing.assert_allclose(tp.cov.numpy(), C, atol=1e-5)
    np.testing.assert_allclose(tp.cov_walk.numpy(), Cw, atol=1e-8)
    np.testing.assert_allclose(tp.dt.numpy(), T, atol=1e-6)


def test_preintegrate_batches_intervals():
    """Three intervals in one call equal three single calls (and JAX's)."""
    segs = [_sample_imu(n=25, seed=s) for s in (2, 3, 4)]
    b = zero_bias()
    batched = TP.preintegrate(*(t(np.stack([s[k] for s in segs])) for k in range(3)), b)
    for i, s in enumerate(segs):
        single = TP.preintegrate(*(t(x) for x in s), b)
        jp = JP.preintegrate(*s, JP.zero_bias())
        for a, c, j in zip(batched[:-1], single[:-1], jp[:-1]):
            close(a[i].numpy(), c.numpy(), 1e-6, 1e-7)
            close(a[i].numpy(), j, 1e-5, 1e-5)


def test_delta_with_bias_and_residual_match_jax():
    gyro, acc, dts = _sample_imu(seed=3)
    b0 = (np.array([0.01, 0.0, -0.01], np.float32), np.array([0.05, -0.02, 0.0], np.float32))
    b1 = (b0[0] + 2e-3, b0[1] - 1e-3)
    tp = TP.preintegrate(t(gyro), t(acc), t(dts), TP.ImuBias(*map(t, b0)))
    jp = JP.preintegrate(gyro, acc, dts, JP.ImuBias(*map(jnp.asarray, b0)))
    for a, b in zip(TP.delta_with_bias(tp, TP.ImuBias(*map(t, b1))),
                    JP.delta_with_bias(jp, JP.ImuBias(*map(jnp.asarray, b1)))):
        close(a.numpy(), b, 1e-5, 1e-6)
    qs, ps, vs, segs = _simulate(n_kf=3)
    tp = TP.preintegrate(*(t(x) for x in segs[0]), zero_bias())
    jp = JP.preintegrate(*segs[0], JP.zero_bias())
    rng = np.random.default_rng(5)
    q1 = np.asarray(jlie.quat_normalize(jnp.asarray(qs[1] + 0.02 * rng.normal(size=4))))
    args = [qs[0], ps[0], vs[0], q1, ps[1] + 0.01, vs[1] - 0.02]
    r_t = TP.inertial_residual(tp, *map(t, args), TP.ImuBias(*map(t, b1)))
    r_j = JP.inertial_residual(jp, *map(jnp.asarray, args), JP.ImuBias(*map(jnp.asarray, b1)))
    close(r_t.numpy(), r_j, 1e-5, 1e-6)
    # at the simulated truth the residual vanishes (tests/test_inertial.py bound)
    r0 = TP.inertial_residual(tp, *map(t, [qs[0], ps[0], vs[0], qs[1], ps[1], vs[1]]),
                              zero_bias())
    assert float(r0.abs().max()) < 2e-3


def test_preintegrated_crosses_both_ways():
    """JAX's preintegrated deltas through the port's solver equal the port's
    own; the port's deltas rebuild JAX's tuple exactly."""
    qs, ps, vs, segs = _simulate(n_kf=4, seed=2)
    jpres = jiba.stack_preintegrated([JP.preintegrate(*s, JP.zero_bias()) for s in segs])
    tpres = tiba.stack_preintegrated([TP.preintegrate(*(t(x) for x in s), zero_bias())
                                      for s in segs])
    from_jax = TP.Preintegrated.from_numpy(jpres, device="cpu")
    back = jax_pre(tpres.to_numpy())
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tpres.to_numpy())):
        np.testing.assert_array_equal(np.asarray(a), b)
    r1 = tiba.inertial_only_optimization(t(qs), t(ps / 2.0), from_jax, n_iters=5)
    r2 = tiba.inertial_only_optimization(t(qs), t(ps / 2.0), tpres, n_iters=5)
    close(r1.scale.numpy(), r2.scale.numpy(), 3e-3)
    close(r1.velocities.numpy(), r2.velocities.numpy(), 3e-3)


# -- the JAX package's residual stacks (the bodies of its solvers' closures),
#    for jax.jacfwd ---------------------------------------------------------

def jax_inertial_only_residuals(q_wb, p_wb, pres, prior_bias_info=1e2):
    N = q_wb.shape[0]

    def residuals(theta):
        phi_g = jnp.concatenate([theta[0:2], jnp.zeros(1)])
        s = jnp.exp(theta[2])
        v = theta[3:3 + 3 * N].reshape(N, 3)
        bias = JP.ImuBias(theta[3 + 3 * N:6 + 3 * N], theta[6 + 3 * N:9 + 3 * N])
        g = jlie.quat_rotate(jlie.so3_exp(phi_g), JP.GRAVITY)
        p = s * p_wb

        def edge(i):
            pre_i = jax.tree.map(lambda x: x[i], pres)
            return jiba._inertial_residual_whitened(pre_i, q_wb[i], p[i], v[i], q_wb[i + 1],
                                                    p[i + 1], v[i + 1], bias, g)

        r_in = jax.vmap(edge)(jnp.arange(N - 1)).reshape(-1)
        r_b = jnp.sqrt(prior_bias_info) * jnp.concatenate([bias.bg, bias.ba])
        return jnp.concatenate([r_in, r_b])

    return residuals


def jax_pose_residuals(K, T_cb, qp, pp, vp, pre, q_wb, p_wb, v, bias, X_w, uv, valid):
    W_walk = jiba._whiten(pre.cov_walk)

    def residuals(theta):
        q = jlie.quat_normalize(jlie.quat_mul(q_wb, jlie.so3_exp(theta[0:3])))
        p, vv = p_wb + theta[3:6], v + theta[6:9]
        b = JP.ImuBias(bias.bg + theta[9:12], bias.ba + theta[12:15])
        r_in = jiba._inertial_residual_whitened(pre, qp, pp, vp, q, p, vv, b, JP.GRAVITY)
        r_walk = W_walk.T @ jnp.concatenate([b.bg - pre.bias.bg, b.ba - pre.bias.ba])
        T_cw = jlie.se3_compose(T_cb, jlie.se3_inverse(jlie.se3(q, p)))
        pc = jlie.se3_apply(T_cw, X_w)
        r_uv = jcam.project(K, pc) - uv
        chi2 = jnp.sum(r_uv * r_uv, axis=-1)
        w = jnp.sqrt(valid.astype(jnp.float32) * jrobust.huber_weight(chi2, 5.991)
                     * (pc[:, 2] > 0.05))
        return jnp.concatenate([r_in, r_walk, (w[:, None] * r_uv).reshape(-1)])

    return residuals


def jax_vi_motion_residuals(K, T_cb, q0, p0, v0, bg0, ba0, pres, pts, cam_idx, pt_idx, uv,
                            conf, kf_free):
    N = q0.shape[0]
    W_walk = jax.vmap(jiba._whiten)(pres.cov_walk)
    kf_freef = kf_free.astype(jnp.float32)

    def residuals(theta):
        th = theta.reshape(N, 15) * kf_freef[:, None]
        q = jlie.quat_normalize(jax.vmap(jlie.quat_mul)(q0, jax.vmap(jlie.so3_exp)(th[:, 0:3])))
        p, vv, bgs, bas = p0 + th[:, 3:6], v0 + th[:, 6:9], bg0 + th[:, 9:12], ba0 + th[:, 12:15]

        def edge(i):
            pre_i = jax.tree.map(lambda x: x[i], pres)
            r_in = jiba._inertial_residual_whitened(
                pre_i, q[i], p[i], vv[i], q[i + 1], p[i + 1], vv[i + 1],
                JP.ImuBias(bgs[i], bas[i]), JP.GRAVITY)
            db = jnp.concatenate([bgs[i + 1] - bgs[i], bas[i + 1] - bas[i]])
            return jnp.concatenate([r_in, W_walk[i].T @ db])

        r_edges = jax.vmap(edge)(jnp.arange(N - 1)).reshape(-1)
        T_cw = jax.vmap(lambda tt: jlie.se3_compose(T_cb, tt))(
            jax.vmap(jlie.se3_inverse)(jax.vmap(jlie.se3)(q, p)))
        pc = jax.vmap(jlie.se3_apply)(T_cw[cam_idx], pts[pt_idx])
        r_uv = jcam.project(K, pc) - uv
        chi2 = jnp.sum(r_uv * r_uv, axis=-1) * conf
        w = jnp.sqrt(conf * jrobust.huber_weight(chi2, 5.991) * (pc[:, 2] > 0.05))
        return jnp.concatenate([r_edges, (w[:, None] * r_uv).reshape(-1)])

    return residuals


K_NP = np.array([300.0, 300.0, 160.0, 120.0], np.float32)


def pose_problem(seed=1):
    """tests/test_inertial.py::test_pose_inertial_optimization_recovers_pose's
    inputs (numpy)."""
    qs, ps, vs, segs = _simulate(n_kf=2, steps=40)
    rng = np.random.default_rng(seed)
    X_w = rng.uniform([-2, -2, 2], [2, 2, 6], size=(60, 3)).astype(np.float32)
    uv, vis = _vi_observations(jnp.asarray(K_NP), jlie.se3_identity(), qs[1], ps[1],
                               jnp.asarray(X_w), noise=0.3)
    q0 = np.asarray(jlie.quat_normalize(jlie.quat_mul(
        jnp.asarray(qs[1]), jlie.so3_exp(jnp.asarray([0.03, -0.02, 0.01])))))
    p0 = ps[1] + np.array([0.05, -0.04, 0.06], np.float32)
    v0 = vs[1] + np.array([0.2, 0.1, -0.15], np.float32)
    return dict(qs=qs, ps=ps, vs=vs, seg=segs[0], X_w=X_w, uv=np.asarray(uv),
                vis=np.asarray(vis), q0=q0, p0=p0, v0=v0)


def window_problem(n_kf=4, n_pt=50, seed=2):
    """tests/test_inertial.py::test_visual_inertial_ba_improves_window's inputs
    (numpy; the perturbations drawn with numpy)."""
    qs, ps, vs, segs = _simulate(n_kf=n_kf, steps=25)
    rng = np.random.default_rng(seed)
    X_w = rng.uniform([-2, -2, 2], [2, 2, 6], size=(n_pt, 3)).astype(np.float32)
    uvs, viss = [], []
    for i in range(n_kf):
        uv, vis = _vi_observations(jnp.asarray(K_NP), jlie.se3_identity(), qs[i], ps[i],
                                   jnp.asarray(X_w), noise=0.2, seed=i)
        uvs.append(np.asarray(uv))
        viss.append(np.asarray(vis))
    dq = 0.02 * rng.normal(size=(n_kf, 3)).astype(np.float32)
    dq[0] = 0
    q0 = np.asarray(jax.vmap(lambda q, d: jlie.quat_normalize(jlie.quat_mul(q, jlie.so3_exp(d))))(
        jnp.asarray(qs), jnp.asarray(dq)))
    pert = rng.normal(size=(3, n_kf, 3)).astype(np.float32)
    pert[:, 0] = 0
    return dict(
        qs=qs, ps=ps, vs=vs, segs=segs, q0=q0, p0=ps + 0.04 * pert[0], v0=vs + 0.1 * pert[1],
        X0=(X_w + 0.05 * rng.normal(size=X_w.shape)).astype(np.float32), X_w=X_w,
        cam_idx=np.repeat(np.arange(n_kf), n_pt).astype(np.int32),
        pt_idx=np.tile(np.arange(n_pt), n_kf).astype(np.int32),
        uv=np.concatenate(uvs), conf=np.concatenate(viss).astype(np.float32),
        kf_free=np.arange(n_kf) > 0)


def both_pres(segs):
    jp = jiba.stack_preintegrated([JP.preintegrate(*s, JP.zero_bias()) for s in segs])
    return jp, TP.Preintegrated.from_numpy(jp, device="cpu")


@pytest.mark.parametrize("which", ["inertial_only", "pose_inertial", "vi_motion"])
def test_jacobians_match_jacfwd(which):
    rng = np.random.default_rng(11)
    if which == "inertial_only":
        qs, ps, vs, segs = _simulate(n_kf=5)
        jp, tp = both_pres(segs)
        jres = jax_inertial_only_residuals(jnp.asarray(qs), jnp.asarray(ps / 2.0), jp)
        _, tres = tiba.inertial_only_problem(t(qs), t(ps / 2.0), tp)
        n = 9 + 3 * len(qs)
    elif which == "pose_inertial":
        d = pose_problem()
        jpre = JP.preintegrate(*d["seg"], JP.zero_bias())
        tpre = TP.Preintegrated.from_numpy(jpre, device="cpu")
        args = [d["qs"][0], d["ps"][0], d["vs"][0]]
        jres = jax_pose_residuals(jnp.asarray(K_NP), jlie.se3_identity(),
                                  *map(jnp.asarray, args), jpre, *map(jnp.asarray, (
                                      d["q0"], d["p0"], d["v0"])), JP.zero_bias(),
                                  jnp.asarray(d["X_w"]), jnp.asarray(d["uv"]),
                                  jnp.asarray(d["vis"]))
        _, tres = tiba.pose_inertial_problem(
            t(K_NP), TP.lie.se3_identity(), *map(t, args), tpre,
            *map(t, (d["q0"], d["p0"], d["v0"])), zero_bias(), t(d["X_w"]), t(d["uv"]),
            torch.from_numpy(np.array(d["vis"])))
        n = 15
    else:
        d = window_problem()
        jp, tp = both_pres(d["segs"])
        N = len(d["q0"])
        z3 = np.zeros((N, 3), np.float32)
        jres = jax_vi_motion_residuals(
            jnp.asarray(K_NP), jlie.se3_identity(), *map(jnp.asarray, (
                d["q0"], d["p0"], d["v0"], z3, z3)), jp, jnp.asarray(d["X0"]),
            jnp.asarray(d["cam_idx"]), jnp.asarray(d["pt_idx"]), jnp.asarray(d["uv"]),
            jnp.asarray(d["conf"]), jnp.asarray(d["kf_free"]))
        _, motion, motion_jacobian, _ = tiba.vi_ba_problem(
            t(K_NP), TP.lie.se3_identity(), tp, torch.from_numpy(d["cam_idx"]),
            torch.from_numpy(d["pt_idx"]), t(d["uv"]), t(d["conf"]),
            torch.from_numpy(d["kf_free"]), torch.ones(len(d["X0"]), dtype=torch.bool))
        state = [t(x) for x in (d["q0"], d["p0"], d["v0"], z3, z3)]
        # the assembled Jacobian at theta = 0 (the point the solver linearises at)
        r0, J0 = motion_jacobian(*state, t(d["X0"]))
        j0 = jnp.zeros(15 * N)
        close(r0.numpy(), jres(j0), 1e-4)
        close(J0.numpy(), jax.jit(jax.jacfwd(jres))(j0), 1e-3)

        def tres(theta):
            return motion(theta, *state, t(d["X0"]))
        n = 15 * N
    theta = (1e-3 * rng.normal(size=n)).astype(np.float32)
    r_t, J_t = tiba.jacobian(tres, t(theta))
    J_j = jax.jit(jax.jacfwd(jres))(jnp.asarray(theta))
    close(r_t.numpy(), jres(jnp.asarray(theta)), 1e-4)
    assert J_t.shape == J_j.shape
    close(J_t.numpy(), J_j, 1e-3)


def test_inertial_only_optimization_matches_jax():
    qs, ps, vs, segs = _simulate(n_kf=6)
    jp, tp = both_pres(segs)
    true_scale = 2.5
    jr = jiba.inertial_only_optimization(jnp.asarray(qs), jnp.asarray(ps / true_scale), jp,
                                         n_iters=25)
    tr = tiba.inertial_only_optimization(t(qs), t(ps / true_scale), tp, n_iters=25)
    close(tr.scale.numpy(), jr.scale, 2e-3)
    close(tr.q_wg.numpy(), jr.q_wg, 2e-3)
    close(tr.velocities.numpy(), jr.velocities, 2e-3)
    close(tr.bias.bg.numpy(), jr.bias.bg, 2e-3)
    close(tr.bias.ba.numpy(), jr.bias.ba, 2e-3)
    # tests/test_inertial.py's bounds on the port
    assert abs(float(tr.scale) - true_scale) < 0.08 * true_scale
    np.testing.assert_allclose(tr.velocities.numpy(), vs, atol=0.15)
    r0 = tiba.inertial_only_optimization(t(qs), t(ps / true_scale), tp, n_iters=0)
    assert float(tr.cost) <= float(r0.cost)


def test_pose_inertial_optimization_matches_jax():
    d = pose_problem()
    jpre = JP.preintegrate(*d["seg"], JP.zero_bias())
    tpre = TP.Preintegrated.from_numpy(jpre, device="cpu")
    prev = [d["qs"][0], d["ps"][0], d["vs"][0]]
    cur = [d["q0"], d["p0"], d["v0"]]
    jr = jiba.pose_inertial_optimization(
        jnp.asarray(K_NP), jlie.se3_identity(), *map(jnp.asarray, prev), jpre,
        *map(jnp.asarray, cur), JP.zero_bias(), jnp.asarray(d["X_w"]), jnp.asarray(d["uv"]),
        jnp.asarray(d["vis"]), n_iters=12)
    tr = tiba.pose_inertial_optimization(
        t(K_NP), TP.lie.se3_identity(), *map(t, prev), tpre, *map(t, cur), zero_bias(),
        t(d["X_w"]), t(d["uv"]), torch.from_numpy(np.array(d["vis"])), n_iters=12)
    close(tr.q_wb.numpy(), jr.q_wb, 1e-4)
    close(tr.p_wb.numpy(), jr.p_wb, 1e-4)
    close(tr.v.numpy(), jr.v, 1e-3)
    close(tr.bias.bg.numpy(), jr.bias.bg, 1e-3)
    close(tr.bias.ba.numpy(), jr.bias.ba, 1e-3)
    assert int(tr.n_inliers) == int(jr.n_inliers) > 40
    assert float(np.linalg.norm(tr.p_wb.numpy() - d["ps"][1])) < 0.02


def test_visual_inertial_ba_matches_jax():
    d = window_problem()
    jp, tp = both_pres(d["segs"])
    N, Pt = len(d["q0"]), len(d["X0"])
    z3 = np.zeros((N, 3), np.float32)
    jr = jiba.visual_inertial_ba(
        jnp.asarray(K_NP), jlie.se3_identity(), *map(jnp.asarray, (
            d["q0"], d["p0"], d["v0"], z3, z3)), jp, jnp.asarray(d["X0"]),
        jnp.asarray(d["cam_idx"]), jnp.asarray(d["pt_idx"]), jnp.asarray(d["uv"]),
        jnp.asarray(d["conf"]), jnp.asarray(d["kf_free"]), jnp.ones(Pt, bool), n_iters=10)
    tr = tiba.visual_inertial_ba(
        t(K_NP), TP.lie.se3_identity(), *map(t, (d["q0"], d["p0"], d["v0"], z3, z3)), tp,
        t(d["X0"]), torch.from_numpy(d["cam_idx"]), torch.from_numpy(d["pt_idx"]),
        t(d["uv"]), t(d["conf"]), torch.from_numpy(d["kf_free"]),
        torch.ones(Pt, dtype=torch.bool), n_iters=10)
    for f in ("q_wb", "p_wb", "v", "bg", "ba", "points"):
        close(getattr(tr, f).numpy(), getattr(jr, f), 1e-3)
    close(tr.cost.numpy(), jr.cost, 1e-2)
    assert float(tr.cost) <= float(tr.cost0)
    # tests/test_inertial.py's bounds on the port
    err_before = np.linalg.norm(d["p0"][1:] - d["ps"][1:], axis=-1).mean()
    err_after = np.linalg.norm(tr.p_wb.numpy()[1:] - d["ps"][1:], axis=-1).mean()
    assert err_after < 0.5 * err_before and err_after < 0.02


@pytest.mark.parametrize("rank_deficient", [False, True])
def test_marginalize_matches_jax(rank_deficient):
    rng = np.random.default_rng(7)
    n, a, b = 15, 4, 10
    J = rng.normal(size=(30, n)).astype(np.float32)
    if rank_deficient:
        # columns 5 and 6 of the marginalized block move together: a gauge
        J[:, 6] = J[:, 5]
    H = (J.T @ J).astype(np.float32)
    g = rng.normal(size=n).astype(np.float32)
    Hj, gj = jba.marginalize(jnp.asarray(H), jnp.asarray(g), a, b)
    Ht, gt_ = tba.marginalize(t(H), t(g), a, b)
    close(Ht.numpy(), Hj, 1e-4)
    close(gt_.numpy(), gj, 1e-4)
    assert Ht.shape == (n, n) and not Ht[a:b].any() and not Ht[:, a:b].any()
    assert not gt_[a:b].any()
