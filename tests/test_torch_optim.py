"""Parity of the port's Sim(3), alignment, triangulation, bundle adjustment,
two-view initialisation and PnP with the JAX package, on the same seeded
numpy inputs.

Tolerances: closed-form geometry float32 allclose at 1e-5 (as
tests/test_torch_geometry.py); bundle adjustment and the RANSAC estimators
run float32 LM iterations whose normal equations sum in another order, so
poses and points are held at 1e-4 and inlier sets are exact, except where a
test says why not.  The RANSAC functions take the index sets the JAX package
drew (``*_from``), and eigenvector outputs (E, H, the DLT camera) are
compared up to sign, which LAPACK leaves free.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rumi_slam_tpu.geometry import alignment as jal
from rumi_slam_tpu.geometry import camera as jcam
from rumi_slam_tpu.geometry import lie as jlie
from rumi_slam_tpu.geometry import triangulation as jtri
from rumi_slam_tpu.optim import ba as jba
from rumi_slam_tpu.optim import pnp as jpnp
from rumi_slam_tpu.optim import two_view as jtv
from rumi_slam_tpu_torch.geometry import alignment as tal
from rumi_slam_tpu_torch.geometry import camera as tcam
from rumi_slam_tpu_torch.geometry import lie as tlie
from rumi_slam_tpu_torch.geometry import triangulation as ttri
from rumi_slam_tpu_torch.optim import ba as tba
from rumi_slam_tpu_torch.optim import pnp as tpnp
from rumi_slam_tpu_torch.optim import ransac
from rumi_slam_tpu_torch.optim import two_view as ttv

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
EST_ATOL = 1e-4
K = np.asarray([260.0, 255.0, 159.5, 119.5], np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


def rng(seed=0):
    return np.random.default_rng(seed)


def quat(n, seed=0):
    q = rng(seed).normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def sim3(n, seed=0):
    r = rng(seed + 1)
    return np.concatenate([quat(n, seed), r.normal(size=(n, 3)), r.normal(0, 0.5, (n, 1))],
                          -1).astype(np.float32)


def sim3_tangent(n):
    tau = (rng(2).normal(size=(n, 7)) * 0.4).astype(np.float32)
    tau[0] = 0.0
    tau[1, :3] = 0.0          # theta -> 0 branch
    tau[2, 6] = 0.0           # sigma -> 0 branch
    tau[3, 6] = 3e-6
    return tau


def pose(rot=(0.02, -0.05, 0.01), tr=(0.3, -0.05, 0.1)):
    return np.asarray(jlie.se3(jlie.so3_exp(jnp.asarray(rot, jnp.float32)),
                               jnp.asarray(tr, jnp.float32)))


def scene(n, seed=0):
    return rng(seed).uniform([-2, -1.5, 3], [2, 1.5, 8], (n, 3)).astype(np.float32)


# ------------------------------------------------------------- closed forms

GEOM = [
    ("sim3_apply", jlie.sim3_apply, tlie.sim3_apply,
     lambda: (sim3(32), rng(3).normal(size=(32, 3)).astype(np.float32))),
    ("sim3_compose", jlie.sim3_compose, tlie.sim3_compose, lambda: (sim3(32), sim3(32, 5))),
    ("sim3_inverse", jlie.sim3_inverse, tlie.sim3_inverse, lambda: (sim3(32),)),
    ("sim3_exp", jlie.sim3_exp, tlie.sim3_exp, lambda: (sim3_tangent(32),)),
    ("sim3_log", jlie.sim3_log, tlie.sim3_log,
     lambda: (np.asarray(jlie.sim3_exp(jnp.asarray(sim3_tangent(32)))),)),
    ("sim3_retract", jlie.sim3_retract, tlie.sim3_retract, lambda: (sim3(32), sim3_tangent(32))),
    ("sim3_make", jlie.sim3_make, tlie.sim3_make,
     lambda: (quat(8), rng(4).normal(size=(8, 3)).astype(np.float32),
              rng(5).uniform(0.5, 2, 8).astype(np.float32))),
    ("sim3_from_se3", lambda T: jlie.sim3_from_se3(T, 2.5),
     lambda T: tlie.sim3_from_se3(T, 2.5), lambda: (sim3(8)[:, :7].copy(),)),
    ("essential_from_poses", jtri.essential_from_poses, ttri.essential_from_poses,
     lambda: (pose()[None].repeat(4, 0), sim3(4)[:, :7].copy())),
    ("stereo_residual", lambda *a: jcam.reproj_residual_and_jacobians_stereo(*a),
     lambda *a: tcam.reproj_residual_and_jacobians_stereo(*a),
     lambda: (K, np.float32(26.0), pose(), scene(64),
              rng(6).uniform(0, 300, (64, 2)).astype(np.float32),
              rng(7).uniform(-5, 300, 64).astype(np.float32))),
    ("inv3x3", jba._inv3x3, tba._inv3x3,
     lambda: (np.concatenate([rng(8).normal(size=(30, 3, 3)),
                              np.zeros((2, 3, 3))]).astype(np.float32),)),
]


def _tuple(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


@pytest.mark.parametrize("name,jfn,tfn,make", GEOM, ids=[g[0] for g in GEOM])
def test_closed_forms_match_jax(name, jfn, tfn, make):
    args = make()
    out_j = _tuple(jfn(*[jnp.asarray(a) for a in args]))
    out_t = _tuple(tfn(*[t(a) for a in args]))
    for a, b in zip(out_j, out_t, strict=True):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


@pytest.mark.parametrize("with_scale,weighted", [(True, False), (False, False), (True, True)])
def test_umeyama_matches_jax(with_scale, weighted):
    src = scene(50, 1)
    S = sim3(1, 9)[0]
    dst = np.asarray(jlie.sim3_apply(jnp.asarray(S), jnp.asarray(src)))
    dst = dst + rng(10).normal(0, 0.01, dst.shape).astype(np.float32)
    w = rng(11).uniform(0, 1, 50).astype(np.float32) if weighted else None
    out_j = jal.umeyama_alignment(jnp.asarray(src), jnp.asarray(dst),
                                  None if w is None else jnp.asarray(w), with_scale=with_scale)
    out_t = tal.umeyama_alignment(t(src), t(dst), None if w is None else t(w),
                                  with_scale=with_scale)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=1e-4, atol=1e-4)


def two_view_rays(n=120, seed=0, noise_px=0.5, outliers=15):
    """Rays of a scene seen from the origin and from ``pose()``, pixel noise
    and a few gross outliers; the world frame is view 1."""
    X = scene(n, seed)
    T = pose()
    r = rng(seed + 1)
    x1 = X[:, :2] / X[:, 2:]
    Xc2 = np.asarray(jlie.se3_apply(jnp.asarray(T), jnp.asarray(X)))
    x2 = Xc2[:, :2] / Xc2[:, 2:]
    x1 = x1 + r.normal(0, noise_px / 260, x1.shape)
    x2 = x2 + r.normal(0, noise_px / 260, x2.shape)
    x2[:outliers] += r.uniform(-0.2, 0.2, (outliers, 2))
    ray1 = np.concatenate([x1, np.ones((n, 1))], -1).astype(np.float32)
    ray2 = np.concatenate([x2, np.ones((n, 1))], -1).astype(np.float32)
    valid = r.random(n) > 0.05
    return X, T, ray1, ray2, valid


def test_triangulation_matches_jax():
    X, T, ray1, ray2, _ = two_view_rays(noise_px=0.0, outliers=0)
    T1 = np.asarray(jlie.se3_identity())[None].repeat(len(X), 0)
    T2 = T[None].repeat(len(X), 0)
    Xj = np.asarray(jtri.triangulate_dlt(*map(jnp.asarray, (T1, T2, ray1, ray2))))
    Xt = ttri.triangulate_dlt(*map(t, (T1, T2, ray1, ray2))).numpy()
    np.testing.assert_allclose(Xt, Xj, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(Xt, X, rtol=1e-3, atol=1e-3)
    uv1 = np.array(jcam.project(jnp.asarray(K), jnp.asarray(X)))
    uv2 = np.array(jcam.project_world(jnp.asarray(K), jnp.asarray(T), jnp.asarray(X))[0])
    uv2[::7] += 5.0                                   # reprojection gate
    Xc = Xt.copy()
    Xc[::11] = -Xc[::11]                              # cheirality gate
    args = (K, np.asarray(jlie.se3_identity()), T, uv1, uv2, Xc)
    ok_j = np.asarray(jtri.triangulation_checks(*map(jnp.asarray, args)))
    ok_t = ttri.triangulation_checks(*map(t, args)).numpy()
    np.testing.assert_array_equal(ok_t, ok_j)
    assert 0.5 < ok_t.mean() < 0.95


# ------------------------------------------------------------- bundle adjustment

def ba_problem(C=4, P=60, seed=0, stereo=False):
    r = rng(seed)
    X = scene(P, seed)
    poses = [pose(rot=r.normal(0, 0.03, 3), tr=r.normal(0, 0.3, 3)) for _ in range(C)]
    poses[0] = np.asarray(jlie.se3_identity())
    cam_idx, pt_idx, uv, ur = [], [], [], []
    for c, T in enumerate(poses):
        seen = r.random(P) < 0.8
        u, _ = jcam.project_world(jnp.asarray(K), jnp.asarray(T), jnp.asarray(X[seen]))
        cam_idx += [c] * int(seen.sum())
        pt_idx += list(np.flatnonzero(seen))
        uv.append(np.asarray(u) + r.normal(0, 0.5, (int(seen.sum()), 2)))
        z = np.asarray(jlie.se3_apply(jnp.asarray(T), jnp.asarray(X[seen])))[:, 2]
        ur.append(np.where(r.random(len(z)) < 0.5, np.asarray(u)[:, 0] - 26.0 / z, -1.0))
    uv = np.concatenate(uv).astype(np.float32)
    uv[::13] += 20.0                                      # outliers
    conf = r.uniform(0.5, 1.0, len(uv)).astype(np.float32)
    conf[::17] = 0.0
    poses0 = np.stack([np.asarray(jlie.se3_retract(jnp.asarray(T), jnp.asarray(
        r.normal(0, 0.01, 6).astype(np.float32)))) for T in poses])
    poses0[0] = poses[0]
    X0 = (X + r.normal(0, 0.05, X.shape)).astype(np.float32)
    args = [K, poses0, X0, np.asarray(cam_idx, np.int32), np.asarray(pt_idx, np.int32), uv, conf,
            np.arange(C) > 0, np.arange(P) % 9 != 0]
    kw = {}
    if stereo:
        kw = dict(bf=np.float32(26.0), ur=np.concatenate(ur).astype(np.float32))
    return args, kw


@pytest.mark.parametrize("stereo", [False, True])
def test_bundle_adjust_matches_jax(stereo):
    args, kw = ba_problem(stereo=stereo)
    rj = jba.bundle_adjust(*map(jnp.asarray, args), n_iters=8,
                           **{k: jnp.asarray(v) for k, v in kw.items()})
    rt = tba.bundle_adjust(*map(t, args), n_iters=8, **{k: t(v) for k, v in kw.items()})
    np.testing.assert_allclose(rt.poses.numpy(), np.asarray(rj.poses), rtol=0, atol=EST_ATOL)
    np.testing.assert_allclose(rt.points.numpy(), np.asarray(rj.points), rtol=0, atol=EST_ATOL)
    np.testing.assert_array_equal(rt.inlier_obs.numpy(), np.asarray(rj.inlier_obs))
    np.testing.assert_allclose(float(rt.cost), float(rj.cost), rtol=1e-3)
    assert float(rt.cost) < float(tba._problem_terms(*map(t, args[:7]), **{
        k: t(v) for k, v in kw.items()})[4])        # and it descended


# ------------------------------------------------------------- two-view

def up_to_sign(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return min(np.abs(a - b).max(), np.abs(a + b).max())


def test_two_view_helpers_match_jax():
    _, _, ray1, ray2, valid = two_view_rays()
    r1, r2 = jnp.asarray(ray1), jnp.asarray(ray2)
    R1, R2 = t(ray1), t(ray2)
    w = valid.astype(np.float32)
    E_j = jtv._eight_point(r1, r2, jnp.asarray(w))
    E_t = ttv._eight_point(R1, R2, t(w))
    assert up_to_sign(E_t.numpy(), E_j) < 1e-4
    Ee_j, Ee_t = jtv._to_essential(E_j), ttv._to_essential(t(np.asarray(E_j)))
    np.testing.assert_allclose(Ee_t.numpy(), np.asarray(Ee_j), atol=1e-5)
    np.testing.assert_allclose(ttv._sampson_err(Ee_t, R1, R2).numpy(),
                               np.asarray(jtv._sampson_err(Ee_j, r1, r2)), rtol=1e-4, atol=1e-9)
    # the four (R, t) candidates of E, as a set
    cj = np.asarray(jtv._decompose_E(Ee_j))
    ct = ttv._decompose_E(t(np.asarray(Ee_j))).numpy()
    for c in ct:
        assert np.abs(cj - c).max(-1).min() < 1e-4
    H_j = jtv._four_point_h(r1, r2, jnp.asarray(w))
    H_t = ttv._four_point_h(R1, R2, t(w))
    assert up_to_sign(H_t.numpy(), H_j) < 1e-4
    np.testing.assert_allclose(ttv._sym_transfer_err(t(np.asarray(H_j)), R1, R2).numpy(),
                               np.asarray(jtv._sym_transfer_err(H_j, r1, r2)), rtol=1e-3,
                               atol=1e-9)
    cj = np.asarray(jtv._decompose_H(H_j))
    ct = ttv._decompose_H(t(np.asarray(H_j))).numpy()
    for c in ct:
        assert np.abs(cj - c).max(-1).min() < 1e-3


@pytest.mark.parametrize("n_valid", [0, 1, 6, 7])
def test_nanmedian_matches_jax(n_valid):
    x = rng(n_valid).normal(size=7).astype(np.float32)
    x[n_valid:] = np.nan
    np.testing.assert_array_equal(ttv._nanmedian(t(x)).numpy(), np.asarray(jnp.nanmedian(x)))


def jax_hypotheses(key, logits, h, m):
    return np.asarray(jax.random.categorical(key, jnp.asarray(logits)[None].repeat(h * m, 0))
                      ).reshape(h, m)


def test_two_view_init_matches_jax_exactly_on_clean_matches():
    """Noise-free matches and the JAX package's own draws: every hypothesis
    takes every valid match, so both packages refine from the same consensus
    and agree on the decision, the inlier set, the pose and the structure."""
    _, T, ray1, ray2, valid = two_view_rays(noise_px=0.0, outliers=0)
    key = jax.random.PRNGKey(3)
    kw = dict(min_inliers=40, focal=260.0)
    rj = jtv.two_view_init(key, jnp.asarray(ray1), jnp.asarray(ray2), jnp.asarray(valid), **kw)
    idx = jax_hypotheses(key, ttv.sample_logits(t(valid)).numpy(), 256, 8)
    rt = ttv.two_view_init_from(t(idx), t(ray1), t(ray2), t(valid), **kw)
    assert bool(rt.ok) and bool(rj.ok)
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    assert int(rt.n_inliers) == int(rj.n_inliers) == valid.sum()
    np.testing.assert_allclose(rt.T_21.numpy(), np.asarray(rj.T_21), rtol=0, atol=EST_ATOL)
    np.testing.assert_allclose(rt.points.numpy(), np.asarray(rj.points), rtol=1e-3,
                               atol=EST_ATOL)
    tdir = T[4:] / np.linalg.norm(T[4:])
    assert np.dot(rt.T_21.numpy()[4:] / np.linalg.norm(rt.T_21.numpy()[4:]), tdir) > 0.9999


def test_two_view_init_close_to_jax_on_noisy_matches():
    """0.5 px noise and 15 gross outliers in 120 matches.  Each 8-point
    hypothesis is the null vector of a rank-8 9x9 matrix from a float32
    eigh, and the two packages' LAPACKs return vectors that differ at the
    noise level, so about half of the 256 hypothesis scores differ by a
    match or two and another hypothesis can win.  Measured: the same
    decision, 12 of 120 rows classified differently, the pose 6e-4 apart.
    Held: the same decision, at most 15% of rows differing, the pose within
    3e-3, both within 2 degrees of the true translation direction."""
    _, T, ray1, ray2, valid = two_view_rays()
    key = jax.random.PRNGKey(3)
    kw = dict(min_inliers=40, focal=260.0)
    rj = jtv.two_view_init(key, jnp.asarray(ray1), jnp.asarray(ray2), jnp.asarray(valid), **kw)
    idx = jax_hypotheses(key, ttv.sample_logits(t(valid)).numpy(), 256, 8)
    rt = ttv.two_view_init_from(t(idx), t(ray1), t(ray2), t(valid), **kw)
    assert bool(rt.ok) == bool(rj.ok) is True
    assert (rt.inliers.numpy() != np.asarray(rj.inliers)).mean() <= 0.15
    np.testing.assert_allclose(rt.T_21.numpy(), np.asarray(rj.T_21), rtol=0, atol=3e-3)
    tdir = T[4:] / np.linalg.norm(T[4:])
    for T21 in (rt.T_21.numpy(), np.asarray(rj.T_21)):
        assert np.dot(T21[4:] / np.linalg.norm(T21[4:]), tdir) > np.cos(np.deg2rad(2.0))


def test_two_view_init_default_draw_is_seeded():
    _, _, ray1, ray2, valid = two_view_rays(noise_px=0.0, outliers=0)
    outs = [ttv.two_view_init(ransac.sampler(torch.Generator().manual_seed(5)), t(ray1), t(ray2),
                              t(valid), min_inliers=40, focal=260.0) for _ in range(2)]
    assert bool(outs[0].ok)
    assert torch.equal(outs[0].T_21, outs[1].T_21)


# ------------------------------------------------------------- PnP

def pnp_problem(n=150, outliers=60, seed=4):
    X = scene(n, seed)
    T = pose()
    r = rng(seed)
    uv = np.asarray(jcam.project_world(jnp.asarray(K), jnp.asarray(T), jnp.asarray(X))[0])
    uv = uv + r.normal(0, 0.5, uv.shape)
    uv[:outliers] = r.uniform([0, 0], [320, 240], (outliers, 2))
    quality = r.uniform(5, 40, n).astype(np.float32)
    quality[outliers:] += 20
    return X, T, uv.astype(np.float32), r.random(n) > 0.05, quality


def test_dlt_pose_matches_jax_up_to_the_sign_of_p():
    """On exact correspondences the DLT camera P is determined up to its
    sign, which the eigensolver leaves free; the orthogonalisation gives the
    true pose for one sign and a wrong one for the other (RANSAC scoring
    sorts them out).  Where both packages land on the same sign, their poses
    agree; both get the true pose for some of the hypotheses."""
    X, T, _, _, _ = pnp_problem()
    rays = np.asarray(jlie.se3_apply(jnp.asarray(T), jnp.asarray(X)))
    hyp = np.arange(120).reshape(20, 6)
    pj = np.asarray(jax.vmap(lambda ii: jpnp._dlt_pose(jnp.asarray(X)[ii],
                                                       jnp.asarray(rays)[ii]))(hyp))
    pt = tpnp._dlt_pose(t(X)[hyp], t(rays)[hyp]).numpy()
    # a 6-point float32 DLT recovers the pose to about 4e-3
    true_j = np.abs(pj - T).max(-1) < 1e-2
    true_t = np.abs(pt - T).max(-1) < 1e-2
    assert true_j.any() and true_t.any()
    same_sign = true_j == true_t
    assert same_sign.mean() >= 0.5
    np.testing.assert_allclose(pt[same_sign & true_t], pj[same_sign & true_t], atol=1e-2)


def test_pnp_ransac_matches_jax():
    X, T, uv, valid, quality = pnp_problem()
    key = jax.random.PRNGKey(7)
    rj = jpnp.pnp_ransac(key, jnp.asarray(K), jnp.asarray(X), jnp.asarray(uv),
                         jnp.asarray(valid), quality=jnp.asarray(quality))
    idx = jax_hypotheses(key, tpnp.sample_logits(t(valid), t(quality)).numpy(), 1024, 6)
    rt = tpnp.pnp_ransac_from(t(idx), t(K), t(X), t(uv), t(valid))
    assert bool(rt.ok) and bool(rj.ok)
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    assert int(rt.n_inliers) == int(rj.n_inliers) > 70
    np.testing.assert_allclose(rt.pose.numpy(), np.asarray(rj.pose), rtol=0, atol=EST_ATOL)
    np.testing.assert_allclose(rt.pose.numpy(), T, atol=5e-3)
