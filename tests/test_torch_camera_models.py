"""Parity of the port's camera models with the JAX package: radtan distortion
(``geometry/distortion.py``), the Kannala-Brandt fisheye model
(``geometry/camera_kb8.py``) and the keypoint rectification of
``SlamSystem._extract`` under each.

Both packages get the same seeded numpy inputs.  Tolerances: the models are
the same float32 formulas evaluated in the same order, so values agree to a
few ulps (relative 1e-6, or 1e-4 px on pixels of a 640-px image); the
iterated inverses (8 fixed-point steps of ``undistort_points``, 10 Newton
steps of ``kb8.unproject``) to 1e-4 px / 1e-5 on rays.  Analytic Jacobians
are held to ``jax.jacfwd`` of the JAX functions (and the port's to its own
``torch.func.jacfwd``) at 1e-3 relative.  ``_extract``: rows whose raw ORB
keypoint is the same in both packages (all but a row or two of 256) must be
rectified to within 1e-3 px.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rumi_slam_tpu.config import tiny_config as jax_tiny_config
from rumi_slam_tpu.geometry import camera_kb8 as jkb8
from rumi_slam_tpu.geometry import distortion as jdist
from rumi_slam_tpu.geometry import lie as jlie
from rumi_slam_tpu.io.synthetic import SyntheticSequence as JaxSequence
from rumi_slam_tpu.ops import orb as jorb
from rumi_slam_tpu.system import SlamSystem as JaxSlam
from rumi_slam_tpu_torch.config import tiny_config
from rumi_slam_tpu_torch.geometry import camera as tcam
from rumi_slam_tpu_torch.geometry import camera_kb8 as tkb8
from rumi_slam_tpu_torch.geometry import distortion as tdist
from rumi_slam_tpu_torch.system import SlamSystem

torch.set_num_threads(1)

# TUM1's radtan coefficients and intrinsics (the reference system's TUM1 settings)
K_TUM1 = np.asarray([517.306408, 516.469215, 318.643040, 255.313989], np.float32)
DIST_TUM1 = np.asarray([0.262383, -0.953104, -0.005358, 0.002628, 1.163314], np.float32)
# a fisheye calibration of the TUM-VI kind, and the KB8 camera of the pipeline tests
P_FISH = np.asarray([190.97, 190.97, 254.93, 256.89, 0.00348, 0.000715, -0.0020917, 0.000419],
                    np.float32)
KB = (0.05, -0.01, 0.003, -0.001)

PIX_ATOL = 1e-4
RAY_ATOL = 1e-5
JAC_RTOL = 1e-3
EXTRACT_ATOL = 1e-3


def both(x):
    return torch.from_numpy(np.asarray(x, np.float32)), jnp.asarray(np.asarray(x, np.float32))


def close(t, j, atol, rtol=1e-6):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol, rtol=rtol)


# --------------------------------------------------------------------- radtan

def test_distort_normalized():
    rng = np.random.default_rng(0)
    xy = rng.uniform(-0.6, 0.6, (3, 64, 2))           # leading axes broadcast
    tx, jx = both(xy)
    close(tdist.distort_normalized(tx, torch.from_numpy(DIST_TUM1)),
          jdist.distort_normalized(jx, jnp.asarray(DIST_TUM1)), atol=1e-6)


@pytest.mark.parametrize("n_iters", [8, 3])
def test_undistort_points(n_iters):
    """The fixed-point iteration, including its count, on distorted pixels
    of a TUM1 frame: the port equals JAX's, and with 8 steps both invert
    the distortion (the JAX package's own round-trip bound)."""
    rng = np.random.default_rng(1)
    uv_ideal = rng.uniform([80, 80], [560, 400], (200, 2)).astype(np.float32)
    fx, fy, cx, cy = K_TUM1
    xy = np.stack([(uv_ideal[:, 0] - cx) / fx, (uv_ideal[:, 1] - cy) / fy], -1)
    xyd = np.asarray(jdist.distort_normalized(jnp.asarray(xy), jnp.asarray(DIST_TUM1)))
    uv = np.stack([xyd[:, 0] * fx + cx, xyd[:, 1] * fy + cy], -1)
    t = tdist.undistort_points(torch.from_numpy(K_TUM1), torch.from_numpy(DIST_TUM1),
                               torch.from_numpy(uv), n_iters=n_iters)
    j = jdist.undistort_points(jnp.asarray(K_TUM1), jnp.asarray(DIST_TUM1), jnp.asarray(uv),
                               n_iters=n_iters)
    close(t, j, atol=PIX_ATOL)
    if n_iters == 8:
        err = np.linalg.norm(t.numpy() - uv_ideal, axis=1)
        assert np.median(err) < 0.05 and np.max(err) < 0.5


def test_undistort_radial_guard_and_zero_distortion():
    """|radial| < 1e-9 takes 1e-9 in both packages; zero coefficients are the
    identity; ``has_distortion`` as JAX's."""
    K = np.asarray([100.0, 100.0, 0.0, 0.0], np.float32)
    dist = np.asarray([-1.0, 0.0, 0.0, 0.0, 0.0], np.float32)   # radial 0 at r = 1
    uv = np.asarray([[100.0, 0.0], [50.0, 20.0], [0.0, 0.0]], np.float32)
    t = tdist.undistort_points(torch.from_numpy(K), torch.from_numpy(dist), torch.from_numpy(uv),
                               n_iters=1)
    j = jdist.undistort_points(jnp.asarray(K), jnp.asarray(dist), jnp.asarray(uv), n_iters=1)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert float(t[0, 0]) == pytest.approx(1e11, rel=1e-5)
    uv0 = torch.tensor([[100.0, 200.0], [320.0, 240.0]])
    close(tdist.undistort_points(torch.from_numpy(K_TUM1), torch.zeros(5), uv0), uv0.numpy(),
          atol=1e-4)
    for d in ((0.0,) * 5, (0.1, 0.0, 0.0, 0.0, 0.0), None):
        assert tdist.has_distortion(d) == jdist.has_distortion(d)


# ------------------------------------------------------------------------ KB8

def fisheye_rays(n=256, seed=2, max_deg=70.0):
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, np.deg2rad(max_deg), n)
    azi = rng.uniform(-np.pi, np.pi, n)
    depth = rng.uniform(0.5, 6.0, n)
    rays = np.stack([np.sin(ang) * np.cos(azi), np.sin(ang) * np.sin(azi), np.cos(ang)], -1)
    return (rays * depth[:, None]).astype(np.float32)


def test_kb8_project_and_project_world():
    x = fisheye_rays()
    x[0] = (0.0, 0.0, 2.0)                    # on the axis: the r -> 0 guard, u = cx
    tP, jP = both(P_FISH)
    tx, jx = both(x.reshape(4, 64, 3))
    t = tkb8.project(tP, tx)
    close(t, jkb8.project(jP, jx), atol=PIX_ATOL)
    np.testing.assert_allclose(t.reshape(-1, 2)[0].numpy(), P_FISH[2:4], atol=1e-4)
    T = np.asarray(jlie.se3(jlie.so3_exp(jnp.asarray([0.05, -0.1, 0.08])),
                            jnp.asarray([0.2, -0.3, 0.1])))
    uv_t, d_t = tkb8.project_world(tP, torch.from_numpy(T), tx)
    uv_j, d_j = jkb8.project_world(jP, jnp.asarray(T), jx)
    close(uv_t, uv_j, atol=PIX_ATOL)
    close(d_t, d_j, atol=1e-6)


def test_kb8_unproject():
    """10 Newton steps from theta_d; the theta_d clamp to [0, pi] (pixels far
    outside the image) and the ``td < 1e-9`` branch (the principal point)."""
    tP, jP = both(P_FISH)
    uv = np.asarray(jkb8.project(jP, jnp.asarray(fisheye_rays())))
    uv = np.concatenate([uv, [[254.93, 256.89], [5000.0, -4000.0], [254.93 + 1e-5, 256.89]]])
    tu, ju = both(uv)
    t = tkb8.unproject(tP, tu)
    j = jkb8.unproject(jP, ju)
    close(t, j, atol=RAY_ATOL, rtol=1e-5)
    np.testing.assert_array_equal(t[-3].numpy(), [0.0, 0.0, 1.0])
    # round trip (the JAX package's own bound), and the depth scaling
    back = t[:256].numpy() / np.linalg.norm(t[:256].numpy(), axis=-1, keepdims=True)
    rays = fisheye_rays() / np.linalg.norm(fisheye_rays(), axis=-1, keepdims=True)
    np.testing.assert_allclose(back, rays, atol=2e-4)
    d = np.linspace(0.5, 8.0, len(uv)).astype(np.float32)
    td, jd = both(d)
    close(tkb8.unproject(tP, tu, td), jkb8.unproject(jP, ju, jd), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(tkb8.unproject(tP, tu, td)[:, 2].numpy(), d, rtol=1e-6)


def test_kb8_project_jacobian_point():
    xs = np.concatenate([fisheye_rays(32, seed=3),
                         [[0.3, -0.2, 2.0], [1.5, 0.9, 1.2], [-0.05, 0.02, 4.0]]]).astype(np.float32)
    tP, jP = both(P_FISH)
    tx, jx = both(xs)
    J_t = tkb8.project_jacobian_point(tP, tx)
    close(J_t, jkb8.project_jacobian_point(jP, jx), atol=1e-3, rtol=1e-5)
    J_ad = jax.vmap(jax.jacfwd(lambda x: jkb8.project(jP, x)))(jx)
    close(J_t, J_ad, atol=1e-2, rtol=JAC_RTOL)
    J_own = torch.func.vmap(torch.func.jacfwd(lambda x: tkb8.project(tP, x)))(tx)
    close(J_t, J_own.detach(), atol=1e-2, rtol=JAC_RTOL)


def test_kb8_reproj_residual_and_jacobians():
    rng = np.random.default_rng(4)
    T = np.asarray(jlie.se3(jlie.so3_exp(jnp.asarray([0.05, -0.1, 0.08])),
                            jnp.asarray([0.2, -0.3, 0.1])))
    X = rng.uniform([-1.5, -1.0, 2.0], [1.5, 1.0, 6.0], (16, 3)).astype(np.float32)
    uv = rng.uniform(100, 400, (16, 2)).astype(np.float32)
    tP, jP = both(P_FISH)
    out_t = tkb8.reproj_residual_and_jacobians(tP, torch.from_numpy(T), torch.from_numpy(X),
                                               torch.from_numpy(uv))
    out_j = jkb8.reproj_residual_and_jacobians(jP, jnp.asarray(T), jnp.asarray(X),
                                               jnp.asarray(uv))
    for a, b in zip(out_t, out_j):
        close(a, b, atol=1e-3, rtol=1e-5)
    r_t, Jpose_t, Jpt_t, _ = out_t
    for i in range(3):
        def res_of_tau(tau, i=i):
            return jkb8.project(jP, jlie.se3_apply(jlie.se3_retract(jnp.asarray(T), tau),
                                                   jnp.asarray(X[i]))) - jnp.asarray(uv[i])

        def res_of_X(Xp, i=i):
            return jkb8.project(jP, jlie.se3_apply(jnp.asarray(T), Xp)) - jnp.asarray(uv[i])

        close(Jpose_t[i], jax.jacfwd(res_of_tau)(jnp.zeros(6)), atol=5e-3, rtol=2e-3)
        close(Jpt_t[i], jax.jacfwd(res_of_X)(jnp.asarray(X[i])), atol=5e-3, rtol=2e-3)


def test_kb8_epipolar_error():
    tP, jP = both(P_FISH)
    T21 = np.asarray(jlie.se3(jlie.so3_exp(jnp.asarray([0.01, 0.03, -0.02])),
                              jnp.asarray([0.1, 0.0, 0.01])))
    X1 = fisheye_rays(64, seed=5, max_deg=60)
    X2 = np.asarray(jlie.se3_apply(jnp.asarray(T21), jnp.asarray(X1)))
    uv1, uv2 = np.asarray(jkb8.project(jP, jnp.asarray(X1))), np.asarray(jkb8.project(jP, jnp.asarray(X2)))
    uv2_bad = uv2 + 15.0
    for u2 in (uv2, uv2_bad):
        t = tkb8.epipolar_error(tP, tP, torch.from_numpy(uv1), torch.from_numpy(u2),
                                torch.from_numpy(T21))
        j = jkb8.epipolar_error(jP, jP, jnp.asarray(uv1), jnp.asarray(u2), jnp.asarray(T21))
        close(t, j, atol=1e-5, rtol=1e-4)
    assert float(t.median()) > 10 * float(tkb8.epipolar_error(
        tP, tP, torch.from_numpy(uv1), torch.from_numpy(uv2), torch.from_numpy(T21)).median())


def test_kb8_rectification_maps_onto_the_pinhole():
    """kb8.unproject then the pinhole projection: fisheye pixels of known
    points land on their ideal pinhole pixels (the JAX package's test)."""
    K = torch.tensor([280.0, 280.0, 159.5, 119.5])
    P8 = torch.cat([K, torch.tensor(KB)])
    rng = np.random.default_rng(0)
    X = torch.from_numpy(rng.uniform([-1.5, -1, 2], [1.5, 1, 8], (100, 3)).astype(np.float32))
    rect = tcam.project(K, tkb8.unproject(P8, tkb8.project(P8, X)))
    np.testing.assert_allclose(rect.numpy(), tcam.project(K, X).numpy(), atol=0.05)


# ------------------------------------------------------------------ _extract

def extract_configs(which):
    """(JAX config, port config) of the rectification case ``which``."""
    radtan = dict(zip(("k1", "k2", "p1", "p2", "k3"), map(float, DIST_TUM1)))
    if which == "radtan":
        cam = dict(fx=float(K_TUM1[0]), fy=float(K_TUM1[1]), cx=float(K_TUM1[2]),
                   cy=float(K_TUM1[3]), width=640, height=480, **radtan)
    else:
        cam = dict(model="kb8", kb_coeffs=KB, **(radtan if which == "kb8_over_radtan" else {}))
    out = []
    for c in (jax_tiny_config(), tiny_config()):
        out.append(dataclasses.replace(c, camera=dataclasses.replace(c.camera, **cam)))
    return out


@pytest.mark.parametrize("which", ["radtan", "kb8", "kb8_over_radtan"])
def test_extract_rectifies_as_jax(which):
    """``SlamSystem._extract`` on one synthetic frame: ORB, then TUM1's radtan
    undistortion or the KB8 rectification (which takes precedence over
    radtan coefficients set beside it, as in JAX).  Rows
    whose raw keypoint is the same in both packages must be rectified to
    within EXTRACT_ATOL, and the rectification must move off-centre
    keypoints."""
    jc, tc = extract_configs(which)
    w, h = tc.camera.width, tc.camera.height
    seq = JaxSequence(n_frames=1, width=w, height=h, n_points=1200 if w == 320 else 2500,
                      seed=3, patch=3)
    img = np.asarray(seq.frame(0)[0])
    js, ts = JaxSlam(jc), SlamSystem(tc, device="cpu")
    assert (js._dist is None) == (ts._dist is None)
    fj = js._extract(jnp.asarray(img))
    ft = ts._extract(torch.from_numpy(img))
    o = jc.orb
    raw_j = np.asarray(jorb.extract_orb(jnp.asarray(img), n_features=o.n_features,
                                        n_levels=o.n_levels, scale_factor=o.scale_factor,
                                        threshold=o.ini_th_fast, min_threshold=o.min_th_fast,
                                        cell=o.cell, k_cell=o.k_cell).uv)
    raw_t = ts.extractor(torch.from_numpy(img)).uv.numpy()
    same = (raw_j == raw_t).all(1) & np.asarray(fj.valid) & ft.valid.numpy()
    assert same.sum() >= 0.95 * np.asarray(fj.valid).sum()
    np.testing.assert_allclose(ft.uv.numpy()[same], np.asarray(fj.uv)[same], atol=EXTRACT_ATOL,
                               rtol=0)
    assert np.isfinite(ft.uv.numpy()).all()
    if which == "kb8_over_radtan":
        ft_kb8 = SlamSystem(extract_configs("kb8")[1], device="cpu")._extract(torch.from_numpy(img))
        assert torch.equal(ft.uv, ft_kb8.uv)
    moved = np.linalg.norm(ft.uv.numpy()[same] - raw_t[same], axis=1)
    off = np.linalg.norm(raw_t[same] - [tc.camera.cx, tc.camera.cy], axis=1) > 80
    assert moved[off].mean() > 0.5
