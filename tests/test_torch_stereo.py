"""Parity of the port's stereo and RGB-D pieces with the JAX package: the
depth front ends (``ops/stereo.py``), stereo motion-only BA
(``optim/pose_opt.pose_optimization_stereo``), stereo synthetic frames, the
stereo rows of local BA and of the mapping round on a map whose keyframes
carry real ``kf_ur``, and that map's checkpoint crossing between the
packages.

Tolerances: the front ends gate and round as JAX does, so ``ur``/``z`` and
the masks are equal (``ur`` within 1e-6 relative where it is a float32
divide); ``backproject_new_points`` keeps the same rows (ties at the
``max_new``-th depth included) and its points agree to 1e-5.
``pose_optimization_stereo``: the same inlier set, poses within 1e-4 (40
float32 LM iterations on normal equations summed in another order: 4.5e-5
measured), as ``tests/test_torch_tracking.py`` holds the monocular one.  Local
BA and the mapping round with ``use_stereo=True``: as
``tests/test_torch_mapping.py`` holds the monocular ones (poses 1e-4,
points 1e-3, at most 0.5% of the associations on the other side of the chi2
gate).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rumi_slam_tpu.config import tiny_config as jax_tiny_config
from rumi_slam_tpu.geometry import camera as jcam
from rumi_slam_tpu.geometry import lie as jlie
from rumi_slam_tpu.io.synthetic import SyntheticSequence as JaxSequence
from rumi_slam_tpu.io.synthetic import render_depth as jax_render_depth
from rumi_slam_tpu.mapstate import checkpoint as jC
from rumi_slam_tpu.mapstate import map_state as jM
from rumi_slam_tpu.ops import stereo as jst
from rumi_slam_tpu.optim import pose_opt as jpo
from rumi_slam_tpu.system import SlamSystem as JaxSlam
from rumi_slam_tpu.tracking import local_mapping as jLM
from rumi_slam_tpu.tracking import mapping_worker as jMW
from rumi_slam_tpu_torch.config import tiny_config
from rumi_slam_tpu_torch.io.synthetic import SyntheticSequence
from rumi_slam_tpu_torch.mapstate import checkpoint as tC
from rumi_slam_tpu_torch.mapstate import map_state as tM
from rumi_slam_tpu_torch.ops import stereo as tst
from rumi_slam_tpu_torch.ops.orb import Features
from rumi_slam_tpu_torch.optim import pose_opt as tpo
from rumi_slam_tpu_torch.tracking import local_mapping as tLM
from rumi_slam_tpu_torch.tracking import mapping_worker as tMW

from torch_system_drive import DEPTH_BASELINE, depth_camera, jax_draw, mapping_inputs

torch.set_num_threads(1)

POSE_ATOL = 1e-4
POINT_ATOL = 1e-3
POINT_RTOL = 1e-3
ASSOC_FLIP = 0.005
K_TINY = np.asarray([260.0, 260.0, 159.5, 119.5], np.float32)


def to_port_features(f):
    """JAX ``Features`` -> the port's (descriptors as int32 words)."""
    return Features(*(torch.from_numpy(np.array(np.asarray(x).view(np.int32)
                                                 if np.asarray(x).dtype == np.uint32
                                                 else np.asarray(x))) for x in f))


def to_jax(t_ms):
    return jM.MapState(**{k: jnp.asarray(v) for k, v in tM.to_numpy(t_ms).items()})


# ----------------------------------------------------------- stereo frames

def test_frame_stereo_renders_as_jax():
    """The right image is the scene from the left pose moved by -baseline
    along x, rendered as JAX renders it; the left image follows
    ``lost_span``, the right one does not."""
    kw = dict(n_frames=3, width=320, height=240, n_points=800, seed=3, patch=3,
              lost_span=(2, 3))
    jseq, tseq = JaxSequence(**kw), SyntheticSequence(**kw)
    for i in (0, 2):
        jl, jr, jt = jseq.frame_stereo(i, DEPTH_BASELINE)
        tl, tr, tt = tseq.frame_stereo(i, DEPTH_BASELINE)
        assert jt == tt
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert float(tl.std()) == 0.0 and float(tr.std()) > 0.0


# ------------------------------------------------------------ RGB-D depth

def test_depth_from_rgbd():
    """Nearest-neighbour sampling (half to even in both packages: pixel
    coordinates exactly at .5 go to the even neighbour), the depth factor,
    the min/max/finite gate, and clipping at the border."""
    h, w = 240, 320
    rng = np.random.default_rng(0)
    depth = rng.uniform(0.5 * 5000, 8.0 * 5000, size=(h, w)).astype(np.float32)
    depth[10, :] = 0.0
    depth[11, :] = np.inf
    depth[12, :] = np.nan
    depth[13, :] = 50.0 * 5000
    uv = np.concatenate([
        rng.uniform([2, 20], [w - 3, h - 3], size=(64, 2)),
        [[10.5, 30.5], [11.5, 31.5], [12.5, 32.0], [13.5, 33.5]],      # exactly .5
        [[40.0, 10.0], [41.0, 11.0], [42.0, 12.0], [43.0, 13.0]],      # gated rows
        [[-3.0, -2.0], [w + 4.0, h + 7.0]],                            # clipped
    ]).astype(np.float32)
    bf = float(K_TINY[0]) * DEPTH_BASELINE
    ur_t, z_t = tst.depth_from_rgbd(torch.from_numpy(depth), torch.from_numpy(uv), bf,
                                    depth_factor=5000.0, max_z=30.0)
    ur_j, z_j = jst.depth_from_rgbd(jnp.asarray(depth), jnp.asarray(uv), bf,
                                    depth_factor=5000.0, max_z=30.0)
    np.testing.assert_array_equal(z_t.numpy(), np.asarray(z_j))
    np.testing.assert_allclose(ur_t.numpy(), np.asarray(ur_j), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(ur_t.numpy() < 0, np.asarray(ur_j) < 0)
    # half to even: (10.5, 30.5) -> (10, 30), (11.5, 31.5) -> (12, 32), ...
    for row, (x, y) in zip(range(64, 68), [(10, 30), (12, 32), (12, 32), (14, 34)]):
        assert float(z_t[row]) == float(np.float32(depth[y, x]) / np.float32(5000.0))
    assert (z_t[68:72] == -1).all() and (ur_t[68:72] == -1).all()
    assert float(z_t[72]) == float(depth[0, 0] / np.float32(5000.0))
    assert float(z_t[73]) == float(depth[h - 1, w - 1] / np.float32(5000.0))


# ---------------------------------------------------------- stereo matching

@pytest.fixture(scope="module")
def stereo_features():
    """JAX's ORB features of a tiny stereo pair (the JAX test's scene) at the
    depth drives' 8 cm and at a wide 30 cm baseline, and its depth map."""
    seq = JaxSequence(n_frames=2, width=320, height=240, n_points=1200, seed=3, patch=3)
    slam = JaxSlam(depth_camera(jax_tiny_config()))
    out = {}
    for b in (DEPTH_BASELINE, 0.3):
        img_l, img_r, _ = seq.frame_stereo(0, b)
        out[b] = (slam._extract(jnp.asarray(img_l)), slam._extract(jnp.asarray(img_r)))
    dmap = np.asarray(jax_render_depth(seq.world, seq.K, seq.poses_gt[0], width=320, height=240,
                                       patch=3))
    return out, float(seq.K[0]), dmap


@pytest.mark.parametrize("baseline", [DEPTH_BASELINE, 0.3])
def test_match_stereo(stereo_features, baseline):
    """The same ``Features`` through both packages: the same matches (the
    octave-adaptive row band, the disparity window (0, bf/min_z], the octave
    gate, the cross-checked best match at ratio 1.0), so the same ``ur``
    and ``z``; at the wide baseline most depths agree with the rendered
    depth (the JAX package's own check)."""
    feats, fx, dmap = stereo_features
    fl, fr = feats[baseline]
    bf = fx * baseline
    min_z = 0.3 if baseline == 0.3 else 0.1
    ur_t, z_t = tst.match_stereo(to_port_features(fl), to_port_features(fr), bf, min_z=min_z)
    ur_j, z_j = jst.match_stereo(fl, fr, bf, min_z=min_z)
    np.testing.assert_array_equal(ur_t.numpy(), np.asarray(ur_j))
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), rtol=1e-6, atol=0)
    ok = (z_t.numpy() > 0) & np.asarray(fl.valid)
    assert ok.sum() > 30
    if baseline == 0.3:
        uvl = np.asarray(fl.uv)[ok]
        z_true = dmap[np.clip(np.round(uvl[:, 1]).astype(int), 0, 239),
                      np.clip(np.round(uvl[:, 0]).astype(int), 0, 319)]
        have = z_true > 0.3
        rel = np.abs(z_t.numpy()[ok][have] - z_true[have]) / z_true[have]
        assert len(rel) > 20 and np.mean(rel < 0.12) > 0.6 and np.median(rel) < 0.12


# ------------------------------------------------------- new points from depth

@pytest.mark.parametrize("max_new", [None, 12, 40])
def test_backproject_new_points(max_new):
    """World points of unassociated features with a valid depth; with
    ``max_new`` the closest, ties at the ``max_new``-th depth all kept (14
    rows share the 12th depth below), or all of them when fewer qualify."""
    T_cw = np.asarray(jlie.se3(jlie.so3_exp(jnp.asarray([0.02, -0.1, 0.05])),
                               jnp.asarray([0.3, -0.2, 0.6])))
    rng = np.random.default_rng(1)
    X_w = rng.uniform([-2, -2, 2], [2, 2, 8], size=(40, 3)).astype(np.float32)
    uv, z = (np.asarray(a) for a in jcam.project_world(jnp.asarray(K_TINY), jnp.asarray(T_cw),
                                                       jnp.asarray(X_w)))
    z = z.copy()
    z[14:28] = 3.25                       # a tie across the 12th depth
    z[12] = -1.0                          # no depth
    z[13] = 45.0                          # beyond th_depth
    has = np.zeros(40, bool)
    has[:10] = True                       # already associated
    valid = np.ones(40, bool)
    valid[30] = False
    args = (uv, z, has, valid)
    xyz_t, make_t = tst.backproject_new_points(
        torch.from_numpy(K_TINY), torch.from_numpy(T_cw), *map(torch.from_numpy, args),
        max_new=max_new, th_depth=40.0)
    xyz_j, make_j = jst.backproject_new_points(
        jnp.asarray(K_TINY), jnp.asarray(T_cw), *map(jnp.asarray, args), max_new=max_new,
        th_depth=40.0)
    np.testing.assert_array_equal(make_t.numpy(), np.asarray(make_j))
    np.testing.assert_allclose(xyz_t.numpy(), np.asarray(xyz_j), atol=1e-5, rtol=0)
    sel = make_t.numpy()
    assert not sel[:10].any() and not sel[[12, 13, 30]].any()
    if max_new == 12:
        assert sel.sum() == 14 and sel[14:28].all()
    else:
        assert sel.sum() == 27
        np.testing.assert_allclose(xyz_t.numpy()[sel & (z != 3.25)],
                                   X_w[sel & (z != 3.25)], atol=1e-4)


# --------------------------------------------------- stereo motion-only BA

def stereo_problem(seed=0, n=120):
    rng = np.random.default_rng(seed)
    K = jnp.asarray(K_TINY)
    T_true = jlie.se3(jlie.so3_exp(jnp.asarray([0.03, -0.05, 0.02])),
                      jnp.asarray([0.1, -0.05, 0.2]))
    X = rng.uniform([-2, -1.5, 2], [2, 1.5, 9], size=(n, 3)).astype(np.float32)
    uv, z = (np.asarray(a) for a in jcam.project_world(K, T_true, jnp.asarray(X)))
    bf = float(K_TINY[0]) * DEPTH_BASELINE
    uv = uv + rng.normal(scale=0.5, size=uv.shape).astype(np.float32)
    ur = (uv[:, 0] - bf / z + rng.normal(scale=0.5, size=n)).astype(np.float32)
    ur[::4] = -1.0                                  # mono observations
    uv[5:15] += 40.0                                # outliers
    ur[20:25] += 30.0                               # outliers in the right row only
    valid = np.ones(n, bool)
    valid[-3:] = False
    pose0 = np.asarray(jlie.se3_retract(T_true, jnp.asarray([0.02, -0.01, 0.015, 0.05,
                                                             -0.04, 0.03])))
    inv_sigma2 = rng.choice([1.0, 1 / 1.44, 1 / 2.0736], size=n).astype(np.float32)
    return bf, pose0, X, uv.astype(np.float32), ur, valid, inv_sigma2, np.asarray(T_true)


def test_pose_optimization_stereo():
    """4 rounds x 10 LM iterations with the per-row gates (7.815 where the
    right coordinate is observed, 5.991 where not), as JAX's; the stereo
    rows fix the pose from a 5 cm / 2 degree start, and the outliers of both
    kinds are classified out."""
    bf, pose0, X, uv, ur, valid, inv_sigma2, T_true = stereo_problem()
    t = tpo.pose_optimization_stereo(torch.from_numpy(K_TINY), bf, torch.from_numpy(pose0),
                                     torch.from_numpy(X), torch.from_numpy(uv),
                                     torch.from_numpy(ur), torch.from_numpy(valid),
                                     torch.from_numpy(inv_sigma2))
    j = jpo.pose_optimization_stereo(jnp.asarray(K_TINY), bf, jnp.asarray(pose0), jnp.asarray(X),
                                     jnp.asarray(uv), jnp.asarray(ur), jnp.asarray(valid),
                                     jnp.asarray(inv_sigma2))
    np.testing.assert_array_equal(t.inliers.numpy(), np.asarray(j.inliers))
    assert int(t.n_inliers) == int(j.n_inliers)
    np.testing.assert_allclose(t.pose.numpy(), np.asarray(j.pose), atol=POSE_ATOL, rtol=0)
    np.testing.assert_allclose(float(t.cost), float(j.cost), rtol=1e-4)
    inl = t.inliers.numpy()
    assert not inl[5:15].any() and not inl[20:25].any() and not inl[-3:].any()
    assert np.abs(t.pose.numpy() - T_true).max() < 5e-3
    # without inv_sigma2: the default of ones in both
    t1 = tpo.pose_optimization_stereo(torch.from_numpy(K_TINY), bf, torch.from_numpy(pose0),
                                      torch.from_numpy(X), torch.from_numpy(uv),
                                      torch.from_numpy(ur), torch.from_numpy(valid))
    j1 = jpo.pose_optimization_stereo(jnp.asarray(K_TINY), bf, jnp.asarray(pose0),
                                      jnp.asarray(X), jnp.asarray(uv), jnp.asarray(ur),
                                      jnp.asarray(valid))
    np.testing.assert_array_equal(t1.inliers.numpy(), np.asarray(j1.inliers))
    np.testing.assert_allclose(t1.pose.numpy(), np.asarray(j1.pose), atol=POSE_ATOL, rtol=0)


# ------------------------------------------- the stereo rows of local mapping

@pytest.fixture(scope="module")
def rgbd_rounds():
    """The mapping rounds of the first 12 frames of the tiny RGB-D drive:
    keyframes with real ``kf_ur`` (>= 0 where the depth map had a return)."""
    rounds, slam, _ = mapping_inputs(12, mode="rgbd")
    assert len(rounds) >= 3
    ms = rounds[-1][0]
    n_kf = int(ms.n_kf)
    assert (ms.kf_ur[:n_kf] >= 0).sum() > 0.5 * int(ms.kf_feat_valid[:n_kf].sum())
    return rounds, slam


def depth_cfgs():
    return depth_camera(jax_tiny_config()), depth_camera(tiny_config())


@pytest.mark.parametrize("fixed_ring", [0, 6])
def test_local_bundle_adjustment_stereo(rgbd_rounds, fixed_ring):
    t_ms, kf_id, _ = rgbd_rounds[0][-1]
    bf = depth_cfgs()[1].camera.bf
    K = torch.from_numpy(K_TINY)
    out_t = tLM.local_bundle_adjustment(t_ms, K, kf_id, window=5, n_iters=6, use_stereo=True,
                                        bf=bf, fixed_ring=fixed_ring)
    out_j = jLM.local_bundle_adjustment(to_jax(t_ms), jnp.asarray(K_TINY), kf_id, window=5,
                                        n_iters=6, use_stereo=True, bf=bf,
                                        fixed_ring=fixed_ring)
    np.testing.assert_allclose(out_t.kf_pose.numpy(), np.asarray(out_j.kf_pose), rtol=0,
                               atol=POSE_ATOL)
    v = t_ms.pt_valid.numpy()
    np.testing.assert_allclose(out_t.pt_xyz.numpy()[v], np.asarray(out_j.pt_xyz)[v],
                               rtol=POINT_RTOL, atol=POINT_ATOL)
    kp_t, kp_j = out_t.kf_point.numpy(), np.asarray(out_j.kf_point)
    assert (kp_t != kp_j).sum() <= ASSOC_FLIP * (kp_j >= 0).sum()
    # the stereo rows take part: the mono BA lands elsewhere
    mono = tLM.local_bundle_adjustment(t_ms, K, kf_id, window=5, n_iters=6,
                                       fixed_ring=fixed_ring)
    assert np.abs(mono.pt_xyz.numpy()[v] - out_t.pt_xyz.numpy()[v]).max() > 10 * POINT_ATOL


@pytest.mark.parametrize("which", [0, -1])
def test_run_mapping_round_stereo(rgbd_rounds, which):
    t_ms, kf_id, kf_count = rgbd_rounds[0][which]
    jc, tc = depth_cfgs()
    key = jax.random.PRNGKey(0)
    out_t = tMW.run_mapping_round(t_ms, torch.from_numpy(K_TINY), tc, kf_id, use_stereo=True,
                                  draw=jax_draw(key), kf_count=kf_count)
    out_j = jMW.run_mapping_round(to_jax(t_ms), jnp.asarray(K_TINY), jc, kf_id, use_stereo=True,
                                  key=key, kf_count=kf_count)
    assert out_t.events == out_j.events
    tm = tM.to_numpy(out_t.mapped)
    jm = {k: np.asarray(v) for k, v in out_j.mapped._asdict().items()}
    for k in ("n_pt", "pt_ref_kf", "kf_valid", "kf_ur"):
        np.testing.assert_array_equal(tm[k], jm[k], err_msg=k)
    # point 0's refresh is lost in the JAX package (ROADMAP queue 3)
    for k in ("pt_desc", "pt_octave"):
        np.testing.assert_array_equal(tm[k][1:], jm[k][1:], err_msg=k)
    np.testing.assert_allclose(tm["kf_pose"], jm["kf_pose"], rtol=0, atol=POSE_ATOL)
    assert (tm["kf_point"] != jm["kf_point"]).sum() <= ASSOC_FLIP * (jm["kf_point"] >= 0).sum()
    assert (tm["pt_valid"] != jm["pt_valid"]).sum() <= ASSOC_FLIP * jm["pt_valid"].sum()


# ------------------------------------------------------ checkpoint crossing

def test_depth_map_checkpoint_crosses(rgbd_rounds, tmp_path):
    """A depth-mode map (``kf_ur`` >= 0 in places) written by either package
    loads in the other field for field."""
    slam = rgbd_rounds[1]
    d = tM.to_numpy(slam.ms)
    assert (d["kf_ur"] >= 0).any()
    tC.save(slam.ms, tmp_path / "port.ckpt")
    j_ms = jC.load(tmp_path / "port.ckpt")
    for k, v in j_ms._asdict().items():
        np.testing.assert_array_equal(np.asarray(v), d[k], err_msg=k)
    jC.save(j_ms, tmp_path / "jax.ckpt")
    back = tM.to_numpy(tC.load(tmp_path / "jax.ckpt", device="cpu"))
    for k in d:
        np.testing.assert_array_equal(back[k], d[k], err_msg=k)
