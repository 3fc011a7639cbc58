"""Parity of the port's map state, motion-only BA, tracking step and
synthetic renderer with the JAX package, and the port's import guard."""

import ast
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rumi_slam_tpu.geometry import camera as jcam
from rumi_slam_tpu.geometry import lie as jlie
from rumi_slam_tpu.io import synthetic as jsyn
from rumi_slam_tpu.mapstate import map_state as jM
from rumi_slam_tpu.ops.orb import Features as JFeatures
from rumi_slam_tpu.optim import pose_opt as jpo
from rumi_slam_tpu.tracking import tracker as jtr
from rumi_slam_tpu_torch.io import synthetic as tsyn
from rumi_slam_tpu_torch.mapstate import map_state as tM
from rumi_slam_tpu_torch.ops.orb import Features as TFeatures
from rumi_slam_tpu_torch.optim import pose_opt as tpo
from rumi_slam_tpu_torch.tracking import tracker as ttr

torch.set_num_threads(1)

PKG = Path(__file__).resolve().parents[1] / "rumi_slam_tpu_torch"
K = np.asarray([260.0, 260.0, 159.5, 119.5], np.float32)
W, H = 320, 240
# Pose tolerance of the port against the JAX package after 18 float32 LM
# iterations: the normal equations are sums over ~100-250 residuals taken in
# another order, so each step differs in the last bits and an accept/reject
# near convergence can go either way; the pose then moves by less than the
# converged noise floor.  Measured: 3e-6 at most on these inputs.
POSE_ATOL = 1e-4


def t(a):
    return torch.from_numpy(np.array(a))


def jax_ms_numpy(ms):
    return {k: np.asarray(v) for k, v in ms._asdict().items()}


def true_pose():
    return np.asarray(jlie.se3(jlie.so3_exp(jnp.asarray([0.01, 0.03, -0.02])),
                               jnp.asarray([0.05, -0.02, 0.03])))


def perturbed(pose, seed=0):
    tau = np.random.default_rng(seed).normal(scale=[0.004] * 3 + [0.01] * 3).astype(np.float32)
    return np.asarray(jlie.se3_retract(jnp.asarray(pose), jnp.asarray(tau)))


def pose_problem(n=200, n_out=30, seed=1):
    rng = np.random.default_rng(seed)
    X = rng.uniform([-2, -1.5, 3], [2, 1.5, 8], (n, 3)).astype(np.float32)
    uv = np.asarray(jcam.project_world(jnp.asarray(K), jnp.asarray(true_pose()), jnp.asarray(X))[0])
    uv = uv + rng.normal(scale=0.5, size=uv.shape).astype(np.float32)
    uv[:n_out] += rng.uniform(-30, 30, (n_out, 2)).astype(np.float32)   # outliers
    valid = rng.random(n) > 0.05
    return X, uv.astype(np.float32), valid


# ------------------------------------------------------------- map state

def test_mapstate_roundtrip_through_numpy():
    ms = jM.empty(8, 16, 64)
    rng = np.random.default_rng(2)
    ms = ms._replace(
        pt_desc=jnp.asarray(rng.integers(0, 2**32, (64, 8), dtype=np.uint32)),
        kf_desc=jnp.asarray(rng.integers(0, 2**32, (8, 16, 8), dtype=np.uint32)),
        pt_xyz=jnp.asarray(rng.normal(size=(64, 3)).astype(np.float32)),
        pt_valid=jnp.asarray(rng.random(64) > 0.5),
        n_pt=jnp.int32(40),
    )
    d = jax_ms_numpy(ms)
    port = tM.from_numpy(d)
    assert port.pt_desc.dtype == torch.int32 and port.n_pt.shape == ()
    np.testing.assert_array_equal(port.pt_desc.numpy().view(np.uint32), d["pt_desc"])
    back = tM.to_numpy(port)
    assert back.keys() == d.keys()
    for k in d:
        assert back[k].dtype == d[k].dtype and back[k].shape == d[k].shape, k
        np.testing.assert_array_equal(back[k], d[k])
    jM.MapState(**{k: jnp.asarray(v) for k, v in back.items()})  # JAX takes it back


def test_mapstate_empty_equals_jax():
    ours = tM.to_numpy(tM.empty(4, 8, 32))
    ref = jax_ms_numpy(jM.empty(4, 8, 32))
    for k in ref:
        assert ours[k].dtype == ref[k].dtype and ours[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(ours[k], ref[k])


# ------------------------------------------------------------- pose opt

@pytest.mark.parametrize("rounds,iters", [(3, 6), (4, 10)])
def test_pose_optimization_matches_jax(rounds, iters):
    X, uv, valid = pose_problem()
    pose0 = perturbed(true_pose())
    rj = jpo.pose_optimization(jnp.asarray(K), jnp.asarray(pose0), jnp.asarray(X),
                               jnp.asarray(uv), jnp.asarray(valid), n_rounds=rounds, n_iters=iters)
    rt = tpo.pose_optimization(t(K), t(pose0), t(X), t(uv), t(valid),
                               n_rounds=rounds, n_iters=iters)
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    assert int(rt.n_inliers) == int(rj.n_inliers)
    np.testing.assert_allclose(rt.pose.numpy(), np.asarray(rj.pose), rtol=0, atol=POSE_ATOL)
    np.testing.assert_allclose(float(rt.cost), float(rj.cost), rtol=1e-3)
    assert np.abs(rt.pose.numpy() - true_pose()).max() < 5e-3  # and it converged


# ------------------------------------------------------------- track_frame

def tracking_problem(seed=3, n_pts=600, F=256, max_pt=1024):
    """A JAX map with n_pts points; F features: projections of some points
    at the true pose (with their descriptors, a few bits flipped), plus
    random clutter."""
    rng = np.random.default_rng(seed)
    X = rng.uniform([-2, -1.5, 3], [2, 1.5, 8], (n_pts, 3)).astype(np.float32)
    desc = rng.integers(0, 2**32, (n_pts, 8), dtype=np.uint32)
    ms = jM.empty(8, F, max_pt)
    ms = ms._replace(
        pt_xyz=ms.pt_xyz.at[:n_pts].set(jnp.asarray(X)),
        pt_desc=ms.pt_desc.at[:n_pts].set(jnp.asarray(desc)),
        pt_valid=ms.pt_valid.at[:n_pts].set(True),
        pt_map_id=ms.pt_map_id.at[:n_pts].set(0),
        pt_octave=ms.pt_octave.at[:n_pts].set(jnp.asarray(rng.integers(0, 3, n_pts), jnp.int32)),
        pt_angle=ms.pt_angle.at[:n_pts].set(jnp.asarray(rng.normal(0, 0.05, n_pts), jnp.float32)),
        n_pt=jnp.int32(n_pts),
    )
    src = rng.choice(n_pts, F, replace=False)
    uv = np.asarray(jcam.project_world(jnp.asarray(K), jnp.asarray(true_pose()),
                                       jnp.asarray(X[src]))[0])
    uv = uv + rng.normal(scale=0.7, size=uv.shape)
    fdesc = desc[src] ^ (rng.random((F, 8)) < 0.02).astype(np.uint32) << rng.integers(0, 32, (F, 8)).astype(np.uint32)
    clutter = rng.random(F) < 0.25
    uv[clutter] = rng.uniform([0, 0], [W, H], (clutter.sum(), 2))
    fdesc[clutter] = rng.integers(0, 2**32, (clutter.sum(), 8), dtype=np.uint32)
    feats = dict(uv=uv.astype(np.float32), response=np.ones(F, np.float32),
                 angle=rng.normal(0, 0.05, F).astype(np.float32),
                 octave=rng.integers(0, 3, F).astype(np.int32), desc=fdesc,
                 valid=rng.random(F) > 0.05)
    return ms, feats


@pytest.mark.parametrize("radius", [15.0, 30.0])
def test_track_frame_matches_jax(radius):
    ms, f = tracking_problem()
    pred = perturbed(true_pose(), seed=4)
    jf = JFeatures(**{k: jnp.asarray(v) for k, v in f.items()})
    tf = TFeatures(**{k: t(v.view(np.int32) if k == "desc" else v) for k, v in f.items()})
    ms_j, tr_j = jtr.track_frame(ms, jnp.asarray(K), jf, jnp.asarray(pred), radius,
                                 img_w=W, img_h=H, fused=False)
    ms_t, tr_t = ttr.track_frame(tM.from_numpy(jax_ms_numpy(ms)), t(K), tf, t(pred), radius,
                                 img_w=W, img_h=H)
    np.testing.assert_array_equal(tr_t.assoc.numpy(), np.asarray(tr_j.assoc))
    assert int(tr_t.n_inliers) == int(tr_j.n_inliers) > 100
    assert int(tr_t.n_candidates) == int(tr_j.n_candidates)
    np.testing.assert_allclose(tr_t.pose.numpy(), np.asarray(tr_j.pose), rtol=0, atol=POSE_ATOL)
    for k in ("pt_visible", "pt_found"):
        np.testing.assert_array_equal(getattr(ms_t, k).numpy(), np.asarray(getattr(ms_j, k)))


# ------------------------------------------------------------- renderer

def test_render_frame_and_depth_exact():
    jw = jsyn.make_world(800, seed=5)
    tw = tsyn.make_world(800, seed=5)
    for a, b in zip(jw, tw):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    Kr = np.asarray([256.0, 256.0, 159.5, 119.5], np.float32)
    pose = np.asarray(jlie.se3_inverse(jnp.asarray(true_pose())))
    img_j = jsyn.render_frame(jw, jnp.asarray(Kr), jnp.asarray(pose), width=W, height=H)
    img_t = tsyn.render_frame(tw, t(Kr), t(pose), width=W, height=H)
    np.testing.assert_array_equal(img_t.numpy(), np.asarray(img_j))
    dep_j = jsyn.render_depth(jw, jnp.asarray(Kr), jnp.asarray(pose), width=W, height=H)
    dep_t = tsyn.render_depth(tw, t(Kr), t(pose), width=W, height=H)
    # the splat footprint is exact; a depth value is the camera-frame z of
    # se3_apply, where XLA's CPU code rounds a multiply-add differently in
    # about 0.03% of the pixels (measured: 1 ulp, 4.8e-7 m)
    np.testing.assert_array_equal(dep_t.numpy() > 0, np.asarray(dep_j) > 0)
    np.testing.assert_allclose(dep_t.numpy(), np.asarray(dep_j), rtol=1e-6, atol=0)
    assert (dep_t > 0).float().mean() > 0.05 and (img_t != 40.0).float().mean() > 0.05


def test_sequence_poses_and_frames_match_jax():
    js = jsyn.SyntheticSequence(n_frames=3, width=W, height=H, n_points=500, seed=7)
    ts = tsyn.SyntheticSequence(n_frames=3, width=W, height=H, n_points=500, seed=7)
    np.testing.assert_array_equal(ts.K.numpy(), np.asarray(js.K))
    for i in range(3):
        np.testing.assert_allclose(ts.poses_gt[i].numpy(), np.asarray(js.poses_gt[i]),
                                   rtol=0, atol=1e-6)
        img, depth, tm_ = ts.frame_rgbd(i)
        assert tm_ == js.frame(i)[1] and img.shape == (H, W) and depth.shape == (H, W)
    # same pose in, same frame out
    np.testing.assert_array_equal(
        tsyn.render_frame(ts.world, ts.K, t(np.asarray(js.poses_gt[2])), width=W, height=H).numpy(),
        np.asarray(js.frame(2)[0]))


# ------------------------------------------------------------- import guard

def test_port_imports_without_jax():
    """Every module of the port imports with jax and rumi_slam_tpu blocked."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['rumi_slam_tpu'] = None\n"
        "import rumi_slam_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'rumi_slam_tpu.'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print(len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=PKG.parent, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


def test_port_sources_import_neither_jax_nor_the_jax_package():
    for path in PKG.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "rumi_slam_tpu"), (path, n)
