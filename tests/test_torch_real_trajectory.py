"""The port's ``io/real_trajectory.py`` against the JAX package's on the
same inputs: ``resample_trajectory`` (the same numpy code: equal),
``world_along_trajectory`` (landmarks within 1e-5 m: ``lie`` in float32 in
both), ``degrade_frame`` (within 1e-3 grey levels: a float32 blur in both),
and ``GroundtruthSequence`` over a ``groundtruth.txt`` written by the port's
``io/trajectory.save_tum`` from a synthetic sweep: the same times, poses
within 1e-5 and frames that agree on at least 99.9% of pixels (a landmark
1 ulp apart can round to the neighbouring pixel)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rumi_slam_tpu.io import real_trajectory as jrt
from rumi_slam_tpu_torch.io import real_trajectory as trt
from rumi_slam_tpu_torch.io import synthetic as tsyn
from rumi_slam_tpu_torch.io import trajectory as ttio


@pytest.fixture()
def gt_file(tmp_path):
    """A 2 s sweep at ~90 Hz (mocap cadence), written as TUM groundtruth."""
    poses, _ = tsyn.sweep_trajectory(180, seed=5)
    times = 1305031102.0 + np.arange(180) / 90.0
    d = tmp_path / "rgbd_dataset_fake"
    d.mkdir()
    ttio.save_tum(d / "groundtruth.txt", times, torch.stack(poses).numpy())
    return str(d / "groundtruth.txt")


def test_load_and_resample_as_jax(gt_file):
    a, b = trt.load_tum_groundtruth(gt_file), jrt.load_tum_groundtruth(gt_file)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    for fps in (30.0, 20.0):
        ra, rb = trt.resample_trajectory(*a, fps=fps), jrt.resample_trajectory(*b, fps=fps)
        np.testing.assert_array_equal(ra[0], rb[0])
        np.testing.assert_array_equal(ra[1], rb[1])


def test_world_along_trajectory_as_jax(gt_file):
    _, T_wc = trt.resample_trajectory(*trt.load_tum_groundtruth(gt_file))
    K = np.array([256.0, 256.0, 159.5, 119.5], np.float32)
    poses_cw = trt.lie.se3_inverse(torch.from_numpy(T_wc))
    a = trt.world_along_trajectory(torch.from_numpy(K), poses_cw, 300, 7, 320, 240)
    b = jrt.world_along_trajectory(jnp.asarray(K), poses_cw.numpy(), 300, 7, 320, 240)
    np.testing.assert_allclose(a.xyz.numpy(), np.asarray(b.xyz), atol=1e-5, rtol=0)
    for f in ("intensity", "size", "tex"):
        np.testing.assert_array_equal(getattr(a, f).numpy(), np.asarray(getattr(b, f)))


def test_degrade_frame_as_jax():
    img = np.random.default_rng(2).uniform(0, 255, (48, 64)).astype(np.float32)
    a = trt.degrade_frame(torch.from_numpy(img))
    b = jrt.degrade_frame(jnp.asarray(img))
    np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-3, rtol=0)


@pytest.mark.parametrize("gap_mode", ["degraded", "featureless"])
def test_groundtruth_sequence_as_jax(gt_file, gap_mode):
    kw = dict(width=160, height=120, n_points=600, seed=3, lost_span_s=(0.5, 0.7),
              duration_s=1.5, gap_mode=gap_mode)
    a = trt.GroundtruthSequence(gt_file, device="cpu", **kw)
    b = jrt.GroundtruthSequence(gt_file, **kw)
    assert len(a) == len(b) == 45 and a.name == b.name == "rgbd_dataset_fake"
    assert a.lost_span == b.lost_span == (16, 22)
    np.testing.assert_array_equal(a.times, b.times)
    np.testing.assert_allclose(torch.stack(a.poses_gt).numpy(),
                               np.stack([np.asarray(p) for p in b.poses_gt]), atol=1e-5, rtol=0)
    for i in (0, 10, 16, 21, 44):
        fa, ta = a.frame(i)
        fb, tb = b.frame(i)
        assert ta == tb and fa.shape == (120, 160)
        same = np.isclose(fa.numpy(), np.asarray(fb), atol=1e-3)
        assert same.mean() >= 0.999, (i, same.mean())


def test_groundtruth_sequence_needs_a_path():
    with pytest.raises(ValueError):
        trt.GroundtruthSequence("rgbd_dataset_freiburg1_floor", device="cpu")
