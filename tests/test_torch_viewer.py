"""The port's viewers and plots (``evaluation/viewer.py``,
``evaluation/plot.py``) under the contract of ``tests/test_viewer.py`` and
``tests/test_settings_io.py::test_draw_frame_and_covisibility`` — the files
are written (non-trivial PNGs), the live viewer serves its page, stats and
map — and the centres ``plot_trajectory`` draws, Sim(3)-aligned to the
groundtruth, against the JAX package's own computation (within 1e-4 m:
Umeyama in float32 in both)."""

import enum
import json
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rumi_slam_tpu.evaluation import ate as jate
from rumi_slam_tpu.geometry import alignment as jalign
from rumi_slam_tpu.geometry import lie as jlie
from rumi_slam_tpu_torch.evaluation import plot
from rumi_slam_tpu_torch.evaluation.viewer import LiveViewer, MapViewer
from rumi_slam_tpu_torch.geometry import lie
from rumi_slam_tpu_torch.io import synthetic
from rumi_slam_tpu_torch.mapstate import map_state as M
from rumi_slam_tpu_torch.ops.orb import Features

pytest.importorskip("matplotlib")

PNG = b"\x89PNG\r\n\x1a\n"


class _FakeSlam:
    def __init__(self):
        ms = M.empty(8, 16, 64, device="cpu")
        rng = np.random.default_rng(0)
        kf_valid = ms.kf_valid.clone()
        kf_valid[:3] = True
        kf_map = ms.kf_map_id.clone()
        kf_map[:3] = 0
        self.ms = ms._replace(
            kf_valid=kf_valid, kf_map_id=kf_map, n_kf=torch.tensor(3, dtype=torch.int32),
            pt_xyz=torch.from_numpy(rng.normal(size=(64, 3)).astype(np.float32)),
            pt_valid=torch.ones(64, dtype=torch.bool),
            pt_map_id=torch.zeros(64, dtype=torch.int32))


def test_viewer_snapshots(tmp_path):
    v = MapViewer(_FakeSlam(), tmp_path, period_s=0.15, draw_covisibility=True).start()
    time.sleep(0.6)
    v.stop()
    pngs = list(tmp_path.glob("map_*.png"))
    assert len(pngs) >= 2
    assert all(p.stat().st_size > 1000 for p in pngs)
    assert len(list(tmp_path.glob("covis_*.png"))) == len(pngs)


def test_live_viewer_http():
    class _S(enum.Enum):
        OK = 1

    slam = _FakeSlam()
    slam.stats = {"n_kf": 3}
    slam.state = _S.OK
    v = LiveViewer(slam, port=0, period_s=0.2).start()
    port = v.port
    assert port > 0
    try:
        html = urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=10).read()
        assert b"rumi_slam_tpu_torch live" in html
        stats = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/stats", timeout=10).read())
        assert stats["n_kf"] == 3 and stats["state"] == "OK"
        assert stats["n_maps"] == 1 and stats["active_map"] == 0
        png = urllib.request.urlopen(f"http://127.0.0.1:{port}/map.png", timeout=30).read()
        assert png[:8] == PNG and len(png) > 1000
    finally:
        v.stop()


def test_draw_frame_and_covisibility(tmp_path):
    n = 32
    feats = Features(
        uv=torch.from_numpy(np.random.default_rng(0).uniform(0, 100, (n, 2)).astype(np.float32)),
        response=torch.ones(n), angle=torch.zeros(n),
        octave=torch.zeros(n, dtype=torch.int32), desc=torch.zeros((n, 8), dtype=torch.int32),
        valid=torch.ones(n, dtype=torch.bool))
    img = np.random.default_rng(1).uniform(0, 255, (120, 160))
    assoc = torch.where(torch.arange(n) % 2 == 0, 1, -1)
    plot.draw_frame(tmp_path / "frame.png", img, feats, assoc)
    assert (tmp_path / "frame.png").stat().st_size > 1000
    plot.draw_frame(tmp_path / "frame_plain.png", torch.from_numpy(img), feats)
    assert (tmp_path / "frame_plain.png").stat().st_size > 1000

    plot.plot_covisibility(tmp_path / "covis.png", M.empty(8, n, 64, device="cpu"))
    assert (tmp_path / "covis.png").stat().st_size > 1000
    plot.plot_map(tmp_path / "map.png", _FakeSlam().ms)
    assert (tmp_path / "map.png").read_bytes()[:8] == PNG


def jax_aligned_centres(times_est, poses_est, times_gt, poses_gt):
    """The centres the JAX package's ``plot_trajectory`` draws."""
    inv = jax.vmap(jlie.se3_inverse)
    c_est = np.asarray(jlie.se3_t(inv(jnp.asarray(poses_est))))
    ie, ig = jate.associate_by_time(times_est, times_gt)
    c_gt_m = np.asarray(jlie.se3_t(inv(jnp.asarray(poses_gt[ig]))))
    S = jalign.umeyama_alignment(jnp.asarray(c_est[ie]), jnp.asarray(c_gt_m))
    return (np.asarray(jlie.sim3_apply(S, jnp.asarray(c_est))),
            np.asarray(jlie.se3_t(inv(jnp.asarray(poses_gt)))))


def test_trajectory_centres_as_jax(tmp_path):
    poses, times = synthetic.sweep_trajectory(40, seed=3)
    gt = torch.stack(poses).numpy()
    # an estimate: every other frame, scaled by 0.7 and perturbed
    rng = np.random.default_rng(4)
    est = gt[::2].copy()
    est[:, 4:] = 0.7 * est[:, 4:] + 0.01 * rng.normal(size=(len(est), 3)).astype(np.float32)
    est[:, :4] = lie.quat_normalize(torch.from_numpy(
        est[:, :4] + 0.01 * rng.normal(size=(len(est), 4)).astype(np.float32))).numpy()
    t_est = times[::2] + 0.004
    c_est, c_gt = plot.trajectory_centres(t_est, est, times, gt)
    j_est, j_gt = jax_aligned_centres(t_est, est, times, gt)
    np.testing.assert_allclose(c_est, j_est, atol=1e-4, rtol=0)
    np.testing.assert_allclose(c_gt, j_gt, atol=1e-6, rtol=0)
    raw, _ = plot.trajectory_centres(t_est, est, times, gt, align=False)
    np.testing.assert_allclose(raw, np.asarray(jlie.se3_t(jax.vmap(jlie.se3_inverse)(
        jnp.asarray(est)))), atol=1e-6, rtol=0)
    plot.plot_trajectory(tmp_path / "traj.png", t_est, est, times, gt)
    assert (tmp_path / "traj.png").stat().st_size > 1000
