"""Slice-level parity: ORB extraction plus ``track_frame`` over a short
synthetic drive, in the JAX package (``fused=False``, contractually equal to
its fused Pallas path) and in the port, from one seeded map carried into
both (see tests/torch_slice_drive.py)."""

import numpy as np
import pytest
import torch

from rumi_slam_tpu_torch.config import tiny_config

from torch_slice_drive import center_error, make_drive, run_jax, run_port

torch.set_num_threads(1)

N_FRAMES = 5          # frame 0 seeds the map, frames 1-4 are tracked
POSE_ATOL = 1e-4      # see test_torch_tracking.POSE_ATOL


@pytest.fixture(scope="module")
def drives():
    cfg = tiny_config()
    frames, K, gt, ms_np = make_drive(cfg, N_FRAMES)
    return gt, ms_np, run_jax(cfg, frames, K, gt, ms_np), run_port(cfg, frames, K, gt, ms_np)


def test_seeded_map_is_real(drives):
    _, ms_np, _, _ = drives
    n = int(ms_np["n_pt"])
    assert n == 256 and ms_np["pt_valid"][:n].mean() > 0.9
    assert (ms_np["pt_xyz"][:n][ms_np["pt_valid"][:n], 2] > 0).all()


@pytest.mark.parametrize("frame", range(1, N_FRAMES))
def test_frame_matches_jax(drives, frame):
    """Identical assoc on every row whose feature both packages extracted
    identically (a row whose feature differs is named in the failure), equal
    n_inliers, and the pose within POSE_ATOL."""
    gt, _, jx, pt = drives
    a, b = jx[frame - 1], pt[frame - 1]
    same_feat = (np.all(a["uv"] == b["uv"], -1) & np.all(a["desc"] == b["desc"], -1)
                 & (a["valid"] == b["valid"]))
    diff_feat = np.flatnonzero(~same_feat).tolist()
    assert len(diff_feat) <= 0.02 * len(same_feat), f"features differ in rows {diff_feat}"
    bad = np.flatnonzero(same_feat & (a["assoc"] != b["assoc"])).tolist()
    assert not bad, f"assoc differs in rows {bad} (rows with differing features: {diff_feat})"
    assert b["n_inliers"] == a["n_inliers"] > 40
    np.testing.assert_allclose(b["pose"], a["pose"], rtol=0, atol=POSE_ATOL)
    assert center_error(b["pose"], gt[frame]) < 0.05
