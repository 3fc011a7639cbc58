"""``tests/test_parallel.py::make_problem``'s construction in the port: the
same numpy draws in the same order, projected with the port's ``camera`` and
``lie``, so it runs where JAX is absent (``chip_smoke.py`` phase 13 (b),
``tests/test_torch_cuda.py``).  ``tests/test_torch_parallel.py`` holds it to
JAX's within float32 rounding.

Returns numpy arrays: (poses [C,7], poses_n [C,7] (cameras 2.. moved),
X_n [P,3] (moved), cam_idx [C*P], pt_idx [C*P], uv [C*P,2], conf [C*P]).
Every camera observes every point.
"""

from __future__ import annotations

import numpy as np

K = [300.0, 300.0, 127.5, 95.5]


def make_problem(n_cams=6, n_pts=64, seed=3):
    import torch

    from rumi_slam_tpu_torch.geometry import camera, lie

    Kt = torch.tensor(K)
    rng = np.random.default_rng(seed)
    X = rng.uniform([-3, -2, 4], [3, 2, 9], size=(n_pts, 3)).astype(np.float32)
    poses = []
    for i in range(n_cams):
        q = lie.so3_exp(torch.from_numpy(rng.normal(scale=0.02, size=3).astype(np.float32)))
        poses.append(np.concatenate([q.numpy(), np.array([0.3 * i, 0, 0], np.float32)]))
    poses = np.stack(poses)
    uv = np.zeros((n_cams, n_pts, 2), np.float32)
    for i in range(n_cams):
        p, _ = camera.project_world(Kt, torch.from_numpy(poses[i]), torch.from_numpy(X))
        uv[i] = p.numpy() + rng.normal(scale=0.3, size=(n_pts, 2))
    cam_idx = np.repeat(np.arange(n_cams), n_pts).astype(np.int32)
    pt_idx = np.tile(np.arange(n_pts), n_cams).astype(np.int32)
    conf = np.ones(n_cams * n_pts, np.float32)
    poses_n = lie.se3_retract(torch.from_numpy(poses), torch.from_numpy(
        rng.normal(scale=0.01, size=(n_cams, 6)).astype(np.float32))).numpy()
    poses_n[:2] = poses[:2]
    X_n = X + rng.normal(scale=0.05, size=X.shape).astype(np.float32)
    return poses, poses_n, X_n, cam_idx, pt_idx, uv.reshape(-1, 2), conf


def scatter_points(X, rows, n_pts):
    """Points into the shard-major ``[D*Pl, 3]`` layout of a partition's
    ``point_rows``; padding slots stay at the origin."""
    D, Pl = rows.shape
    pts = np.zeros((D, Pl, 3), np.float32)
    for d in range(D):
        ok = rows[d] < n_pts
        pts[d, ok] = X[rows[d][ok]]
    return pts.reshape(D * Pl, 3)


def gather_points(pts_sh, rows, n_pts):
    """The inverse of ``scatter_points``."""
    D, Pl = rows.shape
    pts_sh = np.asarray(pts_sh).reshape(D, Pl, 3)
    out = np.zeros((n_pts, 3), np.float32)
    for d in range(D):
        ok = rows[d] < n_pts
        out[rows[d][ok]] = pts_sh[d][ok]
    return out


def dense_inputs(problem, D):
    """``sharded_bundle_adjust``'s arguments after ``poses`` (numpy), and the
    partition's point rows, for ``make_problem``'s output."""
    from rumi_slam_tpu_torch.parallel import sharded_ba

    _, poses_n, X_n, cam_idx, pt_idx, uv, conf = problem
    n = X_n.shape[0]
    part = sharded_ba.partition_problem(cam_idx, pt_idx, uv, conf, n, D)
    free = np.arange(poses_n.shape[0]) >= 2
    return (scatter_points(X_n, part["point_rows"], n), part["cam_idx"].reshape(-1),
            part["pt_local"].reshape(-1), part["uv"].reshape(-1, 2),
            part["conf"].reshape(-1), free), part["point_rows"]


def pcg_inputs(problem, D):
    """``sharded_bundle_adjust_pcg``'s arguments after ``poses`` (numpy),
    and the partition's point rows; R = the camera count, nothing dropped."""
    from rumi_slam_tpu_torch.parallel import sharded_ba

    _, poses_n, X_n, cam_idx, pt_idx, uv, conf = problem
    n, C = X_n.shape[0], poses_n.shape[0]
    part = sharded_ba.partition_problem_grouped(cam_idx, pt_idx, uv, conf, n, D, C)
    assert part["dropped_obs"] == 0
    DPl = D * part["pts_per_shard"]
    free = np.arange(C) >= 2
    return (scatter_points(X_n, part["point_rows"], n), part["cam_idx"].reshape(DPl, -1),
            part["uv"].reshape(DPl, -1, 2), part["conf"].reshape(DPl, -1),
            free), part["point_rows"]
