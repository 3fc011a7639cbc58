"""Trajectory evaluation: ATE RMSE after a Sim3 alignment (port of
``rumi_slam_tpu/evaluation/ate.py``)."""

from __future__ import annotations

import numpy as np
import torch

from ..geometry import alignment, lie


def associate_by_time(t_est, t_gt, max_dt=0.02):
    """Greedy nearest-timestamp association. Returns (idx_est, idx_gt)."""
    t_est = np.asarray(t_est)
    t_gt = np.asarray(t_gt)
    ie, ig = [], []
    for i, te in enumerate(t_est):
        j = int(np.argmin(np.abs(t_gt - te)))
        if abs(t_gt[j] - te) <= max_dt:
            ie.append(i)
            ig.append(j)
    return np.asarray(ie, np.int64), np.asarray(ig, np.int64)


def ate_rmse(p_est, p_gt, *, with_scale=True, return_errors=False):
    """ATE RMSE after closed-form Sim3 alignment of positions [N, 3]."""
    p_est = torch.as_tensor(p_est, dtype=torch.float32).cpu()
    p_gt = torch.as_tensor(p_gt, dtype=torch.float32).cpu()
    S = alignment.umeyama_alignment(p_est, p_gt, with_scale=with_scale)
    err = torch.linalg.vector_norm(lie.sim3_apply(S, p_est) - p_gt, dim=-1)
    rmse = float(torch.sqrt(torch.mean(err ** 2)))
    if return_errors:
        return rmse, err.numpy()
    return rmse


def evaluate_trajectory(times_est, poses_est_cw, times_gt, poses_gt_cw, *, max_dt=0.02,
                        with_scale=True):
    """evo-style evaluation of world->camera poses [N, 7] (positions are the
    camera centres).  Returns dict(ate, rate, n_matched, err_p50/p90/max)."""
    ie, ig = associate_by_time(times_est, times_gt, max_dt)
    if len(ie) < 3:
        return {"ate": float("inf"), "rate": 0.0, "n_matched": int(len(ie))}

    def centers(poses, rows):
        T = torch.as_tensor(np.asarray(poses, np.float32)[rows])
        return lie.se3_t(lie.se3_inverse(T))

    ate, err = ate_rmse(centers(poses_est_cw, ie), centers(poses_gt_cw, ig),
                        with_scale=with_scale, return_errors=True)
    dur_est = float(np.asarray(times_est)[ie].max() - np.asarray(times_est)[ie].min())
    dur_gt = float(np.asarray(times_gt).max() - np.asarray(times_gt).min())
    return {
        "ate": ate,
        "rate": dur_est / max(dur_gt, 1e-9),
        "n_matched": int(len(ie)),
        "err_p50": float(np.median(err)),
        "err_p90": float(np.quantile(err, 0.9)),
        "err_max": float(np.max(err)),
    }
