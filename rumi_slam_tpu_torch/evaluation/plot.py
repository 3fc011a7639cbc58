"""Trajectory/map visualization to PNG, headless (port of
``rumi_slam_tpu/evaluation/plot.py``).

Stands in for the reference's Pangolin Viewer/MapDrawer thread and the evo
node's traj.png output.  matplotlib is imported inside each function, so the
package imports without it; per-submap coloring mirrors MapDrawer's
per-map colored points.  Map and pose tensors may live on any device; the
centres are computed there and copied to the host for drawing.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..geometry import alignment, lie


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _centres(poses_cw) -> np.ndarray:
    """Camera centres [N, 3] of world->camera poses [N, 7]."""
    T = torch.as_tensor(poses_cw, dtype=torch.float32)
    return lie.se3_t(lie.se3_inverse(T)).cpu().numpy()


def trajectory_centres(times_est, poses_est_cw, times_gt=None, poses_gt_cw=None, *,
                       align=True):
    """The centres ``plot_trajectory`` draws: the estimate's, Sim3-aligned to
    the time-associated groundtruth centres when ``align`` and at least three
    pairs exist, and the groundtruth's (None without groundtruth)."""
    from . import ate as ate_mod

    c_est = _centres(poses_est_cw) if len(poses_est_cw) else np.zeros((0, 3), np.float32)
    has_gt = poses_gt_cw is not None and len(poses_gt_cw)
    c_gt = _centres(poses_gt_cw) if has_gt else None
    if len(c_est) and has_gt and align:
        ie, ig = ate_mod.associate_by_time(times_est, times_gt)
        if len(ie) >= 3:
            S = alignment.umeyama_alignment(torch.from_numpy(c_est[ie]),
                                            torch.from_numpy(c_gt[ig]))
            c_est = lie.sim3_apply(S, torch.from_numpy(c_est)).numpy()
    return c_est, c_gt


def plot_trajectory(path, times_est, poses_est_cw, times_gt=None,
                    poses_gt_cw=None, *, align=True, title="trajectory"):
    """Top-down (x-z) trajectory plot, optionally with Sim3-aligned GT."""
    plt = _pyplot()
    c_est, c_gt = trajectory_centres(times_est, poses_est_cw, times_gt, poses_gt_cw,
                                     align=align)
    fig, ax = plt.subplots(figsize=(6, 6))
    if len(c_est):
        ax.plot(c_est[:, 0], c_est[:, 2], "b-", lw=1.2, label="estimate")
    if c_gt is not None:
        ax.plot(c_gt[:, 0], c_gt[:, 2], "k--", lw=0.8, label="groundtruth")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_title(title)
    ax.legend()
    ax.set_aspect("equal", adjustable="datalim")
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def draw_frame(path, img, feats, assoc=None, *, state="OK", title=None):
    """Frame overlay with extracted/tracked features — the reference's
    FrameDrawer (green = tracked map points, blue = extracted-only
    keypoints, status bar text)."""
    plt = _pyplot()
    img = _host(img)
    uv = _host(feats.uv)
    valid = _host(feats.valid)
    fig, ax = plt.subplots(figsize=(img.shape[1] / 80, img.shape[0] / 80))
    ax.imshow(img, cmap="gray", vmin=0, vmax=255)
    if assoc is not None:
        tracked = valid & (_host(assoc) >= 0)
        ax.plot(uv[valid & ~tracked, 0], uv[valid & ~tracked, 1], "b.", ms=2)
        ax.plot(uv[tracked, 0], uv[tracked, 1], "g+", ms=5)
        n_tr = int(tracked.sum())
    else:
        ax.plot(uv[valid, 0], uv[valid, 1], "b.", ms=2)
        n_tr = 0
    ax.set_title(
        title or f"{state} | kp: {int(valid.sum())} tracked: {n_tr}"
    )
    ax.set_axis_off()
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(path, dpi=90, bbox_inches="tight")
    plt.close(fig)


def plot_covisibility(path, ms, *, min_weight=15, title="covisibility"):
    """KF covisibility-graph drawing (MapDrawer::DrawKeyFrames graph lines:
    edges between KFs sharing >= min_weight points)."""
    from ..mapstate import map_state as M

    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 6))
    W = _host(M.covisibility(ms))
    kf_ok = _host(ms.kf_valid)
    centers = _centres(ms.kf_pose)
    ii, jj = np.nonzero(np.triu(W, 1) >= min_weight)
    for a, b in zip(ii, jj):
        if kf_ok[a] and kf_ok[b]:
            ax.plot(centers[[a, b], 0], centers[[a, b], 2], "g-", lw=0.4,
                    alpha=0.5)
    ax.plot(centers[kf_ok, 0], centers[kf_ok, 2], "r.", ms=4)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_title(title)
    ax.set_aspect("equal", adjustable="datalim")
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)


def plot_map(path, ms, *, title="map"):
    """Top-down map scatter: points colored per submap + KF trajectory."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 6))
    pts = _host(ms.pt_xyz)
    valid = _host(ms.pt_valid)
    mids = _host(ms.pt_map_id)
    for m in np.unique(mids[valid]):
        sel = valid & (mids == m)
        ax.scatter(pts[sel, 0], pts[sel, 2], s=1.0, alpha=0.4, label=f"map {m}")
    kf_ok = _host(ms.kf_valid)
    if kf_ok.any():
        centers = _centres(ms.kf_pose)[kf_ok]
        ax.plot(centers[:, 0], centers[:, 2], "r.-", ms=3, lw=0.8, label="KFs")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_title(title)
    ax.legend(markerscale=4)
    ax.set_aspect("equal", adjustable="datalim")
    if hasattr(path, "write"):          # file-like (LiveViewer streaming)
        fig.savefig(path, dpi=110, bbox_inches="tight", format="png")
    else:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
