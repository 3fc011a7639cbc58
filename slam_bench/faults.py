"""Faults planted under the timed path, for the tests that show ``correct``
comes out false and for ``slam_bench.control``'s upper readings.  The
benchmark's own runs plant none.  Each installer takes the run's system and
returns a function that takes the fault out again.
"""

from __future__ import annotations

import torch


def state_unchanged(slam):
    """Motion-only pose optimisation returns the predicted pose unchanged,
    every matched point an inlier (a step that returns its state)."""
    from rumi_slam_tpu_torch.optim import pose_opt

    orig = pose_opt.pose_optimization

    def pose_optimization(K, pose0, X_w, uv, valid, inv_sigma2=None, **kw):
        n = torch.sum(valid.to(torch.int32))
        return pose_opt.PoseOptResult(pose=pose0, inliers=valid, n_inliers=n,
                                      cost=torch.zeros((), device=pose0.device))

    pose_opt.pose_optimization = pose_optimization
    return lambda: setattr(pose_opt, "pose_optimization", orig)


def half_batch(slam):
    """ORB extraction leaves out the second half of each frame's features."""
    orig = slam._extract

    def extract(img):
        f = orig(img)
        keep = torch.arange(f.valid.shape[0], device=f.valid.device) < f.valid.shape[0] // 2
        return f._replace(valid=f.valid & keep)

    slam._extract = extract
    return lambda: setattr(slam, "_extract", orig)


def answer_altered(slam):
    """The fused matcher's answer is altered where it is produced: every
    fourth matched query points at the next map point."""
    from rumi_slam_tpu_torch.tracking import tracker

    orig = tracker.fused_match

    def fused_match(*args, **kw):
        idx, dist = orig(*args, **kw)
        rows = torch.arange(idx.shape[0], device=idx.device)
        n_p = args[1].shape[0]
        alter = (idx >= 0) & (rows % 4 == 0)
        return torch.where(alter, (idx + 1) % n_p, idx), dist

    tracker.fused_match = fused_match
    return lambda: setattr(tracker, "fused_match", orig)


def mapping_unchanged(slam):
    """The mapping round's local bundle adjustment returns its map unchanged."""
    from rumi_slam_tpu_torch.tracking import local_mapping

    orig = local_mapping.local_bundle_adjustment

    def local_bundle_adjustment(ms, *args, **kw):
        return ms

    local_mapping.local_bundle_adjustment = local_bundle_adjustment
    return lambda: setattr(local_mapping, "local_bundle_adjustment", orig)


FAULTS = {f.__name__: f for f in (state_unchanged, half_batch, answer_altered,
                                  mapping_unchanged)}
