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


def stereo_bf_scaled(slam):
    """Scanline matching is handed ``bf * 1.05``: every stereo depth 5% too
    far, while local BA keeps the configuration's bf and pulls the map back
    (``baseline_scaled`` is the consistent scale fault)."""
    from rumi_slam_tpu_torch.ops import stereo

    orig = stereo.match_stereo

    def match_stereo(feats_l, feats_r, bf, **kw):
        return orig(feats_l, feats_r, bf * 1.05, **kw)

    stereo.match_stereo = match_stereo
    return lambda: setattr(stereo, "match_stereo", orig)


def baseline_scaled(slam):
    """The program is handed a camera whose baseline is 1.05 times the
    configuration's, everywhere it reads it (scanline matching's and local
    BA's ``bf``): a depth sensor's map and path at 1.05 times the world's
    scale, and each part of the program consistent with the others."""
    import dataclasses

    cfg = slam.cfg
    cam = dataclasses.replace(cfg.camera, baseline=cfg.camera.baseline * 1.05)
    wrong = dataclasses.replace(cfg, camera=cam)
    owners = [o for o in (slam, slam.mapper) if o is not None]
    for o in owners:
        o.cfg = wrong

    def undo():
        for o in owners:
            o.cfg = cfg
    return undo


def stereo_match_moved(slam):
    """Scanline matching's answer is altered where it is produced: every
    fourth matched left feature takes the next right feature.  Only the
    stereo module sees the altered ``match`` (its own name ``matcher`` is
    pointed at a copy of the matcher module), so tracking and mapping on
    other threads match as they do."""
    import types

    from rumi_slam_tpu_torch.ops import matcher, stereo

    def match(dist, valid_a, valid_b, **kw):
        idx, best = matcher.match(dist, valid_a, valid_b, **kw)
        rows = torch.arange(idx.shape[0], device=idx.device)
        alter = (idx >= 0) & (rows % 4 == 0)
        return torch.where(alter, (idx + 1) % dist.shape[1], idx), best

    stereo.matcher = types.SimpleNamespace(**{**vars(matcher), "match": match})
    return lambda: setattr(stereo, "matcher", matcher)


FAULTS = {f.__name__: f for f in (state_unchanged, half_batch, answer_altered,
                                  mapping_unchanged, stereo_bf_scaled, baseline_scaled,
                                  stereo_match_moved)}
