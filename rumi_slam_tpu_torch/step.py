"""The per-frame monocular tracking step on the port: ORB extraction, then
``tracker.track_frame``.  Counterpart of ``__graft_entry__.entry()`` and
``bench.build_step`` of the JAX package, plus the helpers of a tracked drive
over a synthetic sequence.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .config import Config
from .geometry import camera, lie
from .io.synthetic import SyntheticSequence
from .mapstate import map_state as M
from .ops.orb import ORBExtractor
from .tracking import tracker


class TrackingStep(nn.Module):
    """``forward(img, ms, pose) -> (pose, n_inliers)``: extract ORB features
    from ``img`` [H, W] and track them against ``ms`` around ``pose``."""

    def __init__(self, cfg: Config, K):
        super().__init__()
        o = cfg.orb
        self.cfg = cfg
        self.register_buffer("K", K, persistent=False)
        self.extractor = ORBExtractor(
            n_features=o.n_features, n_levels=o.n_levels,
            scale_factor=o.scale_factor, threshold=o.ini_th_fast,
            min_threshold=o.min_th_fast, cell=o.cell, k_cell=o.k_cell,
        )

    def track(self, feats, ms, pose):
        c = self.cfg.camera
        return tracker.track_frame(ms, self.K, feats, pose, self.cfg.tracking.match_radius,
                                   img_w=c.width, img_h=c.height)

    def forward(self, img, ms, pose):
        _, tr = self.track(self.extractor(img), ms, pose)
        return tr.pose, tr.n_inliers


def bench_map(cfg: Config, device, n_seed: int = 2048) -> M.MapState:
    """The JAX bench's map: ``n_seed`` random points with random descriptors
    from seed 0 (``bench.py`` and ``__graft_entry__.entry``)."""
    ms = M.empty(cfg.mapping.max_kf, cfg.orb.n_features, cfg.mapping.max_pt, device)
    rng = np.random.default_rng(0)
    xyz = rng.uniform([-3, -2, 2], [3, 2, 12], (n_seed, 3)).astype(np.float32)
    desc = rng.integers(0, 2**32, (n_seed, 8), dtype=np.uint32).view(np.int32)
    ms.pt_xyz[:n_seed] = torch.from_numpy(xyz).to(device)
    ms.pt_desc[:n_seed] = torch.from_numpy(desc).to(device)
    ms.pt_valid[:n_seed] = True
    ms.pt_map_id[:n_seed] = 0
    return ms._replace(n_pt=torch.full((), n_seed, dtype=torch.int32, device=device))


def build_step(cfg: Config | None = None, n_features: int | None = None,
               device="cuda", n_frames: int = 32):
    """The bench step at a feature budget.

    Returns (step, frames, ms, pose): the ``TrackingStep``, ``n_frames``
    distinct rendered frames of ``SyntheticSequence(seed=7)`` on ``device``,
    the bench map and the identity pose.
    """
    cfg = cfg or Config()
    if n_features is not None:
        cfg = dataclasses.replace(cfg, orb=dataclasses.replace(cfg.orb, n_features=n_features))
    c = cfg.camera
    step = TrackingStep(cfg, cfg.intrinsics(device)).to(device)
    seq = SyntheticSequence(n_frames=n_frames, width=c.width, height=c.height,
                            n_points=3000, seed=7, device=device)
    frames = [seq.frame(i)[0] for i in range(len(seq))]
    return step, frames, bench_map(cfg, device), lie.se3_identity(device=device)


def seed_map_from_depth(feats, depth, K, T_cw, cfg: Config) -> M.MapState:
    """A map built from one frame's own features: each valid feature is
    back-projected through the rendered depth at the pose ``T_cw`` and keeps
    its descriptor, octave and angle (point slot i = feature i).

    FAST corners sit on splat edges, so the depth is the nearest return in
    the 3x3 neighbourhood of the keypoint's pixel; features with none stay
    invalid.  A helper for tracked drives: it gives the tracker real
    matches to find.
    """
    n = feats.capacity
    if n > cfg.mapping.max_pt:
        raise ValueError(f"{n} features do not fit max_pt={cfg.mapping.max_pt}")
    h, w = depth.shape
    inv = torch.where(depth > 0, depth, float("inf"))
    near = -F.max_pool2d(-inv[None, None], 3, 1, 1)[0, 0]
    x = torch.clamp(torch.round(feats.uv[:, 0]), 0, w - 1).long()
    y = torch.clamp(torch.round(feats.uv[:, 1]), 0, h - 1).long()
    z = near[y, x]
    ok = feats.valid & torch.isfinite(z)
    X_c = camera.unproject(K, feats.uv, torch.where(ok, z, 1.0))
    X_w = lie.se3_apply(lie.se3_inverse(T_cw), X_c)

    ms = M.empty(cfg.mapping.max_kf, n, cfg.mapping.max_pt, depth.device)
    ms.pt_xyz[:n] = X_w
    ms.pt_desc[:n] = feats.desc
    ms.pt_valid[:n] = ok
    ms.pt_map_id[:n] = torch.where(ok, 0, -1).to(torch.int32)
    ms.pt_octave[:n] = feats.octave
    ms.pt_angle[:n] = feats.angle
    return ms._replace(n_pt=torch.full((), n, dtype=torch.int32, device=depth.device))


def constant_velocity(T_prev, T_prev2):
    """Constant-velocity prediction (T_prev * T_prev2^-1) * T_prev of a
    world->camera pose: the last inter-frame motion applied once more."""
    return lie.se3_compose(lie.se3_compose(T_prev, lie.se3_inverse(T_prev2)), T_prev)


def camera_center(T_cw):
    return lie.se3_inverse(T_cw)[..., 4:7]
