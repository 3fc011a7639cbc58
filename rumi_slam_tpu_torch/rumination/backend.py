"""Rumination backend: the non-realtime side that builds the back submap
(port of ``rumi_slam_tpu/rumination/backend.py``).

The backend is the package's own SLAM run offline over the uploaded bundle
(no realtime pacing, generous per-frame budgets, ~30-130 frames), and it
only has to produce the CloudMap contract.  Its ``SlamSystem`` lives on the
same device as the caller's unless told otherwise; on the card every bundle
frame tracks through the fused matcher, and the weld between the backend's
own submaps runs ``tracker.relocalize_map`` (the matcher's gate-off mode)
once per source keyframe tried.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..geometry import lie
from ..mapstate import map_state as M
from ..ops import image as I
from ..ops import orb
from ..optim import ransac
from ..system import SlamSystem, TrackState
from ..tracking import tracker
from ..tracking.local_mapping import global_bundle_adjustment
from . import cloud_map
from .merge import correct_poses
from .sampler import RecordedFrame


class RuminationBackend:
    """Builds a back submap from an upload bundle of frames."""

    #: appearance-homogenisation blur sigma for bundle frames (see
    #: ``_normalize``); 0 disables
    BUNDLE_BLUR_SIGMA = 2.5

    def __init__(self, config: Config, *, device="cuda"):
        """``device``: where the offline system runs; the card by default
        (a host without one raises when ``build`` starts), ``"cpu"`` for the
        CPU."""
        self.device = torch.device(device)
        # forensics of the most recent cross-gap weld
        self.last_weld_info: Optional[dict] = None
        self.last_weld_tries: Optional[dict] = None

        # offline budgets: the bundle is short and paid for once, so keyframe
        # every frame and give up on dead frames fast
        self.cfg = dataclasses.replace(
            config,
            # offline: every mapping round runs inline, on the caller's thread
            # and CUDA stream (no worker thread per build)
            mapping=dataclasses.replace(config.mapping, overlapped=False),
            tracking=dataclasses.replace(
                config.tracking,
                kf_min_interval=1,
                # never reset: try relocalisation briefly, then open a second
                # submap for the back side; build() welds the two afterwards
                reloc_window_s=0.35,
                new_map_min_kf=3,
                new_map_min_duration_s=0.05,
                match_radius=60.0,
                match_radius_wide=120.0,
                # bundle images are KF-subsampled (big inter-frame baselines)
                init_min_matches=max(40, config.tracking.init_min_matches // 2),
                init_min_inliers=max(30, config.tracking.init_min_inliers // 2),
            ),
            # lower FAST thresholds: bundle frames are blur-homogenised
            # (_normalize), which damps the corner response across the board
            orb=dataclasses.replace(
                config.orb, n_features=max(512, config.orb.n_features),
                ini_th_fast=12.0, min_th_fast=5.0,
            ),
        )

    @classmethod
    def _normalize(cls, img, device="cpu") -> torch.Tensor:
        """Homogenise a bundle frame's appearance: blur the sharp frames to
        the loss gap's smoothness, then restore the dynamic range, so that
        descriptors match across the appearance boundary at the gap.  Takes a
        host array or a tensor, returns a float32 tensor on ``device``; a
        truly blank frame (std < 1) comes back as it is."""
        img = torch.as_tensor(np.asarray(img, np.float32) if not isinstance(img, torch.Tensor)
                              else img, dtype=torch.float32, device=device)
        s = float(img.std(unbiased=False))
        if s < 1.0:
            return img
        if cls.BUNDLE_BLUR_SIGMA > 0:
            img = I.gaussian_blur(img, sigma=cls.BUNDLE_BLUR_SIGMA,
                                  radius=int(3 * cls.BUNDLE_BLUR_SIGMA))
            s = max(float(img.std(unbiased=False)), 1e-3)
        return torch.clamp((img - img.mean()) * (48.0 / s) + 110.0, 0.0, 255.0)

    def build(self, bundle: list[RecordedFrame], anchor_times=(),
              anchor_split: Optional[float] = None) -> Optional[cloud_map.CloudMap]:
        """Run offline SLAM over the bundle; return one spanning submap as a
        CloudMap, or None if the reconstruction failed.

        ``anchor_times``: timestamps at which the edge holds keyframes; the
        backend forces keyframes there, so that the CloudMap shares exact
        timestamps with the live maps (the merge's association key).
        ``anchor_split``: a time strictly between the front-map and back-map
        anchors; when given, the returned map must hold keyframes on both
        sides of it.

        If the loss gap split the reconstruction into two submaps, they are
        welded with a PnP-anchored Sim(3) (``_weld_submaps``) and the welded
        map gets a global BA.
        """
        anchor_times = np.asarray(sorted(anchor_times))
        slam = SlamSystem(self.cfg, device=self.device)
        ok_frames = 0
        for f in bundle:
            if len(anchor_times) and np.min(np.abs(anchor_times - f.time)) < 1e-4:
                # force the staleness trigger so that an anchor frame (if
                # tracked OK) becomes a keyframe
                slam.frames_since_kf = max(slam.frames_since_kf, 15)
            st = slam.track_monocular(self._normalize(f.image, self.device), f.time)
            if st == TrackState.OK:
                ok_frames += 1
        if slam.stats["n_kf"] < 4 or ok_frames < 4:
            return None
        ms = slam.ms
        live_map = torch.where(ms.kf_valid, ms.kf_map_id, -1).cpu().numpy()
        counts = [int(np.sum(live_map == m)) for m in range(slam.n_maps_host)]
        order = np.argsort(counts)[::-1]
        best = int(order[0])
        if counts[best] < 4:
            return None
        self.last_weld_info = None
        if len(order) > 1 and counts[int(order[1])] >= 2:
            second = int(order[1])
            welded = self._weld_submaps(slam, best, second)
            if welded is None:
                # reverse direction: PnP the big map's keyframes against the
                # small map's points (whichever side holds the descriptors of
                # the boundary's appearance should be the PnP target)
                welded = self._weld_submaps(slam, second, best)
                if welded is not None:
                    best = second
            if welded is not None:
                # the Sim(3) weld leaves a seam; a full BA over the welded
                # bundle map straightens it before the CloudMap ships
                ms = global_bundle_adjustment(welded, slam.K, best, n_iters=8)
        if anchor_split is not None and len(anchor_times):
            # the shipped map must hold keyframes at anchor times on each
            # side of the split, else it cannot weld the gap
            sel = (ms.kf_valid & (ms.kf_map_id == best)).cpu().numpy()
            kf_t = ms.kf_time.cpu().numpy()[sel]
            fa = anchor_times[anchor_times < anchor_split]
            bb = anchor_times[anchor_times > anchor_split]

            def _hits(side):
                return (len(side) > 0 and len(kf_t) > 0
                        and float(np.min(np.abs(kf_t[:, None] - side[None, :]))) < 1e-3)

            if not (_hits(fa) and _hits(bb)):
                return None     # one-sided reconstruction: useless to merge
        return cloud_map.from_map_state(ms, best)

    def _weld_submaps(self, slam: SlamSystem, dst_map: int, src_map: int, *,
                      min_inliers: int = 10):
        """Sim(3)-weld ``src_map`` into ``dst_map`` inside the backend's own
        MapState; returns the welded MapState or None.

        Each src keyframe's raw features are PnP-ed against the dst submap's
        observation bank (``tracker.relocalize_map``), giving the src KF a
        pose in the dst world.  Two or more such poses fix the inter-map
        scale by baseline ratio, and any anchor fixes the rigid part:
        S = T_dst(b)^-1 o scale(s) o T_src(b).
        """
        ms = slam.ms
        dev = ms.kf_pose.device
        kf_map = ms.kf_map_id.cpu().numpy()
        kf_v = ms.kf_valid.cpu().numpy()
        kf_time = ms.kf_time.cpu().numpy()
        src_rows = np.flatnonzero(kf_v & (kf_map == src_map))
        if len(src_rows) < 2:
            return None

        # anchor attempts: the keyframes temporally nearest the dst submap,
        # plus a spread sample so a revisit deeper in the submap can anchor
        if len(src_rows) > 8:
            dst_t = kf_time[kf_v & (kf_map == dst_map)]
            lo, hi = float(dst_t.min()), float(dst_t.max())
            st = kf_time[src_rows]
            dist = np.where(st < lo, lo - st, np.where(st > hi, st - hi, 0.0))
            near = src_rows[np.argsort(dist)[:5]]
            pick = np.unique(np.linspace(0, len(src_rows) - 1, 4).astype(int))
            src_try = np.unique(np.concatenate([near, src_rows[pick]]))
        else:
            src_try = src_rows
        results = []
        for rank, b in enumerate(src_try):
            b = int(b)
            feats = orb.Features(
                uv=ms.kf_uv[b], response=torch.zeros_like(ms.kf_angle[b]),
                angle=ms.kf_angle[b], octave=ms.kf_octave[b],
                desc=ms.kf_desc[b], valid=ms.kf_feat_valid[b])
            tr, _ = tracker.relocalize_map(self._weld_draw(rank), ms, slam.K, feats,
                                           map_id=dst_map)
            results.append((b, tr))
        # one host read for all the tries
        n_inl = torch.stack([tr.n_inliers for _, tr in results]).tolist()
        self.last_weld_tries = {
            "dst": int(dst_map), "src": int(src_map),
            "pnp": [(float(kf_time[b]), int(n)) for (b, _), n in zip(results, n_inl)]}
        anchors = [(int(n), b, tr.pose) for (b, tr), n in zip(results, n_inl)
                   if int(n) >= min_inliers]          # (n_inl, row, T_dst [7])
        if len(anchors) < 2:
            return None
        anchors.sort(key=lambda a: (a[0], a[1]), reverse=True)

        def center(T):
            return lie.se3_t(lie.se3_inverse(T)).cpu().numpy()

        c_dst = center(torch.stack([a[2] for a in anchors]))
        c_src = center(ms.kf_pose[[a[1] for a in anchors]])
        # scale: least-squares fit of bd ~= s * bs over the anchor pairs, so
        # that long baselines dominate
        bds, bss = [], []
        for i in range(len(anchors)):
            for j in range(i + 1, len(anchors)):
                bd = np.linalg.norm(c_dst[i] - c_dst[j])
                bs = np.linalg.norm(c_src[i] - c_src[j])
                if bs > 1e-6 and bd > 1e-6:
                    bds.append(bd)
                    bss.append(bs)
        if not bds:
            return None
        bds, bss = np.asarray(bds), np.asarray(bss)
        s = float(np.dot(bds, bss) / np.dot(bss, bss))
        self.last_weld_info = {
            "n_anchors": len(anchors),
            "anchor_inliers": [a[0] for a in anchors],
            "scale": s,
            "scale_ratio_spread": (float(np.max(bds / bss) / np.min(bds / bss))
                                   if len(bds) > 1 else 1.0),
        }

        # S = T_dst(b)^-1 o diag(s) o T_src(b) from the strongest anchor
        _, b, T_dst = anchors[0]
        S_scale = torch.tensor([1.0, 0, 0, 0, 0, 0, 0, np.log(s)], dtype=torch.float32,
                               device=dev)
        S = lie.sim3_compose(
            lie.sim3_from_se3(lie.se3_inverse(T_dst)),
            lie.sim3_compose(S_scale, lie.sim3_from_se3(ms.kf_pose[b])))

        sel_kf = ms.kf_valid & (ms.kf_map_id == src_map)
        sel_pt = ms.pt_valid & (ms.pt_map_id == src_map)
        ms = ms._replace(
            kf_pose=torch.where(sel_kf[:, None], correct_poses(ms.kf_pose, S), ms.kf_pose),
            pt_xyz=torch.where(sel_pt[:, None], lie.sim3_apply(S, ms.pt_xyz), ms.pt_xyz))
        return M.relabel_map(ms, src_map, dst_map)

    @staticmethod
    def _weld_draw(rank: int):
        """The RANSAC draw of weld try ``rank`` (the JAX package uses
        ``PRNGKey(1000 + rank)``)."""
        return ransac.sampler(torch.Generator().manual_seed(1000 + rank))
