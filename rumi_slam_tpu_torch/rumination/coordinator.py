"""RuminationCoordinator: glues sampler, backend and merge into a SlamSystem
(port of ``rumi_slam_tpu/rumination/coordinator.py``).

The coordinator owns a frame ring buffer (timestamp -> host image) and a
``LostFrameSampler``, both fed by the system's ``image_recorder`` hook.
``maybe_ruminate`` is called once per frame: when two un-merged submaps exist
and the new one has matured, it assembles the upload bundle, has the backend
build the back submap, imports it as a third submap and runs the double merge
(cloud -> front, back -> front) and a global BA (``post_merge_gba``).  With an
``AsyncRuminationShard`` the build overlaps tracking and the merge lands when
``poll`` delivers the CloudMap.

Until its gates pass, ``maybe_ruminate`` reads nothing from the device: it
works from the system's host mirrors ``n_maps_host`` / ``active_map_host``.
``on_frame`` copies every frame to the host (the ring holds numpy arrays, as
the bundle does).

RANSAC draws: where the JAX package splits its PRNG key (seeded 42), the
coordinator takes seeds from a CPU generator seeded 42, one per merge
attempt, in the same order.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..geometry import lie
from ..mapstate import map_state as M
from ..optim import ransac
from ..parallel import distributed
from ..system import SlamSystem, TrackState
from ..tracking.local_mapping import global_bundle_adjustment
from . import cloud_map as CM
from . import merge as merge_mod
from .backend import RuminationBackend
from .sampler import BundleAssembler, LostFrameSampler, RecordedFrame


def insert_cloud_map(ms: M.MapState, cm: CM.CloudMap, map_id):
    """Import a CloudMap into the MapState as submap ``map_id``.
    Returns (ms, kf_ids [Kc] int32, -1 for the rows that did not land)."""
    cm = CM.reduce_feature_capacity(cm, ms.max_feat)
    dev = ms.kf_pose.device
    desc = cm.kf_desc
    if desc is None:
        desc = torch.zeros(cm.kf_uv.shape[:2] + (8,), dtype=torch.int32, device=dev)
    angle = cm.kf_angle
    if angle is None:
        angle = torch.zeros(cm.kf_uv.shape[:2], dtype=torch.float32, device=dev)

    # points first: remap table old row -> new row
    pt_desc = torch.zeros((cm.pt_xyz.shape[0], 8), dtype=torch.int32, device=dev)
    ms, pt_ids = M.add_points(ms, cm.pt_xyz, pt_desc, cm.pt_valid, ms.n_kf, map_id=map_id)
    remap = torch.where(cm.kf_point >= 0, pt_ids[cm.kf_point.clamp_min(0).long()], -1)

    return M.add_keyframes_bulk(
        ms, cm.kf_pose, cm.kf_uv, cm.kf_octave, angle, desc, cm.kf_feat_valid, remap,
        cm.kf_time, cm.kf_valid, map_id=map_id, is_cloud=True)


def correct_pose(T_cw, S):
    """Re-express camera poses [..., 7] after their world was transformed by
    the Sim(3) S."""
    return merge_mod.correct_poses(T_cw, S)


def post_merge_gba(ms, K, map_id, *, n_iters):
    """The global BA after a merge: through the sharded PCG Schur engine when
    ``distributed.ba_mesh()`` finds more than one card, else the dense Schur
    solve.  Returns (ms, "pcg" or "dense")."""
    mesh = distributed.ba_mesh()
    ms = global_bundle_adjustment(ms, K, map_id, n_iters=n_iters, mesh=mesh)
    return ms, "pcg" if mesh is not None else "dense"


class RuminationCoordinator:
    def __init__(self, slam: SlamSystem, config: Optional[Config] = None, *,
                 backend: Optional[RuminationBackend] = None, ring_capacity: int = 600,
                 async_shard=None):
        """The backend, where none is given, runs on the system's device."""
        self.slam = slam
        self.cfg = config or slam.cfg
        self.sampler = LostFrameSampler(self.cfg.sampler)
        self.assembler = BundleAssembler(self.cfg.sampler)
        self.backend = backend or RuminationBackend(self.cfg, device=slam.device)
        self.ring: list[RecordedFrame] = []
        self.ring_capacity = ring_capacity
        self.front_map_id: Optional[int] = None
        self.merged_maps: set[int] = set()
        self._gen = torch.Generator().manual_seed(42)
        self.history: list[dict] = []
        # async mode: an AsyncRuminationShard (rumination/remote.py); None =
        # the backend runs inline
        self.shard = async_shard
        self._pending: Optional[dict] = None
        self._anchor_times: list[float] = []
        self._anchor_split: Optional[float] = None
        slam.image_recorder = self.on_frame

    def _next_draws(self, n: int):
        """``n`` RANSAC draw callables, each on a generator of its own."""
        seeds = torch.randint(0, 2**62, (n,), generator=self._gen).tolist()
        return [ransac.sampler(torch.Generator().manual_seed(s)) for s in seeds]

    # ------------------------------------------------------------------
    def on_frame(self, img, t: float, state: TrackState):
        """The system's ``image_recorder``: the frame's host copy into the
        ring (it waits for the work queued before it), as the system's
        ``on_frame`` stage."""
        with self.slam.timer.stage("on_frame"):
            host = (img.detach().cpu().numpy() if isinstance(img, torch.Tensor)
                    else np.asarray(img))
            self.ring.append(RecordedFrame(t, host))
            if len(self.ring) > self.ring_capacity:
                self.ring.pop(0)
            if state in (TrackState.RECENTLY_LOST, TrackState.LOST,
                         TrackState.NOT_INITIALIZED):
                if self.slam.stats["n_new_maps"] > 0 or state != TrackState.NOT_INITIALIZED:
                    self.sampler.record(torch.as_tensor(img, dtype=torch.float32,
                                                        device=self.slam.device), t, host)

    # ------------------------------------------------------------------
    def _frames_for_times(self, times: np.ndarray) -> list[RecordedFrame]:
        out = []
        ring_t = np.asarray([f.time for f in self.ring])
        for t in times:
            if len(ring_t) == 0:
                break
            j = int(np.argmin(np.abs(ring_t - t)))
            if abs(ring_t[j] - t) < 1e-4:
                out.append(self.ring[j])
        return out

    def maybe_ruminate(self) -> Optional[dict]:
        """Call once per frame (or less) from the caller's loop.  When two
        un-merged submaps exist and the new one passes the maturity gates,
        runs the full rumination: bundle -> backend -> insert -> double
        merge.  Returns an info dict when a merge was attempted."""
        # async: harvest a finished build first
        if self.shard is not None:
            done = self.shard.poll()
            if done is not None and self._pending is not None:
                _, cm = done
                info, self._pending = self._pending, None
                info["backend_weld"] = getattr(getattr(self.shard, "backend", None),
                                               "last_weld_info", None)
                if cm is None:
                    return self._backend_failed(info)
                return self._finish_rumination(info, cm)

        slam = self.slam
        n_maps = slam.n_maps_host      # host mirrors: no device read until
        active = slam.active_map_host  # the gates below pass
        if n_maps < 2 or active in self.merged_maps:
            return None
        if self._pending is not None and self._pending["back"] == active:
            return None  # build in flight for this map
        front = active - 1
        while front in self.merged_maps and front > 0:
            front -= 1
        if front == active or front < 0:
            return None
        # maturity gates on the new (edge-back) map: one device read
        ms = slam.ms
        sc = self.cfg.sampler
        n_back, dur, n_front = torch.stack([
            M.map_kf_count(ms, active).to(torch.float32), M.map_duration(ms, active),
            M.map_kf_count(ms, front).to(torch.float32)]).tolist()
        if n_back < sc.n_new_track_first or dur < sc.min_time_s:
            return None
        if n_front < 2:
            self.merged_maps.add(front)
            return None
        return self._run_rumination(front, active)

    # ------------------------------------------------------------------
    def _frames_in_window(self, lo: float, hi: float, cap: int):
        """All ring frames with lo <= t <= hi, uniformly thinned to ``cap``."""
        out = [f for f in self.ring if lo <= f.time <= hi]
        if len(out) > cap:
            idx = np.unique(np.linspace(0, len(out) - 1, cap).astype(int))
            out = [out[i] for i in idx]
        return out

    def _assemble_bundle(self, info: dict, front: int, back: int):
        ms = self.slam.ms
        kf_t = ms.kf_time.cpu().numpy()
        kf_m = torch.where(ms.kf_valid, ms.kf_map_id, -1).cpu().numpy()
        t_front = np.sort(kf_t[kf_m == front])
        t_back = np.sort(kf_t[kf_m == back])
        sc = self.cfg.sampler
        # primary: KF-subsampled context windows
        front_frames = self._frames_for_times(
            t_front[t_front >= t_front[-1] - sc.context_window_s][-sc.n_track_last:])
        back_frames = self._frames_for_times(
            t_back[t_back <= t_back[0] + sc.context_window_s][: sc.n_new_track_first])
        # fallback: full-rate windows when the KF cadence left too little
        # context for the backend to anchor on
        if len(front_frames) < 4 or len(back_frames) < 4:
            front_frames = self._frames_in_window(
                t_front[-1] - sc.context_window_s, t_front[-1], sc.max_track_last)
            back_frames = self._frames_in_window(
                t_back[0], t_back[0] + sc.context_window_s, sc.max_track_last)
        if not front_frames or not back_frames:
            front_frames = self._frames_for_times(t_front)
            back_frames = self._frames_for_times(t_back)
        if not front_frames or not back_frames:
            # the ring no longer holds frames near either map's KF timestamps
            info["result"] = "no_ring_frames"
            return None
        # anchors: live-KF timestamps inside the context windows; the backend
        # forces keyframes there
        self._anchor_times = [
            float(t) for t in np.concatenate([t_front, t_back])
            if front_frames[0].time - 1e-6 <= t <= back_frames[-1].time + 1e-6]
        # a time strictly between the two live maps' keyframes
        self._anchor_split = 0.5 * (float(t_front[-1]) + float(t_back[0]))
        # the PD-subsampled lost list is the primary payload; the raw list is
        # the fallback when sampling left too few frames to chain
        sampled = self.sampler.sampled
        raw = self.sampler.all_frames
        lost = sampled if len(sampled) >= 5 else raw
        bundle = self.assembler.combine(front_frames, lost, back_frames)
        info["n_lost_raw"] = len(raw)
        info["n_lost_sampled"] = len(sampled)
        if bundle is not None:
            info["bundle_size"] = len(bundle)
            # upload accounting: what was shipped and what the un-sampled
            # bundle would have cost
            info["upload_mb"] = sum(f.image.nbytes for f in bundle) / 1e6
            raw_bundle = (bundle if lost is raw
                          else self.assembler.combine(front_frames, raw, back_frames))
            info["upload_mb_raw"] = (sum(f.image.nbytes for f in raw_bundle) / 1e6
                                     if raw_bundle is not None else info["upload_mb"])
        return bundle

    def _backend_failed(self, info: dict) -> dict:
        info["result"] = "backend_failed"
        # one attempt per matured map, or the coordinator would re-run the
        # backend build every frame
        self.merged_maps.add(info["back"])
        self.history.append(info)
        return info

    def _run_rumination(self, front: int, back: int) -> Optional[dict]:
        info: dict = {"front": front, "back": back}
        with self.slam.timer.stage("ruminate_bundle"):
            bundle = self._assemble_bundle(info, front, back)
        if bundle is None:
            if info.get("result") == "no_ring_frames":
                self.merged_maps.add(back)   # the images are gone
            else:
                info["result"] = "bundle_too_small"
            self.history.append(info)
            return info

        # the sampler state is cleared when the bundle is published, not when
        # the merge concludes: a later loss starts from a clean lost list
        self.sampler.reset()

        if self.shard is not None:
            if self.shard.submit(back, bundle, anchor_times=self._anchor_times,
                                 anchor_split=self._anchor_split):
                self._pending = info
            return None  # the result is harvested by a later poll

        # synchronous: the backend builds the cloud submap inline
        with self.slam.timer.stage("ruminate_backend"):
            cm = self.backend.build(bundle, anchor_times=self._anchor_times,
                                    anchor_split=self._anchor_split)
        info["backend_weld"] = getattr(self.backend, "last_weld_info", None)
        if cm is None:
            return self._backend_failed(info)
        return self._finish_rumination(info, cm)

    def _merge_with_retry(self, ms, K, src, dst, draws):
        """``merge_submaps`` with one retry under widened association
        tolerances on a recoverable failure."""
        mc = self.cfg.merge
        d1, d2 = draws
        ms, ok, i = merge_mod.merge_submaps(ms, K, src, dst, mc, d1)
        if ok or not mc.retry_widened:
            return ms, ok, i
        if i.get("reason") not in ("no_point_pairs", "low_inliers"):
            return ms, ok, i      # no_kf_matches cannot improve with the radius
        wide = dataclasses.replace(mc, pixel_radius=mc.retry_pixel_radius,
                                   min_inlier_ratio=mc.retry_min_inlier_ratio)
        ms, ok, i2 = merge_mod.merge_submaps(ms, K, src, dst, wide, d2)
        i2["retried"] = True
        i2["first_attempt"] = i
        return ms, ok, i2

    def _drop_map(self, ms, map_id):
        return ms._replace(kf_valid=ms.kf_valid & (ms.kf_map_id != map_id),
                           pt_valid=ms.pt_valid & (ms.pt_map_id != map_id))

    def _finish_rumination(self, info: dict, cm) -> dict:
        slam = self.slam
        # single writer: finish any overlapped mapping round before the merge
        # rewrites poses and points
        slam.sync_mapping()
        ms = slam.ms
        front, back = info["front"], info["back"]

        # import + double merge (cloud -> front, back -> front)
        cloud_id = slam.n_maps_host
        ms = ms._replace(n_maps=ms.n_maps + 1)
        slam.n_maps_host += 1
        ms, cloud_kf_ids = insert_cloud_map(ms, cm, cloud_id)
        # add_keyframes_bulk drops rows past max_kf: surface it, and fail fast
        # when nothing landed
        n_cloud, n_inserted = torch.stack(
            [torch.sum(cm.kf_valid), torch.sum(cloud_kf_ids >= 0)]).tolist()
        info["n_cloud_kf"] = n_cloud
        if n_inserted < n_cloud:
            info["cloud_kf_dropped"] = n_cloud - n_inserted
        if n_inserted < 2:
            slam.ms = self._drop_map(ms, cloud_id)
            info["result"] = "kf_capacity_full"
            self.merged_maps.add(back)
            self.history.append(info)
            return info

        k1a, k1b, k2a, k2b = self._next_draws(4)
        with slam.timer.stage("ruminate_merge"):
            ms, ok1, i1 = self._merge_with_retry(ms, slam.K, cloud_id, front, (k1a, k1b))
        info["cloud_merge"] = i1
        if not ok1:
            # drop the cloud map, keep tracking in the back map
            slam.ms = self._drop_map(ms, cloud_id)
            info["result"] = "cloud_merge_failed"
            self.merged_maps.add(back)  # don't retry forever
            self.history.append(info)
            return info

        with slam.timer.stage("ruminate_merge"):
            ms, ok2, i2 = self._merge_with_retry(ms, slam.K, back, front, (k2a, k2b))
        info["back_merge"] = i2
        if ok2:
            # tracking continues in the merged (front) map
            ms = ms._replace(active_map=torch.full_like(ms.active_map, front))
            slam.active_map_host = front
            if self.cfg.merge.run_gba:
                with slam.timer.stage("ruminate_gba"):
                    ms, info["gba"] = post_merge_gba(ms, slam.K, front,
                                                     n_iters=self.cfg.merge.gba_iters)
            slam.ms = ms
            # the back map's world moved: recompute last_pose from its KF
            if slam.last_kf_id >= 0:
                slam.last_pose = ms.kf_pose[slam.last_kf_id]
                slam.velocity = lie.se3_identity(device=slam.device)
            self.merged_maps.add(back)
            self.merged_maps.add(cloud_id)
            info["result"] = "merged"
        else:
            slam.ms = ms
            self.merged_maps.add(back)
            info["result"] = "back_merge_failed"
        self.history.append(info)
        return info
