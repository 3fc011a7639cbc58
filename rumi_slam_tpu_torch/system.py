"""SlamSystem: the host-side facade and tracking state machine (port of
``rumi_slam_tpu/system.py``).

Three inputs: ``track_monocular`` (a grayscale frame), ``track_rgbd`` (a
frame and its registered depth map) and ``track_stereo`` (a rectified pair).
Per frame: ORB extraction, with the keypoints rectified to the ideal pinhole
for a radtan- or Kannala-Brandt-calibrated camera, then by state
NOT_INITIALIZED (two-view initialisation, or one frame's depth in the depth
modes), OK (tracking against the map with its fallbacks, keyframe insertion,
points spawned from depth in the depth modes, local mapping inline or on the
worker thread), RECENTLY_LOST (relocalisation) and LOST (a new submap or a
reset of the active one).  ``image_recorder`` is the rumination hook: it is
called with (image, time, state) for every frame, before the frame is
tracked (``rumination.coordinator``).

RANSAC draws: where the JAX package splits its PRNG key (``_next_key``),
the port calls ``_next_draw``, which consumes one value of the system's CPU
generator (seeded 0) and returns a draw callable (``optim.ransac``) on a
generator of its own.  A test can replace ``_next_draw`` to pass in the
JAX package's own draws.
"""

from __future__ import annotations

import enum
from typing import Optional

import numpy as np
import torch

from .config import Config
from .geometry import camera, camera_kb8, distortion, lie
from .mapstate import checkpoint
from .mapstate import map_state as M
from .ops import matcher, stereo
from .ops.orb import ORBExtractor
from .optim import ba, pose_opt, ransac, two_view
from .tracking import local_mapping, tracker
from .tracking import mapping_worker as MW
from .utils import verbose
from .utils.profiling import StageTimer


class TrackState(enum.Enum):
    NOT_INITIALIZED = 0
    OK = 1
    RECENTLY_LOST = 2
    LOST = 3


class SlamSystem:
    # the frame after a keyframe at which the tracker adopts that keyframe's
    # mapping round, waiting for it there if it is not done, and not before:
    # which map a frame tracks against then does not depend on how fast
    # tracking runs beside the worker thread
    ADOPT_AFTER = 2

    def __init__(self, config: Config | None = None, *, image_recorder=None, device="cuda"):
        """``device``: where the system's state and every frame's work live.
        The default is the card, and a host without one raises; pass
        ``device="cpu"`` to run on the CPU."""
        self.cfg = config or Config()
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"SlamSystem: device {device!r} asked for and no CUDA device is present "
                "(pass device=\"cpu\" to run on the CPU)")
        self.K = self.cfg.intrinsics(self.device)
        cam = self.cfg.camera
        self._dist = (torch.tensor(cam.dist_coeffs, dtype=torch.float32, device=self.device)
                      if distortion.has_distortion(cam.dist_coeffs) else None)
        # [8] fisheye parameters (K, then the polynomial) of a KB8 camera
        self._kb8 = (torch.cat([self.K, torch.tensor(cam.kb_coeffs, dtype=torch.float32,
                                                     device=self.device)])
                     if cam.model == "kb8" else None)
        o = self.cfg.orb
        self.extractor = ORBExtractor(
            n_features=o.n_features, n_levels=o.n_levels, scale_factor=o.scale_factor,
            threshold=o.ini_th_fast, min_threshold=o.min_th_fast, cell=o.cell,
            k_cell=o.k_cell,
        ).to(self.device)
        mc = self.cfg.mapping
        self.ms = M.empty(mc.max_kf, o.n_features, mc.max_pt, self.device)
        self.state = TrackState.NOT_INITIALIZED
        self.velocity = lie.se3_identity(device=self.device)     # T_cur_prev
        self.last_pose = lie.se3_identity(device=self.device)
        self.last_kf_id: int = -1
        self.last_kf_obs: int = 0
        self.frames_since_kf = 0
        self._gen = torch.Generator().manual_seed(0)
        self.lost_since: Optional[float] = None
        # host mirrors of ms.n_maps / ms.active_map (they change only at
        # host-driven events)
        self.n_maps_host: int = 1
        self.active_map_host: int = 0
        self._init_feats = None
        self._init_time = None
        # trajectory log: (time, pose_cw [7] np, map_id, state)
        self.trajectory: list[tuple[float, np.ndarray, int, str]] = []
        # hook for the rumination sampler: called with (img, time, state)
        self.image_recorder = image_recorder
        self.stats = {"n_kf": 0, "n_reloc": 0, "n_new_maps": 0, "n_lost_frames": 0}
        # localization-only mode: track against the frozen map, never insert
        # keyframes
        self.localization_only = False
        self._cur_ur = None  # the frame's virtual right u (depth modes)
        self._cur_z = None   # the frame's metric depth (None in monocular mode)
        self.timer = StageTimer()
        verbose.set_level(self.cfg.verbosity)
        self._log = verbose.print_mess
        self.mapper = MW.MappingWorker(self.cfg, self.K, self.timer) if mc.overlapped else None
        self._round_age: Optional[int] = None  # frames since the round in flight was submitted
        # the pose loop's graphs on the card for this frame size: track_frame's
        # 3 x 6, and the 4 x 10 of reference-KF tracking and relocalisation
        pose_opt.prepare(self.device, o.n_features, ((3, 6), (4, 10)))

    # ------------------------------------------------------------------
    def _next_draw(self):
        seed = int(torch.randint(0, 2**62, (), generator=self._gen))
        return ransac.sampler(torch.Generator().manual_seed(seed))

    def _extract(self, img):
        """ORB features of a frame, the keypoints rectified once to the ideal
        pinhole: through the fisheye model for a KB8 camera (which takes
        precedence), else undistorted when radtan coefficients are set."""
        feats = self.extractor(img)
        if self._kb8 is not None:
            feats = feats._replace(uv=camera.project(self.K, camera_kb8.unproject(self._kb8,
                                                                                 feats.uv)))
        elif self._dist is not None:
            feats = feats._replace(uv=distortion.undistort_points(self.K, self._dist, feats.uv))
        return feats

    def _image(self, img):
        return torch.as_tensor(img, dtype=torch.float32, device=self.device)

    def track_monocular(self, img, t: float):
        """Process one grayscale frame (float32 [H, W]); returns the state."""
        img = self._image(img)
        with self.timer.stage("orb_extract"):
            feats = self._extract(img)
        return self._track_common(feats, t, img)

    def track_rgbd(self, img, depth, t: float):
        """Process one grayscale frame and its registered depth map
        ([H, W]; raw / ``camera.depth_factor`` = metres): the depth gives
        one-frame initialisation and new points at keyframes.  Needs
        ``camera.baseline > 0`` for the virtual right coordinate."""
        cam = self.cfg.camera
        if cam.baseline <= 0:
            raise ValueError("RGB-D mode needs camera.baseline > 0 (for bf)")
        img = self._image(img)
        with self.timer.stage("orb_extract"):
            feats = self._extract(img)
        ur, z = stereo.depth_from_rgbd(self._image(depth), feats.uv, cam.bf,
                                       depth_factor=cam.depth_factor, max_z=cam.th_depth)
        return self._track_common(feats, t, img, ur=ur, z=z)

    def track_stereo(self, img_l, img_r, t: float):
        """Process a rectified stereo pair: the depth of each left feature
        comes from ``stereo.match_stereo`` against the right image's."""
        cam = self.cfg.camera
        if cam.baseline <= 0:
            raise ValueError("stereo mode needs camera.baseline > 0")
        img_l = self._image(img_l)
        with self.timer.stage("orb_extract"):
            feats = self._extract(img_l)
            feats_r = self._extract(self._image(img_r))
        ur, z = stereo.match_stereo(feats, feats_r, cam.bf)
        return self._track_common(feats, t, img_l, ur=ur, z=z)

    def _track_common(self, feats, t, img, ur=None, z=None):
        self._adopt_mapping()
        self._cur_ur, self._cur_z = ur, z
        if self.image_recorder is not None:
            self.image_recorder(img, t, self.state)

        if self.state == TrackState.NOT_INITIALIZED:
            with self.timer.stage("initialize"):
                if z is not None:
                    self._initialize_with_depth(feats, t)
                else:
                    self._try_initialize(feats, t)
        elif self.state == TrackState.OK:
            with self.timer.stage("track"):
                self._track_ok(feats, t)
        elif self.state == TrackState.RECENTLY_LOST:
            with self.timer.stage("relocalize"):
                self._track_recently_lost(feats, t)
        if self.state == TrackState.LOST:
            self._handle_lost(feats, t)
        return self.state

    def _initialize_with_depth(self, feats, t):
        """One-frame initialisation from stereo/RGB-D depth: a map point for
        every feature with a valid depth, once there are
        ``min_init_depth_points`` of them."""
        z = self._cur_z
        ok = feats.valid & (z > 0)
        if int(torch.sum(ok)) < self.cfg.tracking.min_init_depth_points:
            return
        ms = self.ms
        T0 = lie.se3_identity(device=self.device)
        xyz_w = camera.unproject(self.K, feats.uv, depth=torch.clamp_min(z, 1e-6))
        ms, ids = M.add_points(ms, xyz_w, feats.desc, ok, ms.n_kf,
                               octave=feats.octave, angle=feats.angle)
        assoc = torch.where(ids >= 0, ids, -1)
        ms, kf0 = M.insert_keyframe(ms, T0, feats, t, assoc, ur=self._cur_ur)
        self.ms = ms
        self.last_kf_id = int(kf0)
        self.last_kf_obs = int(torch.sum(assoc >= 0))
        self.last_pose = T0
        self.velocity = lie.se3_identity(device=self.device)
        self.frames_since_kf = 0
        self.state = TrackState.OK
        self.stats["n_kf"] += 1
        self._init_feats = None
        self._log(f"[init] depth map created at t={t:.3f}")
        self._log_pose(t, T0)

    # ------------------------------------------------------------------
    def _try_initialize(self, feats, t):
        cfg = self.cfg
        if self._init_feats is None:
            if int(torch.sum(feats.valid)) > 100:
                self._init_feats = feats
                self._init_time = t
            return
        f0 = self._init_feats
        mask = matcher.radius_mask(f0.uv, feats.uv, 100.0)
        # loose matching (TH_HIGH / 0.95): the two-view RANSAC is the gate
        idx, _ = matcher.match_descriptors(f0, feats, mask=mask, max_dist=matcher.TH_HIGH,
                                           ratio=0.95)
        n_matches = int(torch.sum(idx >= 0))
        if n_matches < cfg.tracking.init_min_matches:
            # too little overlap: make the newer frame the init reference
            self._init_feats = feats
            self._init_time = t
            return
        matched = idx >= 0
        r1 = camera.unproject(self.K, f0.uv)
        r2 = camera.unproject(self.K, feats.uv[idx.clamp_min(0).long()])
        res = two_view.two_view_init(
            self._next_draw(), r1, r2, matched,
            min_inliers=cfg.tracking.init_min_inliers, focal=float(self.K[0]),
        )
        if not bool(res.ok):
            return
        self._create_initial_map(f0, feats, idx, res, t)

    def _create_initial_map(self, f0, f1, idx, res: two_view.TwoViewResult, t):
        """Two keyframes + triangulated points + full BA."""
        ms = self.ms
        F = ms.max_feat
        dev = self.device
        ms, ids = M.add_points(ms, res.points, f0.desc, res.inliers, ms.n_kf,
                               octave=f0.octave, angle=f0.angle)
        assoc0 = torch.where(ids >= 0, ids, -1)
        assoc1 = torch.full((F,), -1, dtype=torch.int32, device=dev).scatter_reduce(
            0, idx.clamp_min(0).long(), torch.where((idx >= 0) & (ids >= 0), ids, -1), "amax")

        T0 = lie.se3_identity(device=dev)
        # frame 0's timestamp 0.0 is a real time: test for None, not falsiness
        t0 = t if self._init_time is None else self._init_time
        ms, kf0 = M.insert_keyframe(ms, T0, f0, t0, assoc0)
        ms, kf1 = M.insert_keyframe(ms, res.T_21, f1, t, assoc1)

        # full BA on the baby map, first KF fixed (gauge)
        cam_idx = torch.arange(2, device=dev).repeat_interleave(F)
        pt = torch.cat([assoc0, assoc1])
        uv = torch.cat([f0.uv, f1.uv])
        conf = (pt >= 0).to(torch.float32)
        bres = ba.bundle_adjust(
            self.K, ms.kf_pose[:2], ms.pt_xyz, cam_idx, pt.clamp_min(0), uv, conf,
            torch.tensor([False, True], device=dev), ms.pt_valid, n_iters=12,
        )
        ms = ms._replace(kf_pose=torch.cat([bres.poses, ms.kf_pose[2:]]), pt_xyz=bres.points)
        self.ms = ms
        self.last_kf_id = int(kf1)
        self.last_kf_obs = int(torch.sum(assoc1 >= 0))
        self.last_pose = ms.kf_pose[kf1]
        self.velocity = lie.se3_identity(device=dev)
        self.frames_since_kf = 0
        self.state = TrackState.OK
        self.stats["n_kf"] += 2
        self._log(f"[init] monocular map created at t={t:.3f} "
                  f"({self.last_kf_obs} seed points)")
        self._init_feats = None
        self._log_pose(t, self.last_pose)

    # ------------------------------------------------------------------
    def _track_ok(self, feats, t):
        cfg = self.cfg.tracking
        cam = self.cfg.camera
        pose_pred = lie.se3_compose(self.velocity, self.last_pose)
        ms, tr = tracker.track_frame(
            self.ms, self.K, feats, pose_pred, cfg.match_radius,
            img_w=cam.width, img_h=cam.height,
            max_hamming=cfg.max_hamming, nn_ratio=cfg.nn_ratio, timer=self.timer,
        )
        self.ms = ms
        if int(tr.n_inliers) < cfg.min_track_inliers:
            # fallback: reference-KF tracking (no motion prior)
            with self.timer.stage("track_ref_kf"):
                tr = tracker.track_reference_kf(self.ms, self.K, feats, self.last_kf_id,
                                                self.last_pose, timer=self.timer)
            if int(tr.n_inliers) < cfg.min_track_inliers:
                # wider window from the predicted pose as a last resort
                ms, tr = tracker.track_frame(
                    self.ms, self.K, feats, pose_pred, cfg.match_radius_wide,
                    img_w=cam.width, img_h=cam.height,
                    max_hamming=matcher.TH_HIGH, nn_ratio=0.95, timer=self.timer,
                )
                self.ms = ms
        if int(tr.n_inliers) < cfg.min_track_inliers:
            self.state = TrackState.RECENTLY_LOST
            self.lost_since = t
            self.stats["n_loss_events"] = self.stats.get("n_loss_events", 0) + 1
            self._log(f"[track] lost at t={t:.3f} ({int(tr.n_inliers)} inliers)")
            return

        new_pose = tr.pose
        self.velocity = lie.se3_compose(new_pose, lie.se3_inverse(self.last_pose))
        self.last_pose = new_pose
        self.frames_since_kf += 1
        self._log_pose(t, new_pose)

        if not self.localization_only and self._need_new_keyframe(tr):
            with self.timer.stage("keyframe"):
                self._create_keyframe_inner(feats, new_pose, t, tr.assoc)

    def activate_localization_mode(self):
        """Freeze the map; keep tracking only."""
        self.localization_only = True

    def deactivate_localization_mode(self):
        self.localization_only = False

    def _need_new_keyframe(self, tr: tracker.TrackResult) -> bool:
        cfg = self.cfg.tracking
        if self.frames_since_kf < cfg.kf_min_interval:
            return False
        if self.mapper is not None and not self.mapper.idle():
            return False   # keyframes only while local mapping is idle
        weak = int(tr.n_inliers) < cfg.kf_tracked_ratio * max(self.last_kf_obs, 1)
        stale = self.frames_since_kf >= 15
        return weak or stale

    def _create_keyframe_inner(self, feats, pose, t, assoc):
        ms = self.ms
        if int(ms.n_kf) >= ms.max_kf:
            # capacity pressure: evict the most redundant old keyframes,
            # cull, compact, and carry on
            self.stats["kf_full"] = self.stats.get("kf_full", 0) + 1
            self.sync_mapping()
            self.ms = local_mapping.evict_for_capacity(self.ms, self.last_kf_id)
            self.ms = local_mapping.cull_points(self.ms)
            # compaction renumbers point slots: remap the incoming assoc
            # (old point ids) through pt_map
            pt_map = self._maybe_compact()
            if pt_map is not None:
                assoc = torch.where(assoc >= 0, pt_map[assoc.clamp_min(0).long()], -1)
            else:
                # eviction/culling may have invalidated referenced points
                assoc = torch.where((assoc >= 0) & self.ms.pt_valid[assoc.clamp_min(0).long()],
                                    assoc, -1)
            ms = self.ms
            if int(ms.n_kf) >= ms.max_kf:
                self._log(f"[map] KF capacity {ms.max_kf} full even after "
                          "eviction+compaction; keyframe dropped", verbose.Level.QUIET)
                return
            self._log(f"[map] capacity eviction freed {ms.max_kf - int(ms.n_kf)} KF slots")
        ms, kid = M.insert_keyframe(ms, pose, feats, t, assoc, ur=self._cur_ur)
        kid_i = int(kid)
        # stereo/RGB-D: spawn points from depth for the unmatched features
        # (keyframes are made only while the mapping worker is idle, so the
        # two never race for point slots)
        if self._cur_z is not None:
            xyz_w, make = stereo.backproject_new_points(
                self.K, pose, feats.uv, self._cur_z, assoc >= 0, feats.valid,
                max_new=self.cfg.tracking.max_new_depth_points,
                th_depth=self.cfg.camera.th_depth)
            ms, ids = M.add_points(ms, xyz_w, feats.desc, make, kid_i,
                                   octave=feats.octave, angle=feats.angle)
            ms = M.set_associations(ms, kid_i, torch.where(ids >= 0, ids, ms.kf_point[kid_i]))
        self.ms = ms
        self.last_kf_id = kid_i
        self.last_kf_obs = int(torch.sum(ms.kf_point[kid_i] >= 0))
        self.last_pose = ms.kf_pose[kid_i]
        self.frames_since_kf = 0
        self.stats["n_kf"] += 1

        use_stereo = self._cur_z is not None
        if self.mapper is not None and self.mapper.submit(
            self.ms, kid_i, use_stereo=use_stereo, draw=self._next_draw(),
            kf_count=self.stats["n_kf"],
        ):
            self._round_age = 0
            return  # mapping overlaps; the result is adopted at a frame boundary
        # synchronous path (overlapped=False, or worker saturated)
        with self.timer.stage("mapping_round"):
            out = MW.run_mapping_round(self.ms, self.K, self.cfg, kid_i, use_stereo=use_stereo,
                                       draw=self._next_draw(), kf_count=self.stats["n_kf"],
                                       timer=self.timer)
        self._apply_mapping(out)
        self.last_pose = self.ms.kf_pose[kid_i]
        self.last_kf_obs = int(torch.sum(self.ms.kf_point[kid_i] >= 0))

    # ------------------------------------------------------------------
    def _apply_mapping(self, out):
        self.ms = MW.merge_mapping_result(self.ms, out.snap, out.mapped)
        ev = out.events
        self.stats["n_new_pts"] = self.stats.get("n_new_pts", 0) + ev["n_new"]
        self.stats["n_fused"] = self.stats.get("n_fused", 0) + ev["n_fused"]
        for k in ("loop_best_score", "loop_verify_inliers"):
            if k in ev:
                self.stats[k] = max(self.stats.get(k, 0), ev[k])
        if ev["loop"]:
            self.stats["n_loops"] = self.stats.get("n_loops", 0) + 1
            # poses moved under us: drop the motion-model extrapolation
            self.velocity = lie.se3_identity(device=self.device)
            self._log("[loop] closed during mapping round")

    def _adopt_mapping(self):
        """Adopt the mapping round in flight at the frame boundary
        ``ADOPT_AFTER`` frames after its keyframe."""
        if self.mapper is None:
            return
        if self._round_age is not None:
            self._round_age += 1
            if self._round_age >= self.ADOPT_AFTER:
                self._round_age = None
                out = self.mapper.flush()
                if out is not None:
                    with self.timer.stage("adopt_mapping"):
                        self._apply_mapping(out)
                    self.stats["n_adopted"] = self.stats.get("n_adopted", 0) + 1
        self._maybe_compact()

    def sync_mapping(self):
        """Flush and adopt in-flight mapping work, so that exactly one writer
        touches the MapState during structural host operations."""
        if self.mapper is None:
            return
        self._round_age = None
        out = self.mapper.flush()
        if out is not None:
            self._apply_mapping(out)
            self.stats["n_adopted"] = self.stats.get("n_adopted", 0) + 1

    def _maybe_compact(self):
        """Slot reclamation near capacity, once culling has freed enough
        slots.  Returns the point old->new slot map ([P] int32 tensor, -1
        for dead) when a compaction happened, else None."""
        ms = self.ms
        n_kf, n_pt = int(ms.n_kf), int(ms.n_pt)
        near_kf = n_kf >= ms.max_kf - 4
        near_pt = n_pt >= int(0.95 * ms.max_pt)
        if not (near_kf or near_pt):
            return None
        dead_kf = n_kf - int(torch.sum(ms.kf_valid))
        dead_pt = n_pt - int(torch.sum(ms.pt_valid))
        if dead_kf < 4 and dead_pt < 64:
            return None
        if self.mapper is not None and not self.mapper.idle():
            return None  # worker snapshots would go stale under renumbering
        ms2, kf_map, pt_map = M.compact(ms)
        self.ms = ms2
        if self.last_kf_id >= 0 and int(kf_map[self.last_kf_id]) >= 0:
            self.last_kf_id = int(kf_map[self.last_kf_id])
        else:
            self.last_kf_id = int(ms2.n_kf) - 1
        self.stats["n_compactions"] = self.stats.get("n_compactions", 0) + 1
        self._log(f"[map] compacted: {dead_kf} KF / {dead_pt} point slots reclaimed")
        return torch.from_numpy(pt_map).to(self.device)

    # ------------------------------------------------------------------
    def _track_recently_lost(self, feats, t):
        cfg = self.cfg.tracking
        self.stats["n_lost_frames"] += 1
        # fewer candidate features than the inlier gate: relocalisation
        # cannot succeed, skip it
        if int(torch.sum(feats.valid)) < cfg.min_track_inliers:
            if self.lost_since is not None and t - self.lost_since > cfg.reloc_window_s:
                self.state = TrackState.LOST
            return
        # map-level prior-free PnP first
        tr, ref_kf = tracker.relocalize_map(self._next_draw(), self.ms, self.K, feats)
        if int(tr.n_inliers) >= cfg.min_track_inliers:
            self._relocalized(tr, int(ref_kf), t, "map-level recovery")
            return
        # then per candidate KF: prior-free PnP, KF-pose-seeded tracking as
        # the cheap fallback
        cand_ids, scores = tracker.relocalization_candidates(self.ms, feats)
        cand_ids, scores = cand_ids.tolist(), scores.tolist()
        for kf, score in zip(cand_ids, scores):
            if score < 10:
                break
            tr = tracker.relocalize_pnp(self._next_draw(), self.ms, self.K, feats, kf)
            if int(tr.n_inliers) < cfg.min_track_inliers:
                tr = tracker.track_reference_kf(self.ms, self.K, feats, kf, self.ms.kf_pose[kf])
            if int(tr.n_inliers) >= cfg.min_track_inliers:
                self._relocalized(tr, kf, t, f"recovered on KF {kf}")
                return
        if self.lost_since is not None and t - self.lost_since > cfg.reloc_window_s:
            self.state = TrackState.LOST

    def _relocalized(self, tr, kf, t, how):
        self.state = TrackState.OK
        self.last_pose = tr.pose
        self.velocity = lie.se3_identity(device=self.device)
        self.last_kf_id = kf
        self.stats["n_reloc"] += 1
        self._log(f"[reloc] {how} at t={t:.3f}")
        self._log_pose(t, tr.pose)

    def _handle_lost(self, feats, t):
        """On LOST: start a new submap if the active one passes the quality
        gates, else reset the active map."""
        self.sync_mapping()
        cfg = self.cfg.tracking
        ms = self.ms
        n_kf = int(M.map_kf_count(ms, ms.active_map))
        dur = float(M.map_duration(ms, ms.active_map))
        curv = (float(M.map_trajectory_curvature(ms, ms.active_map))
                if cfg.new_map_min_curvature > 0.0 else 1.0)
        if (n_kf >= cfg.new_map_min_kf and dur >= cfg.new_map_min_duration_s
                and curv > cfg.new_map_min_curvature):
            # freeze the current map; open a new submap
            new_id = self.n_maps_host
            self.ms = ms._replace(
                active_map=torch.full((), new_id, dtype=torch.int32, device=self.device),
                n_maps=ms.n_maps + 1)
            self.n_maps_host += 1
            self.active_map_host = new_id
            self.stats["n_new_maps"] += 1
            self._log(f"[atlas] new submap {new_id} opened at t={t:.3f}")
        else:
            # reset the active map: invalidate its KFs and points
            self.ms = ms._replace(
                kf_valid=ms.kf_valid & ~(ms.kf_map_id == ms.active_map),
                pt_valid=ms.pt_valid & ~(ms.pt_map_id == ms.active_map))
        self.state = TrackState.NOT_INITIALIZED
        self._init_feats = None
        self.lost_since = None
        self.last_kf_id = -1

    # ------------------------------------------------------------------
    def _log_pose(self, t, pose):
        self.trajectory.append((t, pose.detach().cpu().numpy(), self.active_map_host,
                                self.state.name))

    def save_map(self, path) -> str:
        """Checkpoint the whole MapState (``mapstate.checkpoint``); returns
        the checkpoint path."""
        self.sync_mapping()
        checkpoint.save(self.ms, path)
        return str(path)

    def load_map(self, path):
        """Restore a MapState checkpoint onto this system's device; the
        tracker resumes in RECENTLY_LOST and relocalises against it."""
        self.sync_mapping()
        self.ms = checkpoint.load(path, device=self.device)
        self.n_maps_host = int(self.ms.n_maps)
        self.active_map_host = int(self.ms.active_map)
        self.state = TrackState.RECENTLY_LOST
        self.lost_since = None
        self.last_kf_id = int(self.ms.n_kf) - 1

    def keyframe_trajectory(self, map_id=None):
        """(times, poses_cw) of the keyframes of one submap; default: the
        duration-longest map.  Live KFs win over cloud twins of one stamp."""
        h = M.to_numpy(self.ms)
        kf_v, kf_m, kf_t = h["kf_valid"], h["kf_map_id"], h["kf_time"]
        if map_id is None:
            best, best_dur = 0, -1.0
            for m in range(int(h["n_maps"])):
                sel = kf_v & (kf_m == m)
                if sel.sum() >= 2:
                    dur = kf_t[sel].max() - kf_t[sel].min()
                    if dur > best_dur:
                        best, best_dur = m, dur
            map_id = best
        sel = kf_v & (kf_m == map_id)
        times, poses, is_cloud = kf_t[sel], h["kf_pose"][sel], h["kf_is_cloud"][sel]
        order = np.lexsort((is_cloud, times))    # live first within a stamp
        times, poses, is_cloud = times[order], poses[order], is_cloud[order]
        keep = np.ones(len(times), bool)
        keep[1:] = ~(np.abs(np.diff(times)) < 1e-4) | ~is_cloud[1:]
        return times[keep], poses[keep]

    def trajectory_of_map(self, map_id=None):
        """(times, poses_cw [N, 7]) of the frames tracked in one submap;
        default: the duration-longest map."""
        if not self.trajectory:
            return np.zeros(0), np.zeros((0, 7))
        if map_id is None:
            durations = {}
            for m in sorted({m for _, _, m, _ in self.trajectory}):
                ts = [t for t, _, mm, _ in self.trajectory if mm == m]
                durations[m] = max(ts) - min(ts) if len(ts) > 1 else 0.0
            map_id = max(durations, key=durations.get)
        rows = [(t, p) for t, p, m, _ in self.trajectory if m == map_id]
        times = np.asarray([r[0] for r in rows])
        poses = np.stack([r[1] for r in rows]) if rows else np.zeros((0, 7))
        return times, poses
