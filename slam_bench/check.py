"""What decides ``correct``: the numbers a run compares, each against the
limit its cell states (``limits`` in ``slam_bench/cells/<cell>.json``).

Two kinds of number.

Step checks, on a sample of the window's frames drawn from the seed.  The
program's own ORB features of a sampled frame and the inputs and outputs of
its first ``tracker.track_frame`` call are kept as the window runs
(``Captures``).  Once the window has closed the reference (``reference/``,
plain PyTorch) works them out again on the same card:

``orb_miss``
    ORB extraction: the share of keypoints that the program and the
    reference (run on the benchmark's own bank frame, its keypoints then
    undistorted where the camera has coefficients) do not agree on.  A
    keypoint agrees with one of the other side at the same level within
    0.05 px, an angle within 1e-3 rad and at most 8 of 256 descriptor bits.
``track_assoc_differ``
    Projection matching (the fused CUDA matcher) and the pose optimisation's
    inlier set: the share of feature rows whose map point differs from the
    reference's, which matches and optimises from the program's features,
    map and pose prediction.  The reference follows the program step by step
    from the program's own state here; the truth checks below judge that
    state by themselves.
``track_pose_gap``
    Motion-only pose optimisation: the largest rotation angle (rad) between
    the program's pose and the reference's, plus the gap of their camera
    centres over the median depth of the reference's inliers.

Cells of a depth sensor read one more step number, and in a stereo cell
``orb_miss`` covers both images of a sampled pair:

``stereo_differ`` (stereo)
    Scanline matching (``ops/stereo.match_stereo``): the share of the valid
    left features whose match, ``ur`` or ``z`` differs from the reference's
    (``reference/stereo.match_stereo``), which matches the program's own left
    and right features (each judged by ``orb_miss``) with the
    configuration's ``bf``.
``rgbd_depth_differ`` (RGB-D)
    The depth lookup: the share of the program's features, paired with the
    reference's by ``orb_miss``'s rule, whose ``ur`` (within ``ORB_PX``) or
    ``z`` differs from ORB-SLAM's rule (``reference/stereo.depth_at_keypoints``:
    the depth read at the raw keypoint, ``ur`` from the undistorted u).

Truth checks, against the world and path the benchmark rendered, over a
fixed stretch of stream: the warm-up and the window's first
``TRUTH_FRAMES`` frames, so that a faster program is judged on the same
path as a slower one (monocular drift grows with the path).  The estimate
is read once the window has closed, or in a cell with ``truth_snapshot``
once the stretch's mapping rounds are adopted (``harness.execute``), so that
the keyframes and points do not depend on how many rounds the host ran
before the close, and aligned to the truth in numpy
float64: by a Sim(3) for a monocular sensor (its maps have no scale), by an
SE(3), the scale held at 1, for a depth sensor, as ORB-SLAM's stereo and
RGB-D evaluations align, so that a wrong metric scale counts as error:

``frame_ate_m``
    RMS error (m), after Umeyama's alignment, of the camera centres of the
    frames of that stretch tracked in the map that holds the most frames.
``kf_ate_m``
    The mapping round's keyframe poses: the same for that map's keyframes
    of the stretch.
``map_point_err_m``
    The mapping round's points: the median distance (m) from each valid
    point of that map whose reference keyframe lies in the stretch to the
    nearest true landmark, under the alignment of those keyframes' whole
    poses (``pose_alignment``).

A number that cannot be read (no sampled frame was tracked, fewer than
three poses) fails the check.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from .reference import distortion, lie, orb, stereo, track

SAMPLE_N = 6           # sampled frames
SAMPLE_RANGE = 120     # ... among the window's first frames
TRUTH_FRAMES = 150     # the truth checks judge the warm-up and this many window frames
ORB_PX, ORB_ANGLE, ORB_BITS = 0.05, 1e-3, 8


def sample_ordinals(seed: int):
    rng = np.random.default_rng([seed, 2])
    return set(int(j) for j in rng.choice(SAMPLE_RANGE, SAMPLE_N, replace=False))


# ---------------------------------------------------------------------------
# the program's outputs, kept as the window runs
# ---------------------------------------------------------------------------

_PT_KEYS = ("pt_xyz", "pt_valid", "pt_map_id", "pt_desc", "pt_octave", "pt_angle",
            "active_map")
_FEAT_KEYS = ("uv", "angle", "octave", "desc", "valid")


def _copy(feats):
    return {n: getattr(feats, n).clone() for n in _FEAT_KEYS}


class Captures:
    """Wraps ``tracker.track_frame``, and for a depth sensor the program's
    depth front end (``stereo.match_stereo`` or ``stereo.depth_from_rgbd`` of
    the port's ``ops/stereo.py``): on the tracking thread, the first call of
    each frame the harness marks as sampled keeps copies of its inputs and
    outputs (device copies, no host read) in ``kept`` and ``depth_kept``."""

    def __init__(self, tracker_module, stereo_module=None, sensor="monocular"):
        self.mod, self.stereo, self.sensor = tracker_module, stereo_module, sensor
        self.orig = tracker_module.track_frame
        self.depth_name = {"stereo": "match_stereo", "rgbd": "depth_from_rgbd"}.get(sensor)
        self.depth_orig = getattr(stereo_module, self.depth_name) if self.depth_name else None
        self.thread = threading.get_ident()
        self.want = None        # stream index of a sampled frame in progress
        self.kept = {}          # stream index -> dict
        self.depth_kept = {}    # stream index -> dict

    def _sampled(self, kept):
        k = self.want
        if k is not None and k not in kept and threading.get_ident() == self.thread:
            return k
        return None

    def __enter__(self):
        orig = self.orig

        def track_frame(ms, K, feats, pose_pred, radius, **kw):
            out = orig(ms, K, feats, pose_pred, radius, **kw)
            k = self._sampled(self.kept)
            if k is not None:
                _, tr = out
                self.kept[k] = {
                    "pts": {n: getattr(ms, n).clone() for n in _PT_KEYS},
                    "feats": _copy(feats),
                    "K": K.clone(), "pose_pred": pose_pred.clone(), "radius": float(radius),
                    "kw": dict(kw), "pose": tr.pose.clone(), "assoc": tr.assoc.clone()}
            return out

        def match_stereo(feats_l, feats_r, bf, **kw):
            ur, z = self.depth_orig(feats_l, feats_r, bf, **kw)
            k = self._sampled(self.depth_kept)
            if k is not None:
                self.depth_kept[k] = {"left": _copy(feats_l), "right": _copy(feats_r),
                                      "ur": ur.clone(), "z": z.clone()}
            return ur, z

        def depth_from_rgbd(depth_img, uv, bf, **kw):
            ur, z = self.depth_orig(depth_img, uv, bf, **kw)
            k = self._sampled(self.depth_kept)
            if k is not None:
                self.depth_kept[k] = {"uv": uv.clone(), "ur": ur.clone(), "z": z.clone()}
            return ur, z

        self.mod.track_frame = track_frame
        if self.depth_name:
            wrap = match_stereo if self.sensor == "stereo" else depth_from_rgbd
            setattr(self.stereo, self.depth_name, wrap)
        return self

    def __exit__(self, *exc):
        self.mod.track_frame = self.orig
        if self.depth_name:
            setattr(self.stereo, self.depth_name, self.depth_orig)


# ---------------------------------------------------------------------------
# step checks
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _autocast(device, low: bool):
    """The control's precision: matrix products and convolutions in
    bfloat16 under autocast.  PyTorch has no bfloat16 linear solve, so the
    6x6 solve takes its bfloat16 normal equations in float32."""
    if not low:
        yield
        return
    orig = torch.linalg.solve_ex

    def solve_ex(A, B, **kw):
        return orig(A.float(), B.float(), **kw)

    torch.linalg.solve_ex = solve_ex
    try:
        with torch.autocast(device_type=torch.device(device).type, dtype=torch.bfloat16):
            yield
    finally:
        torch.linalg.solve_ex = orig


def reference_features(img_u8, orb_cfg, device, *, K=None, dist=None, low=False):
    """The reference's ORB features of a bank frame; with ``dist`` the
    keypoints undistorted to the ideal pinhole, as the program's are."""
    ex = orb.ORBExtractor(n_features=orb_cfg.n_features, n_levels=orb_cfg.n_levels,
                          scale_factor=orb_cfg.scale_factor, threshold=orb_cfg.ini_th_fast,
                          min_threshold=orb_cfg.min_th_fast, cell=orb_cfg.cell,
                          k_cell=orb_cfg.k_cell).to(device)
    with torch.no_grad(), _autocast(device, low):
        f = ex(img_u8.to(device=device, dtype=torch.float32))
    out = {n: getattr(f, n) for n in _FEAT_KEYS}
    if dist is not None:
        out["uv"] = distortion.undistort_pixels(K.to(device), dist.to(device), out["uv"])
    return out


def _popcount32(x):
    x = x.astype(np.uint32)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x * 0x01010101 & 0xFFFFFFFF) >> 24


def orb_agreement(a, b):
    """(rows that agree, max of the two valid counts) between feature sets."""
    def host(f):
        v = f["valid"].cpu().numpy()
        return (f["uv"].float().cpu().numpy()[v], f["angle"].float().cpu().numpy()[v],
                f["octave"].cpu().numpy()[v], f["desc"].cpu().numpy().view(np.uint32)[v])

    ua, aa, oa, da = host(a)
    ub, ab, ob, db = host(b)
    taken = np.zeros(len(ub), bool)
    agree = 0
    for i in range(len(ua)):
        d2 = np.sum((ub - ua[i]) ** 2, axis=1)
        cand = np.flatnonzero((d2 <= ORB_PX ** 2) & (ob == oa[i]) & ~taken)
        for j in cand[np.argsort(d2[cand])]:
            dang = np.abs(np.angle(np.exp(1j * (ab[j] - aa[i]))))
            bits = int(_popcount32(db[j] ^ da[i]).sum())
            if dang <= ORB_ANGLE and bits <= ORB_BITS:
                taken[j] = True
                agree += 1
                break
    return agree, max(len(ua), len(ub))


def _rot(q):
    w, x, y, z = q
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                     [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                     [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def centre(T_cw):
    T = np.asarray(T_cw, np.float64)
    R = _rot(T[:4] / np.linalg.norm(T[:4]))
    return -R.T @ T[4:7]


def pose_gap(Ta, Tb, depth):
    Ta, Tb = np.asarray(Ta, np.float64), np.asarray(Tb, np.float64)
    Ra, Rb = _rot(Ta[:4] / np.linalg.norm(Ta[:4])), _rot(Tb[:4] / np.linalg.norm(Tb[:4]))
    c = np.clip((np.trace(Ra.T @ Rb) - 1) / 2, -1.0, 1.0)
    return float(np.arccos(c) + np.linalg.norm(centre(Ta) - centre(Tb)) / max(depth, 1e-6))


def reference_track(kept, device, *, low=False):
    """(pose [7], assoc [F], median inlier depth) of the reference from a
    kept call's inputs."""
    kw = kept["kw"]
    pts = {n: t.to(device) for n, t in kept["pts"].items()}
    feats = {n: t.to(device) for n, t in kept["feats"].items()}
    K, pose_pred = kept["K"].to(device), kept["pose_pred"].to(device)
    with torch.no_grad(), _autocast(device, low):
        pose, assoc = track.track(pts, K, feats, pose_pred, kept["radius"],
                                  img_w=kw["img_w"], img_h=kw["img_h"],
                                  max_hamming=kw.get("max_hamming", track.matcher.TH_HIGH),
                                  nn_ratio=kw.get("nn_ratio", 0.9))
        pose = pose.float()
        X = pts["pt_xyz"][assoc.clamp_min(0).long()][assoc >= 0]
        depth = lie.se3_apply(pose, X)[:, 2]
    d = float(depth.median()) if depth.numel() else 1.0
    return pose.cpu().numpy(), assoc.cpu().numpy(), d


class _Feats:
    def __init__(self, f, device):
        for n in _FEAT_KEYS:
            setattr(self, n, f[n].to(device))


def reference_stereo(kept, bf, device, *, low=False):
    """(ur [F], z [F]) of the reference from a kept stereo call's features."""
    with torch.no_grad(), _autocast(device, low):
        return stereo.match_stereo(_Feats(kept["left"], device), _Feats(kept["right"], device),
                                   bf)


def stereo_rows(kept, bf, device, *, low=False):
    """(differing rows, valid left rows) of one sampled pair; with ``low``
    the reference under bfloat16 autocast stands in the program's place."""
    ur_r, z_r = reference_stereo(kept, bf, device)
    if low:
        ur_p, z_p = reference_stereo(kept, bf, device, low=True)
    else:
        ur_p, z_p = kept["ur"].to(device), kept["z"].to(device)
    valid = kept["left"]["valid"].to(device)
    bad = valid & (((ur_p >= 0) != (ur_r >= 0)) | (ur_p != ur_r) | (z_p != z_r))
    return int(bad.sum()), int(valid.sum())


def rgbd_rows(kept, feats, ref_raw, depth_img, stream, cam, device):
    """(differing rows, paired rows) of one sampled RGB-D frame.  ``feats``:
    the program's features of the frame (the kept ``track_frame`` call's);
    ``ref_raw``: the reference's features of the bank frame, keypoints in
    the image's own pixels."""
    uv_raw = ref_raw["uv"][ref_raw["valid"]].to(device)
    oct_r = ref_raw["octave"][ref_raw["valid"]].cpu().numpy()
    ideal = (distortion.undistort_pixels(stream.K.to(device), stream.dist.to(device), uv_raw)
             if stream.dist is not None else uv_raw)
    ur_r, z_r = stereo.depth_at_keypoints(depth_img.to(device), uv_raw, ideal[:, 0], cam.bf,
                                          depth_factor=cam.depth_factor, min_z=0.05,
                                          max_z=cam.th_depth)
    ideal, ur_r, z_r = (t.double().cpu().numpy() for t in (ideal, ur_r, z_r))
    v = feats["valid"].cpu().numpy()
    uv_p = kept["uv"].double().cpu().numpy()[v]
    oct_p = feats["octave"].cpu().numpy()[v]
    ur_p, z_p = (kept[n].double().cpu().numpy()[v] for n in ("ur", "z"))
    differ = paired = 0
    for i in range(len(uv_p)):
        d2 = np.sum((ideal - uv_p[i]) ** 2, axis=1)
        d2[oct_r != oct_p[i]] = np.inf
        j = int(np.argmin(d2)) if len(d2) else -1
        if j < 0 or d2[j] > ORB_PX ** 2:
            continue   # orb_miss judges the unpaired rows
        paired += 1
        if (z_p[i] >= 0) != (z_r[j] >= 0) or (z_r[j] >= 0 and (
                abs(z_p[i] - z_r[j]) > 1e-6 * z_r[j] or abs(ur_p[i] - ur_r[j]) > ORB_PX)):
            differ += 1
    return differ, paired


def step_readings(caps, stream, cfg, device, *, low=False):
    """The step numbers of the program's kept outputs (``caps``: the run's
    ``Captures``); with ``low`` the control's: the reference under bfloat16
    autocast, put in the program's place, against the reference."""
    kept_all, depth_all = caps.kept, caps.depth_kept
    out = {"orb_miss": None, "track_assoc_differ": None, "track_pose_gap": None}
    extra = {"stereo": "stereo_differ", "rgbd": "rgbd_depth_differ"}.get(stream.sensor)
    if extra:
        out[extra] = None
    if kept_all:
        agree = total = differ = rows = 0
        d_differ = d_rows = 0
        gap = 0.0
        cam = {"K": stream.K, "dist": stream.dist}
        for k, kept in sorted(kept_all.items()):
            images = [(stream.frame(k), kept["feats"])]
            if stream.sensor == "stereo" and k in depth_all:
                images.append((stream.right(k), depth_all[k]["right"]))
            for img, feats in images:
                ref_f = reference_features(img, cfg.orb, device, **cam)
                if low:
                    prog_f = reference_features(img, cfg.orb, device, low=True, **cam)
                else:
                    prog_f = feats
                a, n = orb_agreement(prog_f, ref_f)
                agree, total = agree + a, total + n
            if low:
                p_pose, p_assoc, _ = reference_track(kept, device, low=True)
            else:
                p_pose, p_assoc = kept["pose"].cpu().numpy(), kept["assoc"].cpu().numpy()
            r_pose, r_assoc, depth = reference_track(kept, device)
            differ += int(np.sum(p_assoc != r_assoc))
            rows += max(int(np.sum(p_assoc >= 0)), int(np.sum(r_assoc >= 0)), 1)
            gap = max(gap, pose_gap(p_pose, r_pose, depth))
            if stream.sensor == "rgbd" and k in depth_all and not low:
                raw = reference_features(stream.frame(k), cfg.orb, device)
                dd, dr = rgbd_rows(depth_all[k], kept["feats"], raw, stream.depth(k), stream,
                                   cfg.camera, device)
                d_differ, d_rows = d_differ + dd, d_rows + dr
        out.update(orb_miss=1.0 - agree / max(total, 1), track_assoc_differ=differ / rows,
                   track_pose_gap=gap)
        if stream.sensor == "rgbd" and d_rows:
            out["rgbd_depth_differ"] = d_differ / d_rows
    if stream.sensor == "stereo" and depth_all:
        d_differ = d_rows = 0
        for k, kept in sorted(depth_all.items()):
            dd, dr = stereo_rows(kept, cfg.camera.bf, device, low=low)
            d_differ, d_rows = d_differ + dd, d_rows + dr
        out["stereo_differ"] = d_differ / max(d_rows, 1)
    return out


# ---------------------------------------------------------------------------
# truth checks
# ---------------------------------------------------------------------------

def umeyama(src, dst, scale=True):
    """(s, R, t) with dst ~ s R src + t, numpy float64; without ``scale``
    s is held at 1."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    sc, dc = src - mu_s, dst - mu_d
    U, D, Vt = np.linalg.svd(dc.T @ sc / len(src))
    S = np.diag([1.0, 1.0, np.sign(np.linalg.det(U) * np.linalg.det(Vt))])
    R = U @ S @ Vt
    var = np.mean(np.sum(sc * sc, axis=1))
    s = float(np.trace(np.diag(D) @ S) / max(var, 1e-300)) if scale else 1.0
    return s, R, mu_d - s * R @ mu_s


def _ate(est_c, true_c, scale):
    s, R, t = umeyama(est_c, true_c, scale)
    err = np.linalg.norm((s * (R @ est_c.T)).T + t - true_c, axis=1)
    return float(np.sqrt(np.mean(err ** 2)))


def pose_alignment(est, true, scale=True):
    """(s, R, t) taking the estimate's world to the truth's from whole poses:
    R is the chordal mean of the cameras' rotation offsets, then s (held at 1
    without ``scale``) and t fit the centres.  Centres alone leave the
    rotation about a straight path free, and the points lie off it."""
    M = np.zeros((3, 3))
    for Te, Tt in zip(est, true):
        Re = _rot(Te[:4] / np.linalg.norm(Te[:4]))
        Rt = _rot(Tt[:4] / np.linalg.norm(Tt[:4]))
        M += Rt.T @ Re          # R_wc(true) R_wc(est)^T
    U, _, Vt = np.linalg.svd(M)
    R = U @ np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))]) @ Vt
    ce = np.stack([centre(T) for T in est])
    ct = np.stack([centre(T) for T in true])
    a, b = (R @ (ce - ce.mean(0)).T).T, ct - ct.mean(0)
    s = float(np.sum(a * b) / max(np.sum(a * a), 1e-300)) if scale else 1.0
    return s, R, ct.mean(0) - s * R @ ce.mean(0)


def nearest_distance(points, landmarks, chunk=512):
    out = []
    for i in range(0, len(points), chunk):
        d = np.linalg.norm(points[i:i + chunk, None, :] - landmarks[None, :, :], axis=2)
        out.append(d.min(axis=1))
    return np.concatenate(out) if out else np.zeros(0)


def truth_readings(program, stream):
    """``program``: host copies of the program's trajectory log, keyframes
    and points (``harness.host_state``).  Aligned by a Sim(3) for a
    monocular stream, an SE(3) for a depth sensor's."""
    scale = stream.sensor == "monocular"
    out = {"frame_ate_m": None, "kf_ate_m": None, "map_point_err_m": None}
    end = stream.warmup_frames + TRUTH_FRAMES
    frames = [(k, p) for k, p in program["frames"] if k < end]
    if len(frames) >= 3:
        est = np.stack([centre(p) for _, p in frames])
        true = np.stack([centre(stream.pose(k)) for k, _ in frames])
        out["frame_ate_m"] = _ate(est, true, scale)
    kfs = [(k, p) for k, p in program["keyframes"] if k < end]
    if len(kfs) >= 3:
        est = np.stack([centre(p) for _, p in kfs])
        true = np.stack([centre(stream.pose(k)) for k, _ in kfs])
        out["kf_ate_m"] = _ate(est, true, scale)
        pts = program["points"][program["point_kf"] < end]
        if len(pts):
            s, R, t = pose_alignment([np.asarray(p, np.float64) for _, p in kfs],
                                     [stream.pose(k) for k, _ in kfs], scale)
            moved = (s * (R @ pts.T)).T + t
            out["map_point_err_m"] = float(np.median(nearest_distance(moved, stream.landmarks)))
    return out


def verdict(readings: dict, limits: dict):
    """(correct, [(name, value, limit)]) over the cell's limits."""
    rows = [(n, readings.get(n), lim) for n, lim in limits.items()]
    ok = all(v is not None and np.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
