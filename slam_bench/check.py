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

Truth checks, against the world and path the benchmark rendered, over a
fixed stretch of stream: the warm-up and the window's first
``TRUTH_FRAMES`` frames, so that a faster program is judged on the same
path as a slower one (monocular drift grows with the path).  The estimate
is read once the window has closed, and aligned to the truth by a Sim(3)
(monocular maps have no scale), in numpy float64:

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

from .reference import distortion, lie, orb, track

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


class Captures:
    """Wraps ``tracker.track_frame``: on the tracking thread, the first call
    of each frame the harness marks as sampled keeps copies of its inputs and
    outputs (device copies, no host read)."""

    def __init__(self, tracker_module):
        self.mod = tracker_module
        self.orig = tracker_module.track_frame
        self.thread = threading.get_ident()
        self.want = None        # stream index of a sampled frame in progress
        self.kept = {}          # stream index -> dict

    def __enter__(self):
        orig = self.orig

        def track_frame(ms, K, feats, pose_pred, radius, **kw):
            out = orig(ms, K, feats, pose_pred, radius, **kw)
            k = self.want
            if k is not None and k not in self.kept and threading.get_ident() == self.thread:
                _, tr = out
                self.kept[k] = {
                    "pts": {n: getattr(ms, n).clone() for n in _PT_KEYS},
                    "feats": {n: getattr(feats, n).clone() for n in _FEAT_KEYS},
                    "K": K.clone(), "pose_pred": pose_pred.clone(), "radius": float(radius),
                    "kw": dict(kw), "pose": tr.pose.clone(), "assoc": tr.assoc.clone()}
            return out

        self.mod.track_frame = track_frame
        return self

    def __exit__(self, *exc):
        self.mod.track_frame = self.orig


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


def step_readings(kept_all, stream, orb_cfg, device, *, low=False):
    """The three step numbers of the program's kept outputs; with ``low``
    the control's: the reference under bfloat16 autocast, put in the
    program's place, against the reference."""
    if not kept_all:
        return {"orb_miss": None, "track_assoc_differ": None, "track_pose_gap": None}
    agree = total = differ = rows = 0
    gap = 0.0
    cam = {"K": stream.K, "dist": stream.dist}
    for k, kept in sorted(kept_all.items()):
        ref_f = reference_features(stream.frame(k), orb_cfg, device, **cam)
        if low:
            prog_f = reference_features(stream.frame(k), orb_cfg, device, low=True, **cam)
            p_pose, p_assoc, _ = reference_track(kept, device, low=True)
        else:
            prog_f = kept["feats"]
            p_pose, p_assoc = kept["pose"].cpu().numpy(), kept["assoc"].cpu().numpy()
        a, n = orb_agreement(prog_f, ref_f)
        agree, total = agree + a, total + n
        r_pose, r_assoc, depth = reference_track(kept, device)
        differ += int(np.sum(p_assoc != r_assoc))
        rows += max(int(np.sum(p_assoc >= 0)), int(np.sum(r_assoc >= 0)), 1)
        gap = max(gap, pose_gap(p_pose, r_pose, depth))
    return {"orb_miss": 1.0 - agree / max(total, 1),
            "track_assoc_differ": differ / rows,
            "track_pose_gap": gap}


# ---------------------------------------------------------------------------
# truth checks
# ---------------------------------------------------------------------------

def umeyama(src, dst):
    """(s, R, t) with dst ~ s R src + t, numpy float64."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    sc, dc = src - mu_s, dst - mu_d
    U, D, Vt = np.linalg.svd(dc.T @ sc / len(src))
    S = np.diag([1.0, 1.0, np.sign(np.linalg.det(U) * np.linalg.det(Vt))])
    R = U @ S @ Vt
    var = np.mean(np.sum(sc * sc, axis=1))
    s = float(np.trace(np.diag(D) @ S) / max(var, 1e-300))
    return s, R, mu_d - s * R @ mu_s


def _ate(est_c, true_c):
    s, R, t = umeyama(est_c, true_c)
    err = np.linalg.norm((s * (R @ est_c.T)).T + t - true_c, axis=1)
    return float(np.sqrt(np.mean(err ** 2)))


def pose_alignment(est, true):
    """(s, R, t) taking the estimate's world to the truth's from whole poses:
    R is the chordal mean of the cameras' rotation offsets, then s and t fit
    the centres.  Centres alone leave the rotation about a straight path
    free, and the points lie off it."""
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
    s = float(np.sum(a * b) / max(np.sum(a * a), 1e-300))
    return s, R, ct.mean(0) - s * R @ ce.mean(0)


def nearest_distance(points, landmarks, chunk=512):
    out = []
    for i in range(0, len(points), chunk):
        d = np.linalg.norm(points[i:i + chunk, None, :] - landmarks[None, :, :], axis=2)
        out.append(d.min(axis=1))
    return np.concatenate(out) if out else np.zeros(0)


def truth_readings(program, stream):
    """``program``: host copies of the program's trajectory log, keyframes
    and points (``harness.host_state``)."""
    out = {"frame_ate_m": None, "kf_ate_m": None, "map_point_err_m": None}
    end = stream.warmup_frames + TRUTH_FRAMES
    frames = [(k, p) for k, p in program["frames"] if k < end]
    if len(frames) >= 3:
        est = np.stack([centre(p) for _, p in frames])
        true = np.stack([centre(stream.pose(k)) for k, _ in frames])
        out["frame_ate_m"] = _ate(est, true)
    kfs = [(k, p) for k, p in program["keyframes"] if k < end]
    if len(kfs) >= 3:
        est = np.stack([centre(p) for _, p in kfs])
        true = np.stack([centre(stream.pose(k)) for k, _ in kfs])
        out["kf_ate_m"] = _ate(est, true)
        pts = program["points"][program["point_kf"] < end]
        if len(pts):
            s, R, t = pose_alignment([np.asarray(p, np.float64) for _, p in kfs],
                                     [stream.pose(k) for k, _ in kfs])
            moved = (s * (R @ pts.T)).T + t
            out["map_point_err_m"] = float(np.median(nearest_distance(moved, stream.landmarks)))
    return out


def verdict(readings: dict, limits: dict):
    """(correct, [(name, value, limit)]) over the cell's limits."""
    rows = [(n, readings.get(n), lim) for n, lim in limits.items()]
    ok = all(v is not None and np.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
