"""MapState: the SLAM map as structure-of-arrays tensors (port of
``rumi_slam_tpu/mapstate/map_state.py``).

Every function returns new tensors for the fields it changes and never
writes into its input: the mapping worker's three-way merge needs the
snapshot it was given to stay as it was.  Scatters whose indices can repeat
are written so that their result does not depend on the order of the
writes: ``put_rows`` writes only the rows that write (the JAX package's
``mode="drop"``), and max/min/add reductions are order-free.

Descriptor fields are int32 holding the JAX package's uint32 bit patterns.
``from_numpy``/``to_numpy`` carry a map between the two packages: the JAX
``MapState`` as a dict of numpy arrays (``{k: np.asarray(v) for k, v in
ms._asdict().items()}``) comes in, and ``to_numpy`` gives the same dict back,
descriptors as uint32, ready for ``rumi_slam_tpu``'s ``MapState(**d)``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

DESC_FIELDS = ("kf_desc", "pt_desc")
MIN_COVIS_WEIGHT = 15  # reference KeyFrame::UpdateConnections threshold


class MapState(NamedTuple):
    # --- keyframes ---
    kf_pose: torch.Tensor       # [K,7] T_cw
    kf_uv: torch.Tensor         # [K,F,2] undistorted level-0 pixels
    kf_octave: torch.Tensor     # [K,F] int32
    kf_angle: torch.Tensor      # [K,F] float32
    kf_desc: torch.Tensor       # [K,F,8] int32 (uint32 bit pattern)
    kf_ur: torch.Tensor         # [K,F] float32 virtual right u (<0 = mono)
    kf_feat_valid: torch.Tensor # [K,F] bool
    kf_point: torch.Tensor      # [K,F] int32 — point id or -1
    kf_time: torch.Tensor       # [K] float32 seconds
    kf_map_id: torch.Tensor     # [K] int32 submap label
    kf_valid: torch.Tensor      # [K] bool
    kf_is_cloud: torch.Tensor   # [K] bool
    # --- points ---
    pt_xyz: torch.Tensor        # [P,3]
    pt_desc: torch.Tensor       # [P,8] int32 (uint32 bit pattern)
    pt_valid: torch.Tensor      # [P] bool
    pt_map_id: torch.Tensor     # [P] int32
    pt_ref_kf: torch.Tensor     # [P] int32
    pt_visible: torch.Tensor    # [P] float32 — frames where in frustum
    pt_found: torch.Tensor      # [P] float32 — frames where matched
    pt_octave: torch.Tensor     # [P] int32 — pyramid level of latest observation
    pt_angle: torch.Tensor      # [P] float32 — keypoint angle of latest observation
    # --- counters (0-d int32) ---
    n_kf: torch.Tensor
    n_pt: torch.Tensor
    active_map: torch.Tensor
    n_maps: torch.Tensor

    @property
    def max_kf(self):
        return self.kf_pose.shape[0]

    @property
    def max_feat(self):
        return self.kf_uv.shape[1]

    @property
    def max_pt(self):
        return self.pt_xyz.shape[0]


def _require_device(fn, device):
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"map_state.{fn}: device {str(device)!r} asked for and no CUDA device is present "
            "(pass device=\"cpu\" for the CPU)")
    return device


def empty(max_kf: int = 256, max_feat: int = 512, max_pt: int = 16384,
          device="cuda") -> MapState:
    """An empty map on ``device`` (the card unless the caller asks for the
    CPU; a host without one raises)."""
    device = _require_device("empty", device)
    K, F, P = max_kf, max_feat, max_pt
    f32, i32 = torch.float32, torch.int32

    def z(shape, dtype=f32):
        return torch.zeros(shape, dtype=dtype, device=device)

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=device)

    kf_pose = z((K, 7))
    kf_pose[:, 0] = 1.0
    return MapState(
        kf_pose=kf_pose,
        kf_uv=z((K, F, 2)),
        kf_octave=z((K, F), i32),
        kf_angle=z((K, F)),
        kf_desc=z((K, F, 8), i32),
        kf_ur=full((K, F), -1.0, f32),
        kf_feat_valid=z((K, F), torch.bool),
        kf_point=full((K, F), -1, i32),
        kf_time=z((K,)),
        kf_map_id=full((K,), -1, i32),
        kf_valid=z((K,), torch.bool),
        kf_is_cloud=z((K,), torch.bool),
        pt_xyz=z((P, 3)),
        pt_desc=z((P, 8), i32),
        pt_valid=z((P,), torch.bool),
        pt_map_id=full((P,), -1, i32),
        pt_ref_kf=full((P,), -1, i32),
        pt_visible=z((P,)),
        pt_found=z((P,)),
        pt_octave=z((P,), i32),
        pt_angle=z((P,)),
        n_kf=full((), 0, i32),
        n_pt=full((), 0, i32),
        active_map=full((), 0, i32),
        n_maps=full((), 1, i32),
    )


def from_numpy(d, device="cuda") -> MapState:
    """MapState from a dict of numpy arrays keyed by field name (the JAX
    package's state carried across), on the card unless ``device`` says
    otherwise; uint32 descriptor words are reinterpreted as int32, not
    converted."""
    device = _require_device("from_numpy", device)
    fields = {}
    for name in MapState._fields:
        a = np.asarray(d[name])
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        fields[name] = torch.from_numpy(a.copy()).to(device)  # copy keeps 0-d shapes
    return MapState(**fields)


def to_numpy(ms: MapState) -> dict:
    """Dict of numpy arrays keyed by field name, descriptors as uint32."""
    out = {}
    for name, t in ms._asdict().items():
        a = t.detach().cpu().numpy()
        out[name] = a.view(np.uint32) if name in DESC_FIELDS else a
    return out


# ---------------------------------------------------------------------------
# updates (out of place)
# ---------------------------------------------------------------------------

def put_rows(arr, idx, val, keep):
    """``arr`` with ``arr[idx[i]] = val[i]`` for the rows where ``keep[i]``;
    the other rows write nothing (``.at[idx].set(val, mode="drop")`` with
    the dropped rows routed out of range).  Kept rows that share an index
    must write equal values, or the result depends on the order of the
    writes.  The dropped rows go to a spare row past the end, which is cut
    off."""
    n = arr.shape[0]
    spare = torch.cat([arr, arr[:1]])
    tgt = torch.where(keep, idx.long(), n)
    return spare.index_put((tgt,), val.to(arr.dtype))[:n]


def put_row(arr, i, row):
    """``arr`` with row ``i`` (0-d tensor or int) replaced by ``row``."""
    i = torch.as_tensor(i, device=arr.device).long().reshape(1)
    return arr.index_put((i,), torch.as_tensor(row, dtype=arr.dtype, device=arr.device)[None])


def _scalar(x, dtype, device):
    return torch.as_tensor(x, dtype=dtype, device=device)


def insert_keyframe(ms: MapState, pose, feats, time, point_assoc, *, map_id=None,
                    is_cloud=False, ur=None):
    """Append a keyframe at slot ``ms.n_kf`` (no-op if the map is full).

    Args:
      feats: ops.orb.Features with capacity == max_feat.
      point_assoc: [F] int32 feature->point associations (-1 none).
      map_id: submap label (default: active map).
    Returns (ms, kf_id 0-d int32).
    """
    dev = ms.kf_pose.device
    k = ms.n_kf
    ok = k < ms.max_kf
    kc = torch.clamp(k, 0, ms.max_kf - 1)
    mid = ms.active_map if map_id is None else map_id

    def wr(arr, val):
        val = torch.as_tensor(val, dtype=arr.dtype, device=dev)
        return put_row(arr, kc, torch.where(ok, val, arr[kc.long()]))

    ur_row = (torch.full((ms.max_feat,), -1.0, dtype=torch.float32, device=dev)
              if ur is None else ur)
    ms = ms._replace(
        kf_pose=wr(ms.kf_pose, pose),
        kf_uv=wr(ms.kf_uv, feats.uv),
        kf_octave=wr(ms.kf_octave, feats.octave),
        kf_angle=wr(ms.kf_angle, feats.angle),
        kf_desc=wr(ms.kf_desc, feats.desc),
        kf_ur=wr(ms.kf_ur, ur_row),
        kf_feat_valid=wr(ms.kf_feat_valid, feats.valid),
        kf_point=wr(ms.kf_point, torch.where(feats.valid, point_assoc, -1)),
        kf_time=wr(ms.kf_time, _scalar(time, torch.float32, dev)),
        kf_map_id=wr(ms.kf_map_id, mid),
        kf_valid=wr(ms.kf_valid, True),
        kf_is_cloud=wr(ms.kf_is_cloud, is_cloud),
        n_kf=torch.where(ok, k + 1, k),
    )
    return ms, kc


def add_keyframes_bulk(ms: MapState, poses, uv, octave, angle, desc, feat_valid,
                       point_assoc, times, valid, *, map_id, is_cloud=True):
    """Append a batch of keyframes, compacting the rows without ``valid``
    (the import of a rumination CloudMap).  Slots go, in order, to the valid
    rows; rows past ``max_kf`` are dropped.  Only the rows that land write
    (their slots are distinct), so nothing depends on the order of writes.
    Returns (ms, kf_ids [Mk] int32, -1 where the row did not land)."""
    K = ms.max_kf
    dev = ms.kf_pose.device
    offs = torch.cumsum(valid.to(torch.int32), 0, dtype=torch.int32) - 1
    slot = ms.n_kf + offs
    usable = valid & (slot < K)
    slot_c = torch.clamp(slot, 0, K - 1)
    wmask = put_rows(torch.zeros((K,), dtype=torch.bool, device=dev), slot_c,
                     torch.ones_like(usable), usable)

    def scatter(arr, val):
        return put_rows(arr, slot_c, val, usable)

    ms = ms._replace(
        kf_pose=scatter(ms.kf_pose, poses),
        kf_uv=scatter(ms.kf_uv, uv),
        kf_octave=scatter(ms.kf_octave, octave),
        kf_angle=scatter(ms.kf_angle, angle),
        kf_desc=scatter(ms.kf_desc, desc),
        # bulk-imported (cloud) KFs are monocular: ur is -1 in the new slots
        kf_ur=torch.where(wmask[:, None], -1.0, ms.kf_ur),
        kf_feat_valid=scatter(ms.kf_feat_valid, feat_valid),
        kf_point=scatter(ms.kf_point, torch.where(feat_valid, point_assoc, -1)),
        kf_time=scatter(ms.kf_time, times),
        kf_map_id=torch.where(wmask, _scalar(map_id, torch.int32, dev), ms.kf_map_id),
        kf_valid=ms.kf_valid | wmask,
        kf_is_cloud=torch.where(wmask, _scalar(is_cloud, torch.bool, dev), ms.kf_is_cloud),
        n_kf=torch.clamp_max(ms.n_kf + torch.sum(valid.to(torch.int32)), K).to(torch.int32),
    )
    return ms, torch.where(usable, slot_c, -1).to(torch.int32)


def add_points(ms: MapState, xyz, desc, valid, ref_kf, *, map_id=None, octave=None,
               angle=None):
    """Append up to M points: slots go, in order, to the rows with
    ``valid``; rows past capacity are dropped.

    Args:
      xyz [M, 3], desc [M, 8], valid [M].
    Returns (ms, ids [M] int32 — allocated slot per row, -1 where none).
    """
    P = ms.max_pt
    dev = ms.pt_xyz.device
    mid = ms.active_map if map_id is None else map_id

    offs = torch.cumsum(valid.to(torch.int32), 0, dtype=torch.int32) - 1
    slot = ms.n_pt + offs
    usable = valid & (slot < P)
    slot_c = torch.clamp(slot, 0, P - 1)
    wmask = put_rows(torch.zeros((P,), dtype=torch.bool, device=dev), slot_c,
                      torch.ones_like(usable), usable)

    def scatter(arr, val):
        return put_rows(arr, slot_c, val, usable)

    ms = ms._replace(
        pt_xyz=scatter(ms.pt_xyz, xyz),
        pt_desc=scatter(ms.pt_desc, desc),
        pt_valid=ms.pt_valid | wmask,
        pt_map_id=torch.where(wmask, _scalar(mid, torch.int32, dev), ms.pt_map_id),
        pt_ref_kf=torch.where(wmask, _scalar(ref_kf, torch.int32, dev), ms.pt_ref_kf),
        pt_visible=torch.where(wmask, 1.0, ms.pt_visible),
        pt_found=torch.where(wmask, 1.0, ms.pt_found),
        pt_octave=ms.pt_octave if octave is None else scatter(ms.pt_octave, octave),
        pt_angle=ms.pt_angle if angle is None else scatter(ms.pt_angle, angle),
        n_pt=torch.clamp_max(ms.n_pt + torch.sum(valid.to(torch.int32)), P).to(torch.int32),
    )
    return ms, torch.where(usable, slot_c, -1).to(torch.int32)


def set_associations(ms: MapState, kf_id, assoc):
    """Overwrite feature->point associations of one KF ([F] int32, -1 none)."""
    assoc = torch.where(ms.kf_feat_valid[kf_id], assoc, -1)
    return ms._replace(kf_point=put_row(ms.kf_point, kf_id, assoc))


def refresh_point_descriptors(ms: MapState, kf_id):
    """Update observed points' representative descriptor, octave and angle
    from one KF's features: the most recent observation wins.

    Only the rows that observe a point write; where two rows of the KF
    observe one point, the later row wins.  (The JAX package also writes the
    unassociated rows, clipped to slot 0, with slot 0's old value, and on
    the CPU such a row after the one observing point 0 undoes that point's
    refresh: ROADMAP queue 3.)
    """
    pt = ms.kf_point[kf_id]
    ok = (pt >= 0) & ms.kf_feat_valid[kf_id]
    P, F = ms.max_pt, ms.max_feat
    rows = torch.arange(F, device=pt.device)
    last = torch.full((P + 1,), -1, dtype=torch.int64, device=pt.device).scatter_reduce(
        0, torch.where(ok, pt.long(), P), torch.where(ok, rows, -1), "amax")
    tgt = pt.clamp_min(0)
    writes = ok & (last[tgt.long()] == rows)
    return ms._replace(
        pt_desc=put_rows(ms.pt_desc, tgt, ms.kf_desc[kf_id], writes),
        pt_octave=put_rows(ms.pt_octave, tgt, ms.kf_octave[kf_id], writes),
        pt_angle=put_rows(ms.pt_angle, tgt, ms.kf_angle[kf_id], writes),
    )


# ---------------------------------------------------------------------------
# covisibility
# ---------------------------------------------------------------------------

def incidence(ms: MapState, map_id=None):
    """Boolean KF x point observation incidence B [K, P]."""
    K, F, P = ms.max_kf, ms.max_feat, ms.max_pt
    dev = ms.kf_point.device
    rows = torch.arange(K, device=dev)[:, None].expand(K, F)
    obs = (ms.kf_point >= 0) & ms.kf_valid[:, None]
    if map_id is not None:
        obs = obs & (ms.kf_map_id[:, None] == map_id)
    # every write is True, so repeated indices cannot race; column P is spare
    cols = torch.where(obs, ms.kf_point.long().clamp(0, P - 1), P)
    B = torch.zeros((K, P + 1), dtype=torch.bool, device=dev).index_put(
        (rows, cols), torch.tensor(True, device=dev))[:, :P]
    return B & ms.pt_valid[None, :]


def covisibility(ms: MapState, map_id=None):
    """Covisibility weights [K, K] int32 = number of shared points.  The 0/1
    products and their sums are exact in a float32 matmul (no TF32)."""
    B = incidence(ms, map_id).to(torch.float32)
    Wgt = B @ B.T
    Wgt = Wgt * (1.0 - torch.eye(ms.max_kf, device=B.device))
    return Wgt.to(torch.int32)


def point_obs_count(ms: MapState):
    """[P] number of observing keyframes per point."""
    return torch.sum(incidence(ms), dim=0).to(torch.int32)


def local_window(ms: MapState, kf_id, *, window: int):
    """Top-``window`` covisible KFs of ``kf_id`` (itself first).

    Returns (kf_ids [window] int32, valid [window] bool).
    """
    from ..ops.select import top_k

    Wgt = covisibility(ms)
    kf = torch.as_tensor(kf_id, device=Wgt.device).long()
    w = Wgt[kf] * ms.kf_valid.to(torch.int32) * (ms.kf_map_id == ms.kf_map_id[kf]).to(torch.int32)
    w = put_row(w, kf, 1 << 30)
    vals, ids = top_k(w, window)
    return ids.to(torch.int32), vals >= MIN_COVIS_WEIGHT


def relabel_map(ms: MapState, old_id, new_id):
    """Merge submap ``old_id`` into ``new_id``: relabel its KFs and points."""
    dev = ms.kf_map_id.device
    new = _scalar(new_id, torch.int32, dev)
    return ms._replace(
        kf_map_id=torch.where(ms.kf_map_id == old_id, new, ms.kf_map_id),
        pt_map_id=torch.where(ms.pt_map_id == old_id, new, ms.pt_map_id))


# ---------------------------------------------------------------------------
# slot reclamation and submap statistics
# ---------------------------------------------------------------------------

def compact(ms: MapState):
    """Reclaim dead slots: renumber valid KFs/points down to a contiguous
    prefix, remapping every cross-reference (kf_point values, pt_ref_kf).
    Runs on the host in numpy, rarely, at capacity pressure.

    Returns (ms, kf_old2new [K] int32 numpy with -1, pt_old2new [P] int32).
    """
    K, F, P = ms.max_kf, ms.max_feat, ms.max_pt
    dev = ms.kf_pose.device
    host = to_numpy(ms)
    kf_rows = np.flatnonzero(host["kf_valid"])
    pt_rows = np.flatnonzero(host["pt_valid"])
    nk, npt = len(kf_rows), len(pt_rows)
    kf_map = np.full(K, -1, np.int32)
    kf_map[kf_rows] = np.arange(nk, dtype=np.int32)
    pt_map = np.full(P, -1, np.int32)
    pt_map[pt_rows] = np.arange(npt, dtype=np.int32)

    out = to_numpy(empty(K, F, P, device="cpu"))
    for name, a in out.items():
        if name.startswith("kf_"):
            a[:nk] = host[name][kf_rows]
        elif name.startswith("pt_"):
            a[:npt] = host[name][pt_rows]
    kp = host["kf_point"][kf_rows]
    out["kf_point"][:nk] = np.where(kp >= 0, pt_map[np.clip(kp, 0, None)], -1)
    ref = host["pt_ref_kf"][pt_rows]
    out["pt_ref_kf"][:npt] = np.where(ref >= 0, kf_map[np.clip(ref, 0, None)], -1)
    out["n_kf"] = np.int32(nk)
    out["n_pt"] = np.int32(npt)
    out["active_map"] = host["active_map"]
    out["n_maps"] = host["n_maps"]
    return from_numpy(out, dev), kf_map, pt_map


def map_kf_count(ms: MapState, map_id):
    return torch.sum((ms.kf_map_id == map_id) & ms.kf_valid)


def map_duration(ms: MapState, map_id):
    """Timestamp span of a submap."""
    sel = (ms.kf_map_id == map_id) & ms.kf_valid
    tmax = torch.max(torch.where(sel, ms.kf_time, -float("inf")))
    tmin = torch.min(torch.where(sel, ms.kf_time, float("inf")))
    return torch.where(torch.any(sel), tmax - tmin, 0.0)


def map_trajectory_curvature(ms: MapState, map_id):
    """Path length / chord length of the KF camera centres (slot order is
    time order)."""
    from ..geometry import lie

    sel = (ms.kf_map_id == map_id) & ms.kf_valid
    centers = lie.se3_t(lie.se3_inverse(ms.kf_pose))
    pair = sel[:-1] & sel[1:]
    seg = torch.linalg.vector_norm(centers[1:] - centers[:-1], dim=-1) * pair
    path = torch.sum(seg)
    first = torch.argmax(sel.to(torch.int32))
    last = ms.max_kf - 1 - torch.argmax(torch.flip(sel, (0,)).to(torch.int32))
    chord = torch.linalg.vector_norm(centers[last] - centers[first])
    return torch.where(chord > 1e-6, path / torch.clamp_min(chord, 1e-6), 1.0)
