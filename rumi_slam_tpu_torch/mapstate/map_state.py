"""MapState: the SLAM map as structure-of-arrays tensors (port of the
``MapState`` record and ``empty`` of ``rumi_slam_tpu/mapstate/map_state.py``;
the rest of its API is not ported yet).

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


def empty(max_kf: int = 256, max_feat: int = 512, max_pt: int = 16384,
          device="cpu") -> MapState:
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


def from_numpy(d, device="cpu") -> MapState:
    """MapState from a dict of numpy arrays keyed by field name; uint32
    descriptor words are reinterpreted as int32, not converted."""
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
