"""CloudMap: the back-submap exchange contract: poses, keypoints, points and
observations (port of ``rumi_slam_tpu/rumination/cloud_map.py``).

Keyframes carry pose, stamp, keypoints and a feature->point index; points
carry positions.  The merge works from timestamps and pixel positions alone;
descriptors ride along as an optional extra (int32 words holding the uint32
bit pattern, as everywhere in the port) so that merged cloud KFs stay
matchable afterwards.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..mapstate import map_state as M
from ..ops.select import top_k


class CloudMap(NamedTuple):
    kf_pose: torch.Tensor    # [Kc,7] T_cw (cloud-world frame)
    kf_time: torch.Tensor    # [Kc]
    kf_uv: torch.Tensor      # [Kc,F,2]
    kf_octave: torch.Tensor  # [Kc,F]
    kf_point: torch.Tensor   # [Kc,F] -> cloud point row, -1
    kf_valid: torch.Tensor   # [Kc]
    kf_feat_valid: torch.Tensor  # [Kc,F]
    pt_xyz: torch.Tensor     # [Pc,3]
    pt_valid: torch.Tensor   # [Pc]
    kf_desc: Optional[torch.Tensor] = None  # [Kc,F,8] int32 (optional extra)
    kf_angle: Optional[torch.Tensor] = None


def from_map_state(ms: M.MapState, map_id) -> CloudMap:
    """Export one submap of a MapState as a CloudMap (the backend's output
    contract).  Rows keep their global index; non-members are masked out."""
    kf_sel = ms.kf_valid & (ms.kf_map_id == map_id)
    pt_sel = ms.pt_valid & (ms.pt_map_id == map_id)
    return CloudMap(
        kf_pose=ms.kf_pose,
        kf_time=ms.kf_time,
        kf_uv=ms.kf_uv,
        kf_octave=ms.kf_octave,
        kf_point=torch.where(
            kf_sel[:, None] & (ms.kf_point >= 0) & pt_sel[ms.kf_point.clamp_min(0).long()],
            ms.kf_point, -1),
        kf_valid=kf_sel,
        kf_feat_valid=ms.kf_feat_valid & kf_sel[:, None],
        pt_xyz=ms.pt_xyz,
        pt_valid=pt_sel,
        kf_desc=ms.kf_desc,
        kf_angle=ms.kf_angle,
    )


def strip_descriptors(cm: CloudMap) -> CloudMap:
    """The descriptor-less cloud map."""
    return cm._replace(kf_desc=None, kf_angle=None)


def reduce_feature_capacity(cm: CloudMap, max_feat: int) -> CloudMap:
    """Shrink the per-KF feature axis to ``max_feat`` slots, keeping per
    keyframe the point-bearing features first, then the other valid ones,
    in index order (a backend may run a larger ORB budget than the edge
    MapState has room for)."""
    Fc = cm.kf_uv.shape[1]
    if Fc <= max_feat:
        return cm
    # priority: has-point (2) > valid (1) > dead slot (0); stable by index
    score = ((cm.kf_point >= 0).to(torch.int32) * 2 + cm.kf_feat_valid.to(torch.int32)) * Fc \
        - torch.arange(Fc, device=cm.kf_uv.device)[None, :]
    _, idx = top_k(score, max_feat)  # [Kc, max_feat]

    def g(arr):  # gather along the feature axis
        ix = idx.reshape(idx.shape + (1,) * (arr.ndim - 2)).expand(
            idx.shape + arr.shape[2:])
        return torch.gather(arr, 1, ix)

    return cm._replace(
        kf_uv=g(cm.kf_uv),
        kf_octave=g(cm.kf_octave),
        kf_point=g(cm.kf_point),
        kf_feat_valid=g(cm.kf_feat_valid),
        kf_desc=None if cm.kf_desc is None else g(cm.kf_desc),
        kf_angle=None if cm.kf_angle is None else g(cm.kf_angle),
    )
