# Frozen copy of ``match_stereo`` from rumi_slam_tpu_torch/ops/stereo.py at commit 9d1f191
# (plain PyTorch, no kernel): the benchmark's reference.  Imports made relative; the
# module's other functions left out.  ``depth_at_keypoints`` is written for the benchmark.
"""Stereo and RGB-D depth front ends (port of ``rumi_slam_tpu/ops/stereo.py``).

* ``match_stereo``: for every left keypoint the best right keypoint on
  (nearly) the same scanline within the disparity range, by descriptor
  distance, giving the virtual right u-coordinate ``ur`` and the metric depth
  ``z = bf / disparity``.  One masked dense Hamming matrix
  (``matcher.hamming_matrix``, a +-1 product computed outside any kernel in
  the JAX package too) and a cross-checked best match.
* ``depth_at_keypoints``: the depth map sampled at each raw keypoint,
  ``ur`` from the undistorted u.

Both return (ur [F], z [F]) with -1 for features without a measurement.
"""

from __future__ import annotations

import torch

from . import matcher

TH_STEREO_HAMMING = 80.0


def match_stereo(feats_l, feats_r, bf, *, min_z: float = 0.1, row_tol: float = 2.0,
                 max_hamming: float = TH_STEREO_HAMMING):
    """Left-right scanline matching -> (ur [F], z [F]); -1 where unmatched.

    Args:
      feats_l / feats_r: ``Features`` of the rectified left / right images.
      bf: fx * baseline (px * m).
      min_z: least admissible depth, so the largest disparity is bf / min_z.
      row_tol: scanline tolerance in px, scaled by ``1.2 ** octave`` of the
        left keypoint (a fixed factor, not the configuration's).
    """
    uv_l, uv_r = feats_l.uv, feats_r.uv
    bf = torch.as_tensor(bf, dtype=torch.float32, device=uv_l.device)
    max_disp = bf / min_z

    scale_l = torch.pow(1.2, feats_l.octave.to(torch.float32))
    dv = torch.abs(uv_l[:, 1][:, None] - uv_r[:, 1][None, :])
    disp = uv_l[:, 0][:, None] - uv_r[:, 0][None, :]
    mask = ((dv <= row_tol * scale_l[:, None])
            & (disp > 0.0)
            & (disp <= max_disp)
            & matcher.octave_mask(feats_l.octave, feats_r.octave, tol=1))
    dist = matcher.hamming_matrix(feats_l.desc, feats_r.desc)
    # the cross-check resolves repeated texture along the scanline
    idx, _ = matcher.match(dist, feats_l.valid, feats_r.valid, mask=mask,
                           max_dist=max_hamming, ratio=1.0, cross_check=True)
    matched = idx >= 0
    u_r = uv_r[idx.clamp_min(0).long(), 0]
    d = uv_l[:, 0] - u_r
    ur = torch.where(matched & (d > 0.0), u_r, -1.0)
    z = torch.where(ur >= 0, bf / torch.clamp_min(d, 1e-6), -1.0)
    return ur, z


def depth_at_keypoints(depth_img, uv_raw, u_undist, bf, *, depth_factor: float,
                       min_z: float, max_z: float):
    """ORB-SLAM's ``Frame::ComputeStereoFromRGBD``: the registered depth map
    is read at the raw (distorted) keypoint, where the image shows it, and
    ``ur = u - bf / z`` takes u from the undistorted keypoint.  The pixel is
    the nearest one and the range (min_z, max_z) is the program's
    (``depth_from_rgbd``).

    Args:
      depth_img: [H, W] raw depth; raw / ``depth_factor`` = metres.
      uv_raw: [F, 2] keypoints in the image's own pixels.
      u_undist: [F] the same keypoints' u on the ideal pinhole.
    Returns (ur [F], z [F]); -1 where the depth is missing or out of range.
    """
    h, w = depth_img.shape
    x = torch.clamp(torch.round(uv_raw[:, 0]).to(torch.int32), 0, w - 1).long()
    y = torch.clamp(torch.round(uv_raw[:, 1]).to(torch.int32), 0, h - 1).long()
    z = depth_img.to(torch.float32)[y, x] / depth_factor
    ok = (z > min_z) & (z < max_z) & torch.isfinite(z)
    bf = torch.as_tensor(bf, dtype=torch.float32, device=uv_raw.device)
    ur = torch.where(ok, u_undist - bf / torch.clamp_min(z, 1e-6), -1.0)
    return ur, torch.where(ok, z, -1.0)
