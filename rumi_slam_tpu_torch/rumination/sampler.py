"""Lost-frame recording, PD-controlled sampling and upload-bundle assembly
(port of ``rumi_slam_tpu/rumination/sampler.py``).

While tracking is lost (or not yet initialised in a new submap) every raw
frame is recorded and a PD-controlled optical-flow threshold picks a
keyframe-density subsample; once the new (edge-back) submap matures, the
upload bundle = tail of the edge-front KF images + lost frames + head of the
edge-back KF images, sorted by timestamp, goes to the rumination backend.

Host-side objects: the control flow is per-frame sequential; the array work
(LK flow, corner seeds) runs on the device of the image handed in.  A
recorded frame's image is a host numpy array.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..config import SamplerConfig
from ..ops import optical_flow
from ..ops.fast import fast_score, nms3x3
from ..ops.select import select_keypoints


class PDController:
    """Discrete PD law tracking a flow setpoint."""

    def __init__(self, kp: float, kd: float, setpoint: float):
        self.kp, self.kd, self.setpoint = kp, kd, setpoint
        self.prev_err = 0.0

    def step(self, measured: float) -> float:
        err = self.setpoint - measured
        out = self.kp * err + self.kd * (err - self.prev_err)
        self.prev_err = err
        return out

    def reset(self):
        self.prev_err = 0.0


@dataclass
class RecordedFrame:
    time: float
    image: np.ndarray


def _host(img) -> np.ndarray:
    return img.detach().cpu().numpy() if isinstance(img, torch.Tensor) else np.asarray(img)


class LostFrameSampler:
    """Records frames during loss; PD-subsamples by LK flow magnitude."""

    def __init__(self, cfg: SamplerConfig):
        self.cfg = cfg
        self.pd = PDController(cfg.pd_kp, cfg.pd_kd, cfg.pd_setpoint)
        self.all_frames: list[RecordedFrame] = []      # no-sampling list
        self.sampled: list[RecordedFrame] = []         # PD-subsampled list
        self._last_img: Optional[torch.Tensor] = None
        self._last_pts = None
        self._thresh = cfg.pd_setpoint

    def reset(self):
        self.pd.reset()
        self.all_frames.clear()
        self.sampled.clear()
        self._last_img = None
        self._last_pts = None

    def _reseed_points(self, img):
        score = nms3x3(fast_score(img, 12.0))
        yx, _, valid = select_keypoints(score, 128, cell=24, k_cell=4)
        if int(torch.sum(valid)) < 20:
            # degraded frames (blur, contrast collapse): the corners are gone
            # but large-scale gradients survive; seed LK from gradient energy
            gy, gx = torch.gradient(img, edge_order=1)
            score = nms3x3(gx * gx + gy * gy)
            yx, _, valid = select_keypoints(score, 128, cell=24, k_cell=4)
        pts = torch.stack([yx[:, 1], yx[:, 0]], -1).to(torch.float32)
        return pts, valid

    def record(self, img, t: float, host_image: Optional[np.ndarray] = None):
        """Feed one lost/uninitialised frame: ``img`` a float32 [H, W] tensor
        on the device that should do the flow; ``host_image`` its host copy
        where the caller has one already."""
        host = _host(img) if host_image is None else host_image
        self.all_frames.append(RecordedFrame(t, host))
        if self._last_img is None:
            self._select(img, t, host)
            return
        flow = float(optical_flow.mean_flow_magnitude(
            self._last_img, img, self._last_pts[0], self._last_pts[1]))
        # adaptive threshold = flow setpoint + PD correction
        self._thresh = max(1.0, self.cfg.pd_setpoint + self.pd.step(flow))
        if flow >= self._thresh:
            self._select(img, t, host)

    def _select(self, img, t: float, host: np.ndarray):
        self.sampled.append(RecordedFrame(t, host))
        self._last_img = img
        self._last_pts = self._reseed_points(img)


class BundleAssembler:
    """Builds the upload bundle once the edge-back map matures."""

    def __init__(self, cfg: SamplerConfig):
        self.cfg = cfg

    def gates_pass(self, n_back_kf: int, back_duration: float, back_curvature: float) -> bool:
        return (n_back_kf >= self.cfg.n_new_track_first
                and back_duration >= self.cfg.min_time_s
                and back_curvature > self.cfg.min_traj_curvature)

    def assemble(self, front_kf_frames: list[RecordedFrame], lost_frames: list[RecordedFrame],
                 back_kf_frames: list[RecordedFrame]) -> Optional[list[RecordedFrame]]:
        """Front tail (<= n_track_last) + lost + back head, time-sorted.
        Returns None if the bundle is too small."""
        front = front_kf_frames[-min(self.cfg.n_track_last, self.cfg.max_track_last):]
        back = back_kf_frames[: self.cfg.n_new_track_first]
        return self.combine(front, lost_frames, back)

    def combine(self, front: list[RecordedFrame], lost_frames: list[RecordedFrame],
                back: list[RecordedFrame]) -> Optional[list[RecordedFrame]]:
        """Gap-filter the lost frames, merge, time-sort, drop repeated
        timestamps, size-gate.  Callers that sized their context windows
        themselves use this directly; ``assemble`` adds the KF-tail trimming."""
        if not lost_frames:
            return None
        lo = front[-1].time if front else -np.inf
        hi = back[0].time if back else np.inf
        lost = [f for f in lost_frames if lo < f.time < hi]
        bundle = sorted(front + lost + back, key=lambda f: f.time)
        out: list[RecordedFrame] = []
        for f in bundle:
            if not out or f.time > out[-1].time + 1e-9:
                out.append(f)
        if len(out) < self.cfg.min_bundle or not lost:
            return None
        return out
