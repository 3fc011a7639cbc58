"""Single dataclass configuration: a copy of ``rumi_slam_tpu/config.py``.

The JAX package's ``config.py`` is JAX-free itself, but importing it runs
``rumi_slam_tpu/__init__.py``, which imports JAX; so the port carries its own
copy.  Only ``Config.intrinsics`` differs: it returns a torch tensor.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    fx: float = 525.0
    fy: float = 525.0
    cx: float = 319.5
    cy: float = 239.5
    width: int = 640
    height: int = 480
    fps: float = 30.0
    baseline: float = 0.0
    th_depth: float = 40.0
    depth_factor: float = 5000.0
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    model: str = "pinhole"
    kb_coeffs: tuple = (0.0, 0.0, 0.0, 0.0)

    @property
    def bf(self) -> float:
        return self.fx * self.baseline

    @property
    def dist_coeffs(self):
        return (self.k1, self.k2, self.p1, self.p2, self.k3)


@dataclasses.dataclass(frozen=True)
class ORBConfig:
    n_features: int = 1024
    n_levels: int = 8
    scale_factor: float = 1.2
    ini_th_fast: float = 20.0
    min_th_fast: float = 7.0
    cell: int = 32
    k_cell: int = 5


@dataclasses.dataclass(frozen=True)
class MapConfig:
    max_kf: int = 256
    max_pt: int = 16384
    local_window: int = 8
    local_ba_iters: int = 6
    lba_fixed_ring: int = 6
    min_covis_weight: int = 15
    kf_culling: bool = False
    overlapped: bool = True
    loop_closing: bool = True
    loop_check_interval: int = 4
    loop_min_score: int = 30
    loop_min_inliers: int = 25
    loop_gba_iters: int = 8


@dataclasses.dataclass(frozen=True)
class TrackConfig:
    match_radius: float = 15.0
    match_radius_wide: float = 30.0
    max_hamming: float = 80.0
    nn_ratio: float = 0.85
    min_track_inliers: int = 15
    min_localmap_inliers: int = 30
    kf_min_interval: int = 3
    kf_tracked_ratio: float = 0.8
    reloc_window_s: float = 3.0
    min_init_depth_points: int = 100
    max_new_depth_points: int = 128
    init_min_matches: int = 80
    init_min_inliers: int = 60
    new_map_min_kf: int = 10
    new_map_min_duration_s: float = 1.0
    new_map_min_curvature: float = 0.0


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    n_track_last: int = 40
    n_new_track_first: int = 40
    min_time_s: float = 3.0
    pd_kp: float = 0.8
    pd_kd: float = 0.08
    pd_setpoint: float = 12.0
    max_track_last: int = 50
    min_bundle: int = 30
    context_window_s: float = 1.6
    min_traj_curvature: float = 0.0


@dataclasses.dataclass(frozen=True)
class MergeConfig:
    max_match_kf: int = 40
    time_tolerance_s: float = 1e-4
    pixel_radius: float = 3.0
    min_inlier_ratio: float = 0.1
    welding_covis: int = 5
    sim3_iters: int = 8
    run_gba: bool = True
    gba_iters: int = 12
    retry_widened: bool = True
    retry_pixel_radius: float = 6.0
    retry_min_inlier_ratio: float = 0.05


@dataclasses.dataclass(frozen=True)
class Config:
    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    orb: ORBConfig = dataclasses.field(default_factory=ORBConfig)
    mapping: MapConfig = dataclasses.field(default_factory=MapConfig)
    tracking: TrackConfig = dataclasses.field(default_factory=TrackConfig)
    sampler: SamplerConfig = dataclasses.field(default_factory=SamplerConfig)
    merge: MergeConfig = dataclasses.field(default_factory=MergeConfig)
    verbosity: str = "QUIET"

    def intrinsics(self, device="cpu") -> torch.Tensor:
        """``[4]`` float32 ``(fx, fy, cx, cy)`` on ``device``."""
        c = self.camera
        return torch.tensor([c.fx, c.fy, c.cx, c.cy], dtype=torch.float32,
                            device=device)


def tiny_config(**over) -> Config:
    """Small capacities for tests."""
    base = Config(
        camera=CameraConfig(width=320, height=240, fx=260.0, fy=260.0, cx=159.5, cy=119.5),
        orb=ORBConfig(n_features=256, n_levels=3),
        mapping=MapConfig(max_kf=64, max_pt=4096, local_window=5,
                          overlapped=False),
        tracking=TrackConfig(min_track_inliers=12, min_localmap_inliers=20,
                             new_map_min_kf=4, new_map_min_duration_s=0.3),
        sampler=SamplerConfig(n_track_last=10, n_new_track_first=5,
                              min_time_s=0.4, min_bundle=10),
        merge=MergeConfig(max_match_kf=16),
    )
    return dataclasses.replace(base, **over)
