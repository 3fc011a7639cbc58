"""Host-side dataset loaders: TUM RGB-D, EuRoC, ICL-NUIM (a copy of
``rumi_slam_tpu/io/datasets.py``; numpy only, PIL imported where a frame is
decoded).

* TUM ``rgb.txt`` parsing mirrors the reference's ``Grabber::RunTxt``
  (cloud_edge_main.cpp:550-620);
* rgb/depth association mirrors the standard TUM ``associate.py`` tolerance
  policy used by the reference's RGB-D entry (Tracking.cc GrabImageRGBD);
* groundtruth registry + ICL axis-flip quirks mirror the reference's
  evaluation node (scripts/nodes/evo_node.py:74-164).

Images are decoded once and handed to the device pipeline as numpy arrays.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path

import numpy as np

__all__ = [
    "read_timestamp_file",
    "associate",
    "load_groundtruth",
    "resolve_groundtruth",
    "TumSequence",
    "EurocSequence",
    "euroc_gt_csv_to_txt",
    "DATASET_NAMES",
]


def read_timestamp_file(path):
    """Parse a TUM-style list file (``rgb.txt`` / ``depth.txt``):
    ``timestamp relative_path`` per line, '#' comments skipped.

    Returns (times [N] float64, paths list[str])."""
    times, paths = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            times.append(float(parts[0]))
            paths.append(parts[1])
    return np.asarray(times, dtype=np.float64), paths


def associate(t_a, t_b, *, max_dt: float = 0.02):
    """Greedy nearest-timestamp association between two streams (TUM
    associate.py semantics).  Returns (idx_a [M], idx_b [M]) int arrays of
    mutually-nearest pairs within ``max_dt`` seconds."""
    t_a = np.asarray(t_a, dtype=np.float64)
    t_b = np.asarray(t_b, dtype=np.float64)
    if len(t_a) == 0 or len(t_b) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    j = np.searchsorted(t_b, t_a)
    j_lo = np.clip(j - 1, 0, len(t_b) - 1)
    j_hi = np.clip(j, 0, len(t_b) - 1)
    pick = np.where(
        np.abs(t_b[j_hi] - t_a) < np.abs(t_b[j_lo] - t_a), j_hi, j_lo
    )
    dt = np.abs(t_b[pick] - t_a)
    ok = dt <= max_dt
    ia = np.nonzero(ok)[0]
    ib = pick[ok]
    # enforce one-to-one: keep the closest a for each b
    order = np.argsort(dt[ok], kind="stable")
    seen, keep = set(), []
    for k in order:
        if ib[k] not in seen:
            seen.add(int(ib[k]))
            keep.append(k)
    keep = np.sort(np.asarray(keep, dtype=np.int64))
    return ia[keep], ib[keep]


# Datasets the reference evaluates on (evo_node.py:131-160).
DATASET_NAMES = [
    "slam-tum/rgbd_dataset_freiburg1_floor",
    "slam-tum/rgbd_dataset_freiburg1_room",
    "slam-tum/rgbd_dataset_freiburg1_teddy",
    "slam-tum/rgbd_dataset_freiburg2_desk",
    "slam-tum/rgbd_dataset_freiburg2_pioneer_360",
    "slam-tum/rgbd_dataset_freiburg2_pioneer_slam",
    "slam-tum/rgbd_dataset_freiburg2_pioneer_slam2",
    "slam-tum/rgbd_dataset_freiburg2_pioneer_slam3",
    "slam-tum/rgbd_dataset_freiburg3_teddy",
    "slam-euroc/MH04",
    "slam-euroc/MH05",
    "slam-euroc/V102",
    "slam-euroc/V103",
    "slam-euroc/V201",
    "slam-euroc/V202",
    "slam-euroc/V203",
    "slam-icl/living_room_traj0_frei_png",
    "slam-icl/living_room_traj1_frei_png",
    "slam-icl/living_room_traj2_frei_png",
    "slam-icl/living_room_traj3_frei_png",
    "slam-icl/traj0_frei_png",
    "slam-icl/traj1_frei_png",
    "slam-icl/traj2_frei_png",
    "slam-icl/traj3_frei_png",
]

# ICL sequences whose vendored groundtruth needs an axis sign flip before
# comparison (evo_node.py:74-94).
_ICL_FLIP_X = {"living_room_traj0_frei_png"}
_ICL_FLIP_Y = {
    "living_room_traj2_frei_png", "living_room_traj3_frei_png",
    "traj0_frei_png", "traj1_frei_png", "traj2_frei_png", "traj3_frei_png",
}


def load_groundtruth(path, *, dataset_quirks: bool = True):
    """Load a groundtruth.txt: ``t tx ty tz q? q? q? q?`` per line.

    Returns (times [N], positions [N,3], quats [N,4] as-stored).  Note the
    vendored EuRoC files keep the CSV's (qw qx qy qz) order
    (dataset_preprocess/euroc_gt_csv_to_txt.py:25) while TUM/ICL are
    (qx qy qz qw); Sim3-aligned ATE only consumes positions, matching the
    reference's evaluation (evo_node.py:182-193).  ``dataset_quirks``
    applies the ICL axis flips from evo_node.py:74-94.
    """
    data = np.loadtxt(path, comments="#", dtype=np.float64)
    data = np.atleast_2d(data)
    times = data[:, 0]
    xyz = data[:, 1:4].copy()
    quat = data[:, 4:8] if data.shape[1] >= 8 else None
    if dataset_quirks:
        seq = os.path.basename(os.path.dirname(os.path.abspath(path)))
        if seq in _ICL_FLIP_X:
            xyz[:, 0] = -xyz[:, 0]
        if seq in _ICL_FLIP_Y:
            xyz[:, 1] = -xyz[:, 1]
    return times, xyz, quat


def resolve_groundtruth(dataset_root, name):
    """Map a bare sequence name (e.g. ``rgbd_dataset_freiburg1_floor``) to
    its groundtruth.txt under ``dataset_root`` (evo_node.py:162-167)."""
    for full in DATASET_NAMES:
        if os.path.basename(full) == name or full == name:
            return Path(dataset_root) / full / "groundtruth.txt"
    raise KeyError(f"unknown dataset {name!r}")


@dataclass
class TumSequence:
    """Replayable TUM-style sequence: grayscale frames + timestamps.

    ``root`` must contain ``rgb.txt`` (and optionally ``depth.txt`` +
    ``groundtruth.txt``).  Frames decode lazily; ``depth_factor`` is TUM's
    5000 (16-bit png -> meters)."""

    root: str
    depth_factor: float = 5000.0

    def __post_init__(self):
        self.root = str(self.root)
        self.times, self._rgb_paths = read_timestamp_file(
            os.path.join(self.root, "rgb.txt"))
        depth_file = os.path.join(self.root, "depth.txt")
        self.depth_times, self._depth_paths = (
            read_timestamp_file(depth_file)
            if os.path.exists(depth_file) else (np.zeros(0), [])
        )
        if len(self.depth_times):
            self._rgb2depth = dict(zip(*associate(self.times, self.depth_times)))
        else:
            self._rgb2depth = {}

    def __len__(self):
        return len(self.times)

    def _decode_gray(self, rel):
        from PIL import Image

        img = Image.open(os.path.join(self.root, rel)).convert("L")
        return np.asarray(img, dtype=np.float32)

    def frame(self, i: int):
        """(gray [H,W] float32, timestamp) — the monocular entry."""
        return self._decode_gray(self._rgb_paths[i]), float(self.times[i])

    def frame_rgbd(self, i: int):
        """(gray, depth [H,W] float32 meters or None, timestamp)."""
        gray, t = self.frame(i)
        j = self._rgb2depth.get(i)
        if j is None:
            return gray, None, t
        from PIL import Image

        d = Image.open(os.path.join(self.root, self._depth_paths[j]))
        depth = np.asarray(d, dtype=np.float32) / self.depth_factor
        return gray, depth, t

    def groundtruth(self):
        return load_groundtruth(os.path.join(self.root, "groundtruth.txt"))


def euroc_gt_csv_to_txt(csv_path, out_path):
    """Convert EuRoC ``state_groundtruth_estimate0/data.csv`` to TUM-style
    groundtruth.txt — the reference's preprocessing step
    (scripts/utils/dataset_preprocess/euroc_gt_csv_to_txt.py: ns -> s
    timestamps, keeps the CSV's (qw qx qy qz) quaternion order)."""
    rows = []
    with open(csv_path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            v = line.split(",")
            t = float(v[0]) * 1e-9
            tx, ty, tz = v[1:4]
            qw, qx, qy, qz = v[4:8]
            rows.append(f"{t:.6f} {tx} {ty} {tz} {qw} {qx} {qy} {qz}")
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    Path(out_path).write_text("\n".join(rows) + "\n")
    return len(rows)


@dataclass
class EurocSequence:
    """EuRoC MAV sequence: ``mav0/cam0/data.csv`` (ns timestamps + png
    filenames) + optional groundtruth CSV.  The reference replays EuRoC after
    converting it to TUM layout (dataset_preprocess/*); this loader reads the
    native layout directly."""

    root: str
    cam: str = "cam0"

    def __post_init__(self):
        self.root = str(self.root)
        csv_path = os.path.join(self.root, "mav0", self.cam, "data.csv")
        times, names = [], []
        with open(csv_path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                v = line.split(",")
                times.append(float(v[0]) * 1e-9)
                names.append(v[1].strip())
        self.times = np.asarray(times, np.float64)
        self._names = names

    def __len__(self):
        return len(self.times)

    def frame(self, i: int):
        from PIL import Image

        p = os.path.join(self.root, "mav0", self.cam, "data", self._names[i])
        img = Image.open(p).convert("L")
        return np.asarray(img, dtype=np.float32), float(self.times[i])

    def groundtruth(self):
        csv_path = os.path.join(
            self.root, "mav0", "state_groundtruth_estimate0", "data.csv")
        times, xyz, quat = [], [], []
        with open(csv_path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                v = line.split(",")
                times.append(float(v[0]) * 1e-9)
                xyz.append([float(x) for x in v[1:4]])
                quat.append([float(x) for x in v[4:8]])  # (qw qx qy qz)
        return (np.asarray(times), np.asarray(xyz), np.asarray(quat))
