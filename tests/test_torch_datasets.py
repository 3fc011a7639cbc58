"""The port's dataset readers (``io/datasets.py``, a copy of the JAX
package's) against the JAX package's on fixtures the tests write: a TUM
layout with ``depth.txt`` and groundtruth, an EuRoC layout, ICL groundtruth
with its axis flips, and ``associate`` with its ``max_dt`` edge cases.
Tolerance: none — the readers are the same numpy code, so every array is
equal."""

import numpy as np
import pytest

from rumi_slam_tpu.io import datasets as jd
from rumi_slam_tpu_torch.io import datasets as td
from test_euroc_loader import _write_euroc


def same(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            same(x, y)
    elif a is None:
        assert b is None
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.fixture()
def tum_dir(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(3)
    (tmp_path / "rgb").mkdir()
    (tmp_path / "depth").mkdir()
    rgb, depth, gt = ["# color images"], ["# depth maps"], ["# timestamp tx ty tz qx qy qz qw"]
    for i in range(6):
        t = 1305031102.175304 + i / 30.0
        Image.fromarray(rng.integers(0, 255, (24, 32, 3), dtype=np.uint8), "RGB").save(
            tmp_path / "rgb" / f"{t:.6f}.png")
        rgb.append(f"{t:.6f} rgb/{t:.6f}.png")
        if i != 4:      # frame 4 has no depth within max_dt
            td_ = t + 0.004 * (i % 3)
            Image.fromarray(rng.integers(0, 20000, (24, 32), dtype=np.uint16)).save(
                tmp_path / "depth" / f"{td_:.6f}.png")
            depth.append(f"{td_:.6f} depth/{td_:.6f}.png")
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        gt.append(f"{t:.4f} " + " ".join(f"{v:.4f}" for v in (*rng.normal(size=3), *q)))
    (tmp_path / "rgb.txt").write_text("\n".join(rgb) + "\n")
    (tmp_path / "depth.txt").write_text("\n".join(depth) + "\n")
    (tmp_path / "groundtruth.txt").write_text("\n".join(gt) + "\n")
    return tmp_path


def test_tum_sequence_as_jax(tum_dir):
    a, b = td.TumSequence(tum_dir), jd.TumSequence(tum_dir)
    assert len(a) == len(b) == 6
    same(a.times, b.times)
    assert a._rgb2depth == b._rgb2depth and 4 not in a._rgb2depth
    for i in range(6):
        fa, fb = a.frame(i), b.frame(i)
        same(fa, fb)
        assert fa[0].dtype == np.float32 and fa[0].shape == (24, 32)
        ra, rb = a.frame_rgbd(i), b.frame_rgbd(i)
        same(ra, rb)
        assert (ra[1] is None) == (i == 4)
    same(a.groundtruth(), b.groundtruth())
    same(td.read_timestamp_file(tum_dir / "depth.txt"), jd.read_timestamp_file(tum_dir / "depth.txt"))


def test_euroc_as_jax(tmp_path):
    _write_euroc(tmp_path)
    a, b = td.EurocSequence(tmp_path), jd.EurocSequence(tmp_path)
    same(a.times, b.times)
    for i in range(len(b)):
        same(a.frame(i), b.frame(i))
    same(a.groundtruth(), b.groundtruth())
    src = tmp_path / "mav0" / "state_groundtruth_estimate0" / "data.csv"
    assert td.euroc_gt_csv_to_txt(src, tmp_path / "t.txt") == jd.euroc_gt_csv_to_txt(
        src, tmp_path / "j.txt") == 5
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    same(td.load_groundtruth(tmp_path / "t.txt"), jd.load_groundtruth(tmp_path / "j.txt"))


@pytest.mark.parametrize("seq", ["traj0_frei_png", "living_room_traj0_frei_png",
                                 "living_room_traj1_frei_png", "rgbd_dataset_freiburg1_floor"])
def test_icl_axis_flips_as_jax(tmp_path, seq):
    d = tmp_path / seq
    d.mkdir()
    rows = np.random.default_rng(1).normal(size=(7, 8))
    rows[:, 0] = np.arange(7)
    np.savetxt(d / "groundtruth.txt", rows, fmt="%.6f")
    for quirks in (True, False):
        a = td.load_groundtruth(d / "groundtruth.txt", dataset_quirks=quirks)
        same(a, jd.load_groundtruth(d / "groundtruth.txt", dataset_quirks=quirks))
    raw = td.load_groundtruth(d / "groundtruth.txt", dataset_quirks=False)[1]
    fixed = td.load_groundtruth(d / "groundtruth.txt")[1]
    flip = {"traj0_frei_png": [1, -1, 1], "living_room_traj0_frei_png": [-1, 1, 1]}
    np.testing.assert_array_equal(fixed, raw * np.asarray(flip.get(seq, [1, 1, 1])))


def test_resolve_groundtruth_as_jax(tmp_path):
    for name in ("rgbd_dataset_freiburg1_floor", "slam-euroc/MH04", "traj2_frei_png"):
        assert td.resolve_groundtruth(tmp_path, name) == jd.resolve_groundtruth(tmp_path, name)
    with pytest.raises(KeyError):
        td.resolve_groundtruth(tmp_path, "nope")
    assert td.DATASET_NAMES == jd.DATASET_NAMES


@pytest.mark.parametrize("ta,tb,max_dt", [
    ([0.0, 1.0, 2.0, 3.0], [0.005, 1.5, 2.001, 2.9999], 0.02),
    ([0.0, 0.004], [0.002], 0.02),            # one-to-one: the closer a wins
    ([0.0, 0.02, 0.04], [0.02], 0.02),        # exactly max_dt away counts
    ([0.0, 1.0], [0.0200001, 1.03], 0.02),    # just outside max_dt
    ([], [1.0], 0.02),
    ([1.0], [], 0.02),
    ([0.0, 0.01, 0.02, 0.03], [0.005, 0.015, 0.025], 0.0),
    ([0.0, 0.01, 0.02, 0.03], [0.005, 0.015, 0.025], 0.005),   # ties between neighbours
])
def test_associate_as_jax(ta, tb, max_dt):
    a = td.associate(np.asarray(ta), np.asarray(tb), max_dt=max_dt)
    same(a, jd.associate(np.asarray(ta), np.asarray(tb), max_dt=max_dt))
    assert a[0].dtype == np.int64 and len(set(a[1].tolist())) == len(a[1])
