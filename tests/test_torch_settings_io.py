"""The port's settings reader (``io/settings.py``) and trajectory files
(``io/trajectory.py``) against the JAX package's: what
``tests/test_settings_io.py`` and ``tests/test_kb8_pipeline.py::
test_settings_kb8_branch`` check, that both packages build equal ``Config``
s from the same YAML, and that each package reads the other's TUM / EuRoC /
KITTI files.  Files are text with fixed decimals: the two packages write
the same bytes; poses read back agree to the files' precision (1e-5)."""

import dataclasses

import numpy as np
import pytest
import torch

from rumi_slam_tpu.io import settings as jst
from rumi_slam_tpu.io import trajectory as jtio
from rumi_slam_tpu_torch.config import Config
from rumi_slam_tpu_torch.geometry import lie as tlie
from rumi_slam_tpu_torch.io import settings as tst
from rumi_slam_tpu_torch.io import trajectory as ttio

REF_YAML = """\
%YAML:1.0
File.version: "1.0"
Camera.type: "PinHole"
Camera1.fx: 535.4
Camera1.fy: 539.2
Camera1.cx: 320.1
Camera1.cy: 247.6
Camera1.k1: 0.0
# a comment line
Camera.fps: 30
Camera.RGB: 1
Camera.width: 640
Camera.height: 480
Camera.bf: 40.0
RGBD.DepthMapFactor: 5000.0
ORBextractor.nFeatures: 2000
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
Viewer.KeyFrameSize: 0.05
"""

TUM1_YAML = """\
%YAML:1.0
Camera.type: "PinHole"
Camera1.fx: 517.306408
Camera1.fy: 516.469215
Camera1.cx: 318.643040
Camera1.cy: 255.313989
Camera1.k1: 0.262383
Camera1.k2: -0.953104
Camera1.p1: -0.005358
Camera1.p2: 0.002628
Camera1.k3: 1.163314
Stereo.ThDepth: 35.0
"""

KB8_YAML = (
    "%YAML:1.0\n"
    'Camera.type: "KannalaBrandt8"\n'
    "Camera1.fx: 190.9\nCamera1.fy: 190.9\n"
    "Camera1.cx: 254.9\nCamera1.cy: 256.8\n"
    "Camera1.k1: 0.0034\nCamera1.k2: 0.0007\n"
    "Camera1.k3: -0.0034\nCamera1.k4: 0.0009\n"
    "Camera.width: 512\nCamera.height: 512\n"
)


def write(tmp_path, name, text):
    p = tmp_path / name
    p.write_text(text)
    return p


def test_parse_opencv_yaml(tmp_path):
    p = write(tmp_path, "tum3.yaml", REF_YAML)
    d = tst.parse_opencv_yaml(p)
    assert d == jst.parse_opencv_yaml(p)
    assert d["Camera1.fx"] == 535.4 and d["Camera.width"] == 640
    assert d["Camera.type"] == "PinHole" and d["ORBextractor.nFeatures"] == 2000
    assert "a comment line" not in repr(d)


def test_config_from_settings(tmp_path):
    cfg = tst.load_settings(write(tmp_path, "tum3.yaml", REF_YAML))
    assert cfg.camera.fx == pytest.approx(535.4) and cfg.camera.cy == pytest.approx(247.6)
    assert cfg.orb.n_features == 2000 and cfg.orb.n_levels == 8
    # Camera.bf = 40 at fx = 535.4: a baseline of about 7.47 cm
    assert cfg.camera.baseline == pytest.approx(40.0 / 535.4)
    assert cfg.camera.bf == pytest.approx(40.0)
    assert cfg.camera.depth_factor == pytest.approx(5000.0)


def test_settings_kb8_branch(tmp_path):
    cfg = tst.load_settings(write(tmp_path, "fish.yaml", KB8_YAML))
    assert cfg.camera.model == "kb8"
    assert cfg.camera.kb_coeffs == (0.0034, 0.0007, -0.0034, 0.0009)
    assert cfg.camera.k1 == 0.0          # radtan stays off in fisheye mode


@pytest.mark.parametrize("text", [REF_YAML, TUM1_YAML, KB8_YAML, "%YAML:1.0\n"])
def test_both_packages_build_equal_configs(tmp_path, text):
    p = write(tmp_path, "s.yaml", text)
    assert dataclasses.asdict(tst.load_settings(p)) == dataclasses.asdict(jst.load_settings(p))
    base_t = tst.preset("icl")
    base_j = jst.preset("icl")
    assert dataclasses.asdict(tst.load_settings(p, base_t)) == \
        dataclasses.asdict(jst.load_settings(p, base_j))


def test_presets():
    for name in ("tum1", "tum2", "tum3", "euroc", "icl"):
        cfg = tst.preset(name)
        assert isinstance(cfg, Config) and cfg.camera.fx > 100
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jst.preset(name.upper()))
    assert tst.preset("tum3").orb.n_features == 2000
    assert tst.preset("euroc").camera.width == 752
    assert set(tst.PRESETS) == set(jst.PRESETS)
    with pytest.raises(KeyError):
        tst.preset("kitti99")


def random_traj(n=10, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    poses = np.concatenate([np.abs(q[:, :1]), q[:, 1:], rng.normal(size=(n, 3))],
                           axis=1).astype(np.float32)
    return np.arange(n) / 30.0, poses


def centres(poses):
    return tlie.se3_t(tlie.se3_inverse(torch.as_tensor(poses, dtype=torch.float32))).numpy()


def test_tum_roundtrip(tmp_path):
    times, poses = random_traj()
    p = tmp_path / "traj.txt"
    ttio.save_tum(p, times, poses)
    t2, p2 = ttio.load_tum(p)
    np.testing.assert_allclose(t2, times, atol=1e-5)
    np.testing.assert_allclose(centres(p2), centres(poses), atol=1e-4)   # the quaternion may flip
    assert ttio.load_tum(write(tmp_path, "empty.txt", "# nothing\n1 2 3\n"))[1].shape == (0, 7)


def test_euroc_format(tmp_path):
    times, poses = random_traj(5)
    p = tmp_path / "sub" / "euroc.txt"             # the directory is created
    ttio.save_euroc(p, times, poses)
    lines = p.read_text().strip().splitlines()
    assert len(lines) == 5
    first = lines[1].split()
    assert len(first) == 8 and int(first[0]) == round(times[1] * 1e9)


def test_kitti_format(tmp_path):
    _, poses = random_traj(4)
    p = tmp_path / "kitti.txt"
    ttio.save_kitti(p, poses)
    lines = p.read_text().strip().splitlines()
    assert len(lines) == 4
    M = np.asarray([float(v) for v in lines[2].split()]).reshape(3, 4)
    Twc = tlie.se3_inverse(torch.from_numpy(poses[2]))
    np.testing.assert_allclose(M[:, :3], tlie.quat_to_matrix(Twc[:4]).numpy(), atol=1e-5)
    np.testing.assert_allclose(M[:, 3], Twc[4:7].numpy(), atol=1e-5)


@pytest.mark.parametrize("fmt", ["tum", "euroc", "kitti"])
def test_files_cross_between_packages(tmp_path, fmt):
    """Both packages write the same bytes, and each reads the other's file."""
    times, poses = random_traj(12, seed=3)
    pt, pj = tmp_path / "port.txt", tmp_path / "jax.txt"
    if fmt == "kitti":
        ttio.save_kitti(pt, poses)
        jtio.save_kitti(pj, poses)
    else:
        getattr(ttio, f"save_{fmt}")(pt, times, poses)
        getattr(jtio, f"save_{fmt}")(pj, times, poses)
    assert pt.read_text() == pj.read_text()
    if fmt == "tum":
        for path in (pt, pj):
            t_t, p_t = ttio.load_tum(path)
            t_j, p_j = jtio.load_tum(path)
            np.testing.assert_array_equal(t_t, t_j)
            np.testing.assert_allclose(p_t, p_j, atol=1e-6)
            np.testing.assert_allclose(centres(p_t), centres(poses), atol=1e-5)
    else:
        rows = np.asarray([[float(v) for v in ln.split()] for ln in pj.read_text().splitlines()])
        assert rows.shape == (12, 12 if fmt == "kitti" else 8)


def test_empty_trajectory(tmp_path):
    for fmt in ("tum", "euroc"):
        getattr(ttio, f"save_{fmt}")(tmp_path / f"{fmt}.txt", np.zeros(0), np.zeros((0, 7)))
        assert (tmp_path / f"{fmt}.txt").read_text() == "\n"
    ttio.save_kitti(tmp_path / "k.txt", np.zeros((0, 7)))
    assert (tmp_path / "k.txt").read_text() == "\n"
    t, p = ttio.load_tum(tmp_path / "tum.txt")
    assert t.shape == (0,) and p.shape == (0, 7)
