"""The port's TUM driver (``python -m rumi_slam_tpu_torch.examples.run_tum``)
on a tiny synthetic sequence written to disk in TUM layout (rgb.txt, frames,
groundtruth.txt): the reference's RunTxt replay contract, as
``tests/test_run_tum.py`` holds the JAX driver to it.  Only the port runs here
(JAX's own driver test is marked slow).  Unpaced over PNG frames: the bounds
of JAX's test (ATE < 0.2 m, at least 2 keyframes), ``result.csv`` with
``RESULT_COLUMNS``, trajectory files both packages read.  Paced at real time
over PGM frames through the native ring: a CPU tracker cannot keep up, so
frames drop, and every frame is either tracked or counted as dropped."""

import csv

import numpy as np
import pytest
import torch

from rumi_slam_tpu.io import trajectory as jtio
from rumi_slam_tpu_torch.evaluation.harness import RESULT_COLUMNS
from rumi_slam_tpu_torch.examples import run_tum
from rumi_slam_tpu_torch.io import synthetic
from rumi_slam_tpu_torch.io import trajectory as ttio
from rumi_slam_tpu_torch.runtime import native
from test_runtime import write_pgm

N_FRAMES = 30
YAML = ("%YAML:1.0\n"
        "Camera1.fx: 256.0\nCamera1.fy: 256.0\n"
        "Camera1.cx: 159.5\nCamera1.cy: 119.5\n"
        "Camera.width: 320\nCamera.height: 240\nCamera.fps: 30\n"
        "ORBextractor.nFeatures: 256\nORBextractor.nLevels: 3\n")


def write_tum_dir(root, fmt):
    """The verify drive's first frames (``SyntheticSequence(seed=4)``, fx 256 as
    the YAML says) as 8-bit frames, with TUM groundtruth; returns the sequence."""
    seq = synthetic.SyntheticSequence(n_frames=N_FRAMES, width=320, height=240,
                                      n_points=1500, seed=4, patch=3)
    (root / "rgb").mkdir(parents=True)
    lines = []
    for i in range(len(seq)):
        img, t = seq.frame(i)
        arr = img.numpy().astype(np.uint8)
        name = f"rgb/{t:.6f}.{fmt}"
        if fmt == "png":
            from PIL import Image

            Image.fromarray(arr, mode="L").save(root / name)
        else:
            write_pgm(root / name, arr)
        lines.append(f"{t:.6f} {name}")
    (root / "rgb.txt").write_text("\n".join(lines) + "\n")
    ttio.save_tum(root / "groundtruth.txt", seq.times, torch.stack(seq.poses_gt).numpy())
    (root / "cam.yaml").write_text(YAML)
    return seq


def run_dir(out):
    runs = list(out.iterdir())
    assert len(runs) == 1
    return runs[0]


def read_row(run):
    with open(run / "result.csv") as f:
        reader = csv.DictReader(f)
        assert reader.fieldnames == RESULT_COLUMNS
        return next(reader)


def test_run_tum_offline_png(tmp_path):
    pytest.importorskip("PIL")
    pytest.importorskip("matplotlib")
    data = tmp_path / "seq"
    write_tum_dir(data, "png")
    run_tum.main(["--data", str(data), "--preset", str(data / "cam.yaml"),
                  "--out", str(tmp_path / "results"), "--no-rumination", "--device", "cpu"])
    run = run_dir(tmp_path / "results")
    row = read_row(run)
    assert float(row["ate"]) < 0.2, row
    assert int(row["n_kf"]) >= 2 and int(row["n_tracked"]) == N_FRAMES
    assert (run / "traj.png").stat().st_size > 1000 and (run / "map.png").exists()
    for name in ("whole_map.txt", "keyframes.txt"):
        tt, tp = ttio.load_tum(run / name)
        jt, jp = jtio.load_tum(run / name)
        assert len(tt) >= 2
        np.testing.assert_array_equal(np.asarray(tt), np.asarray(jt))
        np.testing.assert_allclose(np.asarray(tp), np.asarray(jp), atol=1e-6)


def test_run_tum_paced_pgm_through_the_ring(tmp_path):
    pytest.importorskip("matplotlib")
    if not native.available():
        pytest.skip("native runtime not built (no g++)")
    data = tmp_path / "seq"
    write_tum_dir(data, "pgm")
    run_tum.main(["--data", str(data), "--preset", str(data / "cam.yaml"), "--pace", "1.0",
                  "--out", str(tmp_path / "results"), "--device", "cpu"])
    row = read_row(run_dir(tmp_path / "results"))
    drops, n_tracked = int(row["drops"]), int(row["n_tracked"])
    assert drops > 0 and drops + n_tracked == N_FRAMES, row
    assert float(row["rss_mb"]) > 0
