"""Tests of the benchmark's sensors on the CPU at a tiny size: the
configuration's sensor keys, the stereo and RGB-D banks, the depth
sensors' step checks, their SE(3) truth alignment and their faults.

    python -m pytest -q slam_bench/test_sensors.py
"""

from __future__ import annotations

import dataclasses
import json
from unittest import mock

import numpy as np
import pytest
import torch

from slam_bench import check, harness, stream
from slam_bench.reference import camera
from slam_bench.test_slam_bench import ROOT, SEED, STEP, TINY_CONFIG, TINY_TRAFFIC, TRUTH

TINY_DEPTH = {k: v for k, v in TINY_CONFIG.items() if not k.startswith("Camera.")}
TINY_DEPTH.update({"Camera.width": 320, "Camera.height": 240, "Camera.fps": 10.0,
                   "Camera1.fx": 260.0, "Camera1.fy": 260.0, "Camera1.cx": 159.5,
                   "Camera1.cy": 119.5, "Stereo.b": 0.11})
TINY_STEREO = dict(TINY_DEPTH, sensor="stereo", **{"Camera.type": "Rectified",
                                                   "Stereo.ThDepth": 35.0})
# ThDepth past the world's farthest landmark: the program's depth range then
# cuts nothing
TINY_RGBD = dict(TINY_DEPTH, sensor="rgbd", **{"Camera.type": "PinHole", "Stereo.ThDepth": 100.0,
                                               "RGBD.DepthMapFactor": 5000.0})
# TUM1's published radtan (ORB-SLAM's TUM1.yaml)
TUM1_RADTAN = {"Camera1.k1": 0.262383, "Camera1.k2": -0.953104, "Camera1.p1": -0.005358,
               "Camera1.p2": 0.002628, "Camera1.k3": 1.163314}


def _old_build_config(c):
    """``harness.build_config`` as it was before sensors: the monocular keys."""
    from rumi_slam_tpu_torch.config import Config

    base = Config()
    cam = dataclasses.replace(
        base.camera, fx=float(c["Camera.fx"]), fy=float(c["Camera.fy"]),
        cx=float(c["Camera.cx"]), cy=float(c["Camera.cy"]),
        width=int(c["Camera.width"]), height=int(c["Camera.height"]),
        fps=float(c["Camera.fps"]),
        k1=float(c.get("Camera.k1", 0.0)), k2=float(c.get("Camera.k2", 0.0)),
        p1=float(c.get("Camera.p1", 0.0)), p2=float(c.get("Camera.p2", 0.0)),
        k3=float(c.get("Camera.k3", 0.0)))
    orb = dataclasses.replace(
        base.orb, n_features=int(c["ORBextractor.nFeatures"]),
        n_levels=int(c["ORBextractor.nLevels"]),
        scale_factor=float(c["ORBextractor.scaleFactor"]),
        ini_th_fast=float(c["ORBextractor.iniThFAST"]),
        min_th_fast=float(c["ORBextractor.minThFAST"]))
    mapping = dataclasses.replace(base.mapping, **c.get("assumed", {}).get("mapping", {}))
    return dataclasses.replace(base, camera=cam, orb=orb, mapping=mapping)


# ---------------------------------------------------------------------------
# the configuration's sensor
# ---------------------------------------------------------------------------

def test_a_monocular_file_builds_the_config_it_built_before():
    mono = harness.load("configs", "euroc-mono-det")
    assert "sensor" not in mono
    for c in (mono, TINY_CONFIG, dict(mono, sensor="monocular")):
        assert harness.build_config(c) == _old_build_config(c)


def test_depth_files_give_baseline_th_depth_and_depth_factor():
    c = harness.load("configs", "euroc-stereo-det")
    cam = harness.build_config(c).camera
    assert (cam.fx, cam.fy, cam.cx, cam.cy) == (435.2046959714599, 435.2046959714599,
                                                367.4517211914062, 252.2008514404297)
    assert (cam.width, cam.height, cam.fps) == (752, 480, 20.0)
    assert cam.baseline == c["Stereo.b"] and cam.bf == pytest.approx(47.90639384423901, rel=1e-12)
    assert cam.th_depth == c["Stereo.b"] * 35.0 and cam.th_depth == pytest.approx(3.8527, abs=1e-4)
    assert cam.dist_coeffs == (0.0,) * 5 and cam.model == "pinhole"
    assert harness.build_config(c).orb.n_features == 1200
    # the monocular keys are absent: a harness that reads only those fails
    # on this file before set-up
    with pytest.raises(KeyError, match="Camera.fx"):
        _old_build_config(c)

    cam = harness.build_config(dict(TINY_RGBD, **TUM1_RADTAN)).camera
    assert (cam.baseline, cam.th_depth, cam.depth_factor) == (0.11, 0.11 * 100.0, 5000.0)
    assert cam.dist_coeffs == tuple(TUM1_RADTAN[f"Camera1.{k}"]
                                    for k in ("k1", "k2", "p1", "p2", "k3"))


@pytest.mark.parametrize("bad", [dict(TINY_STEREO, sensor="sonar"),
                                 dict(TINY_STEREO, **{"Camera.type": "PinHole"}),
                                 dict(TINY_RGBD, **{"Camera.type": "KannalaBrandt8"})])
def test_an_unknown_sensor_or_camera_type_is_refused(bad):
    with pytest.raises(ValueError):
        harness.build_config(bad)


# ---------------------------------------------------------------------------
# the banks
# ---------------------------------------------------------------------------

def _stream(conf, traffic=None, seed=SEED):
    cfg = harness.build_config(conf)
    return stream.Stream(traffic or dict(TINY_TRAFFIC, landmarks=300, bank_s=1.0), cfg.camera,
                         seed, "cpu", harness.sensor_of(conf))


def _grey(img):
    return torch.clamp(torch.round(img), 0, 255).to(torch.uint8)


def test_each_sensor_renders_its_grey_bank():
    """A monocular bank is the splat renderer's as it was; an RGB-D stream
    adds its depth to the same grey frames; a stereo stream renders its
    rectified pair as seen (``render_pair_frame``)."""
    mono = _stream(TINY_CONFIG)
    cfg = harness.build_config(TINY_CONFIG)
    traffic = dict(TINY_TRAFFIC, landmarks=300, bank_s=1.0)
    world = stream.make_world(300, [0, 0], [0, 1])
    for i in range(mono.n_bank):
        img = stream.render_frame(world, mono.K, torch.from_numpy(mono.poses[i]),
                                  width=320, height=240, patch=traffic["patch"], dist=mono.dist)
        assert torch.equal(mono.bank[i], _grey(img))
    assert mono.bank_r is None and mono.bank_d is None and cfg.camera.baseline == 0.0
    pin = dict(TINY_CONFIG, **{k: 0.0 for k in ("Camera.k1", "Camera.k2", "Camera.p1",
                                               "Camera.p2")})
    pinhole = _stream(pin)
    rgbd = _stream(TINY_RGBD)
    assert torch.equal(rgbd.bank, pinhole.bank) and np.array_equal(rgbd.poses, pinhole.poses)
    pair = _stream(TINY_STEREO)
    assert np.array_equal(pair.poses, pinhole.poses) and pair.dist is None
    size = dict(width=320, height=240, patch=traffic["patch"])
    for i in range(pair.n_bank):
        T = torch.from_numpy(pair.poses[i])
        assert torch.equal(pair.bank[i], _grey(stream.render_pair_frame(world, pair.K, T, **size)))
        T_r = T + torch.tensor([0, 0, 0, 0, -0.11, 0, 0])
        assert torch.equal(pair.right(i), _grey(stream.render_pair_frame(world, pair.K, T_r,
                                                                          **size)))
    assert not torch.equal(pair.bank, pinhole.bank)


def _two_landmarks():
    """Two landmarks in front of the first pose, apart on the image, and a
    third just nearer than the second, dimmer, splatted onto it."""
    xyz = torch.tensor([[-0.4, 0.1, 2.0], [0.5, -0.2, 3.5], [0.5, -0.2, 3.4]])
    inten = torch.tensor([200.0, 220.0, 70.0])
    size = torch.tensor([0.05, 0.05, 0.05])
    tex = torch.ones(3, 2 * stream.TEX_R + 1, 2 * stream.TEX_R + 1)
    return stream.World(xyz, inten, size, tex)


def _centroid(line, c):
    """Centroid of the splat's light over the background in the run of
    ``line`` that holds index c."""
    a = b = c
    while a > 0 and line[a - 1] > 40:
        a -= 1
    while b < len(line) - 1 and line[b + 1] > 40:
        b += 1
    w = np.asarray(line[a:b + 1], np.float64) - 40.0
    return float(np.sum(w * np.arange(a, b + 1)) / np.sum(w))


def test_the_right_bank_sees_each_splat_bf_over_z_to_the_left():
    world = stream.World(*(t[:2] for t in _two_landmarks()))   # two apart
    with mock.patch.object(stream, "make_world", lambda *a, **k: world):
        s = _stream(TINY_STEREO)
    bf = 260.0 * 0.11
    for i in (0, s.n_bank - 1):
        uv, z = camera.project_world(s.K, torch.from_numpy(s.poses[i]), world.xyz)
        left, right = s.frame(i).int(), s.right(i).int()
        for (u, v), d in zip(uv.tolist(), z.tolist()):
            assert bf / d > 5.0   # a disparity the test can see
            ul, vl, ur = round(u), round(v), round(u - bf / d)
            assert left[vl, ul] > 40 and right[vl, ur] > 40
            # each splat at its sub-pixel centre: the same row, bf / z to the left
            assert _centroid(left[vl].tolist(), ul) == pytest.approx(u, abs=0.02)
            assert _centroid(right[vl].tolist(), ur) == pytest.approx(u - bf / d, abs=0.02)
            assert _centroid(left[:, ul].tolist(), vl) == pytest.approx(v, abs=0.02)
            assert _centroid(right[:, ur].tolist(), vl) == pytest.approx(v, abs=0.02)


def test_a_pair_frame_shows_the_nearer_splat():
    """The third landmark, dimmer and nearer, hides the second where they
    overlap, in both frames of the pair; the monocular renderer keeps the
    brighter one."""
    world = _two_landmarks()
    with mock.patch.object(stream, "make_world", lambda *a, **k: world):
        s = _stream(TINY_STEREO)
        mono = _stream(dict(TINY_CONFIG, **{k: 0.0 for k in ("Camera.k1", "Camera.k2",
                                                             "Camera.p1", "Camera.p2")}))
    uv, z = camera.project_world(s.K, torch.from_numpy(s.poses[0]), world.xyz)
    bf = 260.0 * 0.11
    u, v = uv[2].tolist()
    assert abs(uv[1, 0] - u) < 2.0 and abs(uv[1, 1] - v) < 2.0   # the squares overlap
    assert int(s.frame(0)[round(v), round(u)]) == 70
    assert int(s.right(0)[round(v), round(u - bf / float(z[2]))]) == 70
    assert int(mono.frame(0)[round(v), round(u)]) == 220


def test_depth_pixels_hold_the_shown_landmark_and_background_is_zero():
    with mock.patch.object(stream, "make_world", lambda *a, **k: _two_landmarks()):
        s = _stream(TINY_RGBD)
    world = _two_landmarks()
    uv, z = camera.project_world(s.K, torch.from_numpy(s.poses[0]), world.xyz)
    img, dep = s.frame(0).int(), s.depth(0).int()
    assert s.bank_d.dtype == torch.uint16
    # the first landmark's centre, and the second's, which is brighter than
    # the third, nearer one splatted onto the same pixels
    for i in (0, 1):
        u, v = (int(round(x)) for x in uv[i].tolist())
        assert int(dep[v, u]) == int(torch.round(z[i] * 5000.0))
    assert int(torch.round(z[2] * 5000.0)) != int(torch.round(z[1] * 5000.0))
    # depth exactly where a splat shows, 0 on the background
    assert torch.equal(dep > 0, img != 40)
    assert int(dep[0, 0]) == 0


# ---------------------------------------------------------------------------
# tiny runs of the depth sensors
# ---------------------------------------------------------------------------

def depth_cell(conf, extra):
    """The tiny depth cell: the mono tiny cell's limits, and ``extra`` at
    0.01."""
    from slam_bench.test_slam_bench import tiny_cell

    limits = dict(tiny_cell()["limits"], **{extra: 0.01})
    return {"config_params": conf, "traffic_params": TINY_TRAFFIC, "chips": 1, "limits": limits}


def depth_run(conf, extra, faults=(), control=False):
    torch.set_num_threads(2)
    with mock.patch.object(check, "SAMPLE_RANGE", 6):
        res, _ = harness.execute("tiny", SEED, 6.0, False, device="cpu",
                                 cell=depth_cell(conf, extra), faults=faults, control=control)
    return res


@pytest.mark.parametrize("conf,extra", [(TINY_STEREO, "stereo_differ"),
                                        (TINY_RGBD, "rgbd_depth_differ")])
def test_a_sound_tiny_depth_run_is_correct_and_its_control_is_not(conf, extra):
    res = depth_run(conf, extra, control=True)
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == set(STEP) | set(TRUTH) | {extra}
    assert set(res["readings"]) == set(STEP) | set(TRUTH) | {extra}
    assert res["checks"][extra]["value"] == 0.0
    assert res["checks"]["orb_miss"]["value"] == 0.0
    # the control: the reference in bfloat16 in the program's place
    ok, rows = check.verdict(res["control"], {n: depth_cell(conf, extra)["limits"][n]
                                              for n in STEP})
    assert not ok, rows


@pytest.mark.parametrize("fault,number", [("stereo_bf_scaled", "stereo_differ"),
                                          ("baseline_scaled", "stereo_differ"),
                                          ("stereo_match_moved", "stereo_differ"),
                                          ("state_unchanged", "track_pose_gap"),
                                          ("half_batch", "orb_miss"),
                                          ("answer_altered", "track_assoc_differ")])
def test_a_planted_fault_makes_a_tiny_stereo_run_incorrect(fault, number):
    res = depth_run(TINY_STEREO, "stereo_differ", faults=(fault,))
    assert not res["correct"]
    c = res["checks"][number]
    assert c["value"] is None or c["value"] > 10 * c["limit"], res["checks"]


def test_se3_alignment_sees_a_scale_that_sim3_takes_away():
    """A program whose world is 1.05 times the truth's, as with
    ``baseline_scaled``: the depth sensors' SE(3) readings grow with the
    path's extent, the monocular Sim(3) ones stay at rounding."""
    s = _stream(TINY_STEREO, dict(TINY_TRAFFIC, landmarks=300, bank_s=19.0))
    n = s.warmup_frames + check.TRUTH_FRAMES
    scaled = s.poses[:n].astype(np.float64).copy()
    scaled[:, 4:] *= 1.05
    program = {"frames": list(enumerate(scaled)), "keyframes": list(enumerate(scaled))[::10],
               "points": s.landmarks * 1.05, "point_kf": np.zeros(len(s.landmarks), np.int64)}
    se3 = check.truth_readings(program, s)
    s.sensor = "monocular"
    sim3 = check.truth_readings(program, s)
    def spread(poses):
        c = np.stack([check.centre(p) for p in poses])
        return float(np.sqrt(np.mean(np.sum((c - c.mean(0)) ** 2, axis=1))))

    assert spread(s.poses[:n]) > 0.5
    # the RMS of 5% of each centre's offset from their mean
    assert se3["frame_ate_m"] == pytest.approx(0.05 * spread(s.poses[:n]), rel=0.02)
    assert se3["kf_ate_m"] == pytest.approx(0.05 * spread(s.poses[:n:10]), rel=0.02)
    assert se3["map_point_err_m"] > 0.05
    assert max(sim3.values()) < 1e-6


def test_rgbd_depth_differ_flags_a_lookup_at_the_undistorted_pixel():
    """ORB-SLAM reads the depth at the raw keypoint; a program that reads it
    at the undistorted one reads other pixels under TUM1's radtan."""
    from rumi_slam_tpu_torch.geometry import distortion as prog_distortion
    from rumi_slam_tpu_torch.ops import stereo as prog_stereo

    conf = dict(TINY_RGBD, **TUM1_RADTAN)
    cfg = harness.build_config(conf)
    s = _stream(conf, dict(TINY_TRAFFIC, bank_s=1.0))
    raw = check.reference_features(s.frame(0), cfg.orb, "cpu")
    uv = prog_distortion.undistort_points(s.K, s.dist, raw["uv"])
    depth = s.depth(0).to(torch.float32)
    bf, kw = cfg.camera.bf, dict(depth_factor=5000.0, max_z=cfg.camera.th_depth)
    at_ideal = prog_stereo.depth_from_rgbd(depth, uv, bf, **kw)
    _, z = prog_stereo.depth_from_rgbd(depth, raw["uv"], bf, **kw)
    at_raw = (torch.where(z > 0, uv[:, 0] - bf / torch.clamp_min(z, 1e-6), -1.0), z)
    read = {}
    for name, (ur, z) in (("ideal", at_ideal), ("raw", at_raw)):
        kept = {"uv": uv, "ur": ur, "z": z}
        differ, paired = check.rgbd_rows(kept, raw, raw, s.depth(0), s, cfg.camera, "cpu")
        assert paired > 0.9 * int(raw["valid"].sum())
        read[name] = differ / paired
    assert read["raw"] == 0.0
    assert read["ideal"] > 0.1


def test_a_truth_snapshot_reads_the_map_once_the_stretch_is_adopted():
    """With ``truth_snapshot`` the truth checks read the program's state
    after the frame ``ADOPT_AFTER - 1`` past the checked stretch, not at the
    window's close."""
    from rumi_slam_tpu_torch.system import SlamSystem

    taken = []
    orig = harness.host_state

    def host_state(slam, s):
        out = orig(slam, s)
        taken.append((max(k for k, _ in out["frames"]), out))
        return out

    cell = dict(depth_cell(TINY_STEREO, "stereo_differ"), truth_snapshot=True)
    torch.set_num_threads(2)
    with mock.patch.object(check, "SAMPLE_RANGE", 6), mock.patch.object(check, "TRUTH_FRAMES", 4), \
            mock.patch.object(harness, "host_state", host_state):
        res, _ = harness.execute("tiny", SEED, 8.0, False, device="cpu", cell=cell)
        s = _stream(TINY_STEREO, TINY_TRAFFIC)
        at = s.warmup_frames + 4 + SlamSystem.ADOPT_AFTER - 1
        assert res["window"]["frames"] > at - s.warmup_frames + 1
        assert len(taken) == 1 and taken[0][0] == at
        assert check.truth_readings(taken[0][1], s) == {n: res["readings"][n] for n in TRUTH}
