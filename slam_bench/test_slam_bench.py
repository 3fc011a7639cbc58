"""Tests of the benchmark itself, on the CPU at a tiny size, and one on the
card (marker ``cuda``):

    python -m pytest -q slam_bench/test_slam_bench.py

The tiny runs drive ``harness.execute`` with ``device="cpu"`` (the
command itself refuses a host without a card) on a 320x240 camera at 10 fps.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from slam_bench import check, harness, roofline, stream

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

TINY_CONFIG = {
    "Camera.fx": 260.0, "Camera.fy": 260.0, "Camera.cx": 159.5, "Camera.cy": 119.5,
    "Camera.k1": -0.28340811, "Camera.k2": 0.07395907, "Camera.p1": 0.00019359,
    "Camera.p2": 1.76187114e-05,
    "Camera.width": 320, "Camera.height": 240, "Camera.fps": 10.0,
    "ORBextractor.nFeatures": 256, "ORBextractor.scaleFactor": 1.2, "ORBextractor.nLevels": 3,
    "ORBextractor.iniThFAST": 20, "ORBextractor.minThFAST": 7,
    "deterministic_algorithms": True,
    "assumed": {"mapping": {"max_kf": 64, "max_pt": 4096}}}
TINY_TRAFFIC = {"landmarks": 1500, "world_seed": 0, "path": {"amp": [0.8, 0.2, 0.25], "yaw_amp": 0.11},
                "bank_s": 6.0, "loop_from_s": 0.0, "warmup_s": 2.0, "patch": 3}
STEP = ("orb_miss", "track_assoc_differ", "track_pose_gap")
TRUTH = ("frame_ate_m", "kf_ate_m", "map_point_err_m")
SEED = 3141592653589


def tiny_cell():
    """The tiny cell: the step checks at the limits of ``euroc-mono-det.sweep``;
    the truth checks at limits of its own, from two CPU runs each of the
    sound tiny run (frame / keyframe ATE 0.0371-0.0399 / 0.0238-0.0258 m,
    point error 0.369-0.371 m) and of the local BA left unchanged
    (0.0723-0.0726 / 0.0838 / 8.71)."""
    lim = harness.load("cells", "euroc-mono-det.sweep")["limits"]
    limits = {n: lim[n] for n in STEP}
    limits.update(frame_ate_m=0.055, kf_ate_m=0.05, map_point_err_m=2.0)
    return {"config_params": TINY_CONFIG, "traffic_params": TINY_TRAFFIC, "chips": 1,
            "limits": limits}


def tiny_run(faults=(), trace=False, control=False, seconds=6.0):
    """A tiny run on the CPU; its sampled frames lie among the window's
    first 6, which a slow host reaches."""
    torch.set_num_threads(2)
    with mock.patch.object(check, "SAMPLE_RANGE", 6):
        res, _ = harness.execute("tiny", SEED, seconds, trace, device="cpu", cell=tiny_cell(),
                                 faults=faults, control=control)
    return res


# ---------------------------------------------------------------------------
# BENCHMARK.json resolves, by name, to the files under slam_bench/
# ---------------------------------------------------------------------------

def test_benchmark_entries_resolve_to_their_files():
    assert BENCH["command"] == ["python3", "-m", "slam_bench.run"]
    assert BENCH["paths"] == ["slam_bench"]
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert c["file"] == f"slam_bench/configs/{c['name']}.json"
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert NAME.match(key) and key in body
        harness.build_config(body)
    used = set()
    for w in BENCH["workloads"]:
        cell = harness.load("cells", w["name"])
        assert (cell["config"], cell["traffic"], cell["chips"]) == (w["config"], w["traffic"],
                                                                    w["chips"])
        assert w["config"] in configs and w["chips"] == 1
        stream.load_traffic(w["traffic"])
        sensor = harness.sensor_of(harness.load("configs", w["config"]))
        extra = {"monocular": set(), "stereo": {"stereo_differ"}, "rgbd": {"rgbd_depth_differ"}}
        assert set(cell["limits"]) == set(STEP) | set(TRUTH) | extra[sensor]
        used.add(w["config"])
        assert len(w["why"]) <= 200
    assert used == set(configs)
    for m in BENCH["end_to_end"]:
        assert callable(harness.reader("end_to_end", m["name"]).read)
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["per_layer"]:
        mod = harness.reader("metrics", m["name"])
        assert callable(mod.read)
        assert (mod.LAYER, mod.MOVES) == (m["layer"], m["moves"])
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    names = [x["name"] for x in BENCH["configs"] + BENCH["workloads"]
             + BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_every_cell_reports_a_metric_of_each_kind():
    for w in BENCH["workloads"]:
        e2e, layer = harness.cell_metrics(BENCH, w["name"])
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        for m in BENCH["per_layer"]:
            if m["name"] in layer:
                assert m["moves"] in e2e


# ---------------------------------------------------------------------------
# the generator
# ---------------------------------------------------------------------------

class _Cam:
    fx, fy, cx, cy, width, height, fps = 80.0, 80.0, 39.5, 29.5, 80, 60, 10.0


def test_generator_same_seed_same_bank_and_truth():
    traffic = dict(TINY_TRAFFIC, landmarks=300, bank_s=1.0)
    a = stream.Stream(traffic, _Cam, SEED, "cpu")
    b = stream.Stream(traffic, _Cam, SEED, "cpu")
    c = stream.Stream(traffic, _Cam, SEED + 1, "cpu")
    assert torch.equal(a.bank, b.bank) and np.array_equal(a.poses, b.poses)
    # another seed: the same scene (landmarks), another path jitter, so other pixels
    assert np.array_equal(a.landmarks, c.landmarks)
    assert not torch.equal(a.bank, c.bank) and not np.array_equal(a.poses, c.poses)
    assert a.bank.dtype == torch.uint8 and a.bank.shape == (10, 60, 80)
    # the stream plays the bank forwards, then back and forth, timestamps rising
    assert [a.bank_index(k) for k in range(8, 22)] == [8, 9, 8, 7, 6, 5, 4, 3, 2, 1, 0, 1,
                                                        2, 3]
    assert torch.equal(a.frame(12), a.bank[6]) and a.time(12) == 1.2
    assert np.array_equal(a.pose(12), a.poses[6])


# ---------------------------------------------------------------------------
# the copied roofline arithmetic
# ---------------------------------------------------------------------------

def test_bound_ms_equals_chip_smokes_on_its_phase_3_shapes():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    from rumi_slam_tpu_torch.ops import matcher

    assert roofline.bound_ms(1e9, 2e8, 3e6) == chip_smoke.bound_ms(1e9, 2e8, 3e6)
    for F, P, n_valid, kw in ((2048, 16384, 2048, {}), (1024, 16384, 2048, {}),
                              (1000, 5000, 4500, {}),
                              (1024, 16384, 16384, dict(cluster_px=160.0))):
        _, _, uv_q, uv_p, vq, vp = chip_smoke.matcher_problem(
            F, P, n_valid, seed=F + P + len(kw), device="cpu", **kw)
        n_pairs = int(vq.sum()) * int(vp.sum())
        n_pass = int((matcher.radius_mask(uv_q, uv_p, 15.0) & vq[:, None] & vp[None, :]).sum())
        want = chip_smoke.bound_ms(6 * n_pairs, 8 * n_pass, 41 * (F + P) + 8 * F)[0]
        assert roofline.fused_match_bound_ms(uv_q, uv_p, 15.0, vq, vp) == want


# ---------------------------------------------------------------------------
# what the command may load, and where it refuses to run
# ---------------------------------------------------------------------------

def test_a_run_loads_no_jax_and_no_jax_package():
    code = ("import sys, torch\n"
            "from slam_bench import harness, control, test_slam_bench as t\n"
            "t.tiny_run(trace=True, seconds=2.0)\n"
            "print('FORBIDDEN', harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr[-3000:]
    # whole top-level names: the port, rumi_slam_tpu_torch, was loaded and is not flagged
    assert "FORBIDDEN []" in out.stdout


def _command(cwd, env=None):
    return subprocess.run([sys.executable, "-m", "slam_bench.run", "--workload",
                           "euroc-mono-det.sweep", "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, **(env or {})))


def _no_result(out):
    return out.returncode != 0 and not any(ln.strip().startswith("{")
                                           for ln in out.stdout.splitlines())


def test_without_a_card_the_command_fails_and_prints_no_result():
    assert _no_result(_command(ROOT, {"CUDA_VISIBLE_DEVICES": ""}))


def test_with_only_the_benchmark_the_command_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "slam_bench", tmp_path / "slam_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    assert _no_result(_command(tmp_path))


# ---------------------------------------------------------------------------
# correct: a sound run passes, the control and planted faults fail
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sound():
    return tiny_run(control=True)


def test_sound_tiny_run_is_correct(sound):
    assert sound["correct"], sound["checks"]
    assert set(sound["checks"]) == set(STEP) | set(TRUTH)
    # the configuration's deterministic algorithms hold for the run only
    assert not torch.are_deterministic_algorithms_enabled()
    assert all(sound["checks"][n]["value"] == 0.0 for n in ("orb_miss", "track_assoc_differ"))


def test_control_in_bfloat16_fails(sound):
    ok, rows = check.verdict(sound["control"], {n: tiny_cell()["limits"][n] for n in STEP})
    assert not ok, rows


@pytest.mark.parametrize("fault,number", [("state_unchanged", "track_pose_gap"),
                                          ("half_batch", "orb_miss"),
                                          ("answer_altered", "track_assoc_differ"),
                                          ("mapping_unchanged", "map_point_err_m")])
def test_a_planted_fault_makes_the_run_incorrect(fault, number):
    res = tiny_run(faults=(fault,))
    assert not res["correct"]
    c = res["checks"][number]
    assert c["value"] is None or c["value"] > c["limit"], res["checks"]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_a_cell_runs_correct_on_the_card(card):
    out = subprocess.run([sys.executable, "-m", "slam_bench.run", "--workload",
                          "euroc-mono-det.sweep", "--seed", "2718281828459", "--seconds", "8",
                          "--trace", "1"], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu", res
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
