"""The port's ATE experiment driver (``rumi_slam_tpu_torch/examples/
ate_experiment.py``) against ``examples/ate_experiment.py``: the same
configuration, the same JSON from the same runs (``harness.run_once`` and
``GroundtruthSequence`` replaced in each package by stand-ins that replay
the same canned rows), and ``run_once(warmup=True)``'s scratch pass."""

import dataclasses
import importlib.util
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import rumi_slam_tpu.evaluation.harness as j_harness
import rumi_slam_tpu.io.real_trajectory as j_rt
import rumi_slam_tpu_torch.evaluation.harness as t_harness
import rumi_slam_tpu_torch.io.real_trajectory as t_rt
from rumi_slam_tpu_torch.examples import ate_experiment as t_ate

REPO = Path(__file__).resolve().parent.parent


def _jax_driver():
    spec = importlib.util.spec_from_file_location("_jax_ate_experiment",
                                                  REPO / "examples" / "ate_experiment.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_experiment_config_equals_jax():
    j = dataclasses.asdict(_jax_driver().experiment_config())
    t = dataclasses.asdict(t_ate.experiment_config())
    assert t == j
    assert t_ate.ROW_KEYS == _jax_driver().ROW_KEYS


def canned_row(r):
    """A ``run_once`` row: repeat 1 loses its ATE (inf), repeat 2 merges."""
    return {
        "dataset": "sweep", "ate": math.inf if r == 1 else 0.01 + 0.003 * r,
        "ate_frame": 0.02 + 0.001 * r, "err_p50": 0.005, "err_p90": 0.01 + r, "err_max": 0.03,
        "rate": 0.9 - 0.1 * r, "duration": 3.0, "runtime_s": 12.5 + r,
        "n_kf": 20 + r, "n_loops": 0, "loop_best_score": 0, "loop_verify_inliers": 0,
        "n_reloc": r % 2, "n_loss_events": 1, "n_maps": 1 + r, "n_merges": int(r == 2),
        "upload_mb": 2.5 * r, "upload_mb_raw": 4.0 * r, "n_lost_sampled": r, "n_lost_raw": 2 * r,
        "drops": 3 * r, "n_tracked": 80 - r, "rss_mb": 1000.0,
        "merge_results": [{"result": "merged", "n_cloud_kf": 9, "cloud": None, "back": None,
                           "weld": None, "gba": "dense"}] if r == 2 else [],
    }


class CannedHarness:
    """``run_once`` and ``GroundtruthSequence`` stand-ins recording what the
    driver asks for."""

    def __init__(self):
        self.seqs, self.runs = [], []

    def sequence(self, name, **kw):
        self.seqs.append(dict(kw, name=name))
        return ("seq", kw.get("seed"))

    def run_once(self, seq, cfg, *, seed, enable_rumination, realtime_pace, warmup, **kw):
        self.runs.append(dict(seq=seq, seed=seed, enable_rumination=enable_rumination,
                              realtime_pace=realtime_pace, warmup=warmup, **kw))
        return canned_row(seed)


@pytest.mark.parametrize("flags", [
    ["--repeats", "3", "--gap-starts", "0.8", "1.6", "--gap-len", "0.4"],
    ["--repeats", "1", "--control"],
    ["--repeats", "2", "--repeat-list", "1", "--pace", "1.0", "--gap-starts", "0.5",
     "--no-gba"],
])
def test_main_writes_jax_json(tmp_path, monkeypatch, flags):
    gt = str(tmp_path / "sweep" / "groundtruth.txt")
    jc, tc = CannedHarness(), CannedHarness()
    monkeypatch.setattr(j_harness, "run_once", jc.run_once)
    monkeypatch.setattr(j_rt, "GroundtruthSequence", jc.sequence)
    monkeypatch.setattr(t_harness, "run_once", tc.run_once)
    monkeypatch.setattr(t_rt, "GroundtruthSequence", tc.sequence)
    j_out, t_out = tmp_path / "jax.json", tmp_path / "port.json"
    monkeypatch.setattr(sys, "argv", ["ate_experiment", "--seq", gt, "--out", str(j_out)] + flags)
    _jax_driver().main()
    t_ate.main(["--seq", gt, "--out", str(t_out), "--device", "cpu"] + flags)
    assert json.loads(t_out.read_text()) == json.loads(j_out.read_text())
    for j, t in zip(jc.seqs, tc.seqs):
        assert t.pop("device") == "cpu" and t.pop("gt_root") is None
        assert t == j
    for j, t in zip(jc.runs, tc.runs):
        assert t.pop("device") == "cpu"
        assert t == j
    assert len(tc.runs) == len(jc.runs) > 0


def test_main_defaults_and_refuses_jax_result_names(tmp_path, monkeypatch):
    tc = CannedHarness()
    monkeypatch.setattr(t_harness, "run_once", tc.run_once)
    monkeypatch.setattr(t_rt, "GroundtruthSequence", tc.sequence)
    monkeypatch.chdir(tmp_path)
    t_ate.main(["--repeats", "1", "--control", "--gt-root", "/gt", "--device", "cpu"])
    out = json.loads((tmp_path / "ate_experiment_control_torch.json").read_text())
    assert out["complete"] and out["repeats_done"] == 1
    assert tc.seqs[0]["gt_root"] == "/gt" and tc.seqs[0]["name"] == "rgbd_dataset_freiburg1_floor"
    for name in ("ATE_r05.json", "sub/ATE_r05_control.json"):
        with pytest.raises(SystemExit):
            t_ate.main(["--out", name, "--device", "cpu"])
    assert not (tmp_path / "ATE_r05.json").exists()


def test_run_once_warmup_runs_a_scratch_pass(monkeypatch):
    """``warmup=True`` builds one system more, runs it over the whole
    sequence offline, and the row is the one without warmup (less
    ``runtime_s`` and ``rss_mb``)."""
    import rumi_slam_tpu_torch.system as system_mod
    from rumi_slam_tpu_torch.config import tiny_config
    from rumi_slam_tpu_torch.io.synthetic import SyntheticSequence

    torch.set_num_threads(1)
    made = []
    base = system_mod.SlamSystem

    class Counted(base):
        def track_monocular(self, img, t):
            if not made or made[-1][0] is not self:
                made.append([self, 0])
            made[-1][1] += 1
            return super().track_monocular(img, t)

    monkeypatch.setattr(system_mod, "SlamSystem", Counted)
    seq = SyntheticSequence(n_frames=12, width=320, height=240, n_points=1500, seed=4, patch=3)
    cfg = tiny_config()
    plain = t_harness.run_once(seq, cfg, seed=3, enable_rumination=False, device="cpu")
    n_plain = len(made)
    warm = t_harness.run_once(seq, cfg, seed=3, enable_rumination=False, warmup=True,
                              device="cpu")
    assert n_plain == 1 and [n for _, n in made[1:]] == [12, 12]
    for k in set(plain) - {"runtime_s", "rss_mb"}:
        a, b = plain[k], warm[k]
        assert a == b or (isinstance(a, float) and np.isnan(a) and np.isnan(b)), k
    assert plain["n_kf"] >= 2 and plain["n_tracked"] > 6
