"""The port's experiment harness (``evaluation/harness.py``) and
``ops/orb.descriptors_at`` against the JAX package's.

``run_once`` runs ``tests/torch_harness_drive.py --tiny`` in the port (30
frames of a ``GroundtruthSequence`` at ``tiny_config()``, rumination on) and
holds the row to the JAX package's row of the same drive, recorded in
``tests/torch_harness_floor.json`` (JAX's side takes about a minute on the
CPU); ``--tiny --lost`` (60 frames, a loss, a merge) holds the rumination
columns the same way, and a canned coordinator history fed to both packages'
``run_once`` holds the row's assembly exactly.  The two packages draw RANSAC
hypotheses from different generators, so
the row is held to the tolerances of ``tests/test_torch_system.py``: the same
lost and new-map timestamps and maps, keyframes within 1, the OK share within
one frame, ATE within 2e-2 m.  ``write_result_csv`` writes the same bytes in
both packages, and ``repeat_experiment`` the same aggregate file given the
same rows; ``summarize`` gives the same summary.  ``descriptors_at``: the
same bits on every row whose orientation falls in the same rotation bin,
orientations within 5e-5 rad modulo 2 pi (``tests/test_torch_orb.py``'s
bound) on at least 99% of rows (the pixels are drawn at random, and a patch
of flat background has no orientation)."""

import csv
import json
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rumi_slam_tpu.evaluation import harness as jh
from rumi_slam_tpu.ops import orb as jorb
from rumi_slam_tpu_torch.config import tiny_config
from rumi_slam_tpu_torch.evaluation import harness as th
from rumi_slam_tpu_torch.io.synthetic import SyntheticSequence
from rumi_slam_tpu_torch.ops import orb as torb

import torch_harness_drive as drive

torch.set_num_threads(1)
FLOOR = json.loads(drive.FLOOR.read_text())


def test_result_columns_equal():
    assert th.RESULT_COLUMNS == jh.RESULT_COLUMNS


@pytest.fixture(scope="module")
def tiny_row():
    return drive.run("rumi_slam_tpu_torch", tiny=True)


def test_run_once_against_jax_row(tiny_row):
    j, t = FLOOR["tiny"], tiny_row
    assert t["frames"] == j["frames"]
    for k in ("lost_timestamp", "new_map_timestamp", "n_maps", "n_merges", "n_loss_events",
              "drops"):
        assert t[k] == j[k], k
    assert abs(t["n_kf"] - j["n_kf"]) <= 1
    assert abs(t["n_tracked"] - j["n_tracked"]) <= 1
    assert abs(t["ate"] - j["ate"]) <= 2e-2 and t["ate"] < 0.05
    assert abs(t["rate"] - j["rate"]) <= 1.0 / t["frames"] + 1e-9
    assert t["rss_mb"] > 0 and t["runtime_s"] > 0


# one coordinator history, handed to both packages' ``run_once``: a bundle too
# small (left out of ``merge_results``), a failed backend, then two merges (the
# first one fills the merge columns)
CANNED_HISTORY = {
    3: {"result": "bundle_too_small", "upload_mb": 0.0, "upload_mb_raw": 0.0},
    5: {"result": "backend_failed", "upload_mb": 3.125, "upload_mb_raw": 9.5,
        "n_lost_sampled": 4, "n_lost_raw": 7},
    8: {"result": "merged", "n_cloud_kf": 17, "bundle_size": 23, "backend_weld": {"tries": 2},
        "gba": "dense", "upload_mb": 19.6608, "upload_mb_raw": 41.25, "n_lost_sampled": 6,
        "n_lost_raw": 9,
        "cloud_merge": {"n_kf_matches": 9, "n_pt_pairs": 902, "inlier_ratio": 0.957912,
                        "retried": False, "scale": 1.3},
        "back_merge": {"n_kf_matches": 5, "n_pt_pairs": 194, "inlier_ratio": 0.185567,
                       "reason": None}},
    10: {"result": "merged", "n_cloud_kf": 4, "bundle_size": 11, "backend_weld": None,
         "gba": "local", "upload_mb": 1.5,
         "cloud_merge": {"n_kf_matches": 2, "n_pt_pairs": 40, "inlier_ratio": 0.5},
         "back_merge": {"n_kf_matches": 1, "n_pt_pairs": 12, "inlier_ratio": 0.25,
                        "reason": "few pairs", "retried": True}},
}
CANNED_STATES = "NOOORRNNOOOO"


def _canned_run(package_mod, system_mod, coord_mod, monkeypatch, **kw):
    """``run_once`` of one package with its ``SlamSystem`` and
    ``RuminationCoordinator`` replaced by stand-ins that replay
    ``CANNED_STATES`` and ``CANNED_HISTORY``: only the row's assembly runs."""
    n = len(CANNED_STATES)
    times = np.arange(n) / 30.0
    rng = np.random.default_rng(8)
    q = rng.normal(size=(n, 4)) * [0.05, 0.05, 0.05, 1.0]
    gt = np.concatenate([q / np.linalg.norm(q, axis=1, keepdims=True),
                         np.cumsum(rng.normal(size=(n, 3)) * 0.05, 0)], 1).astype(np.float32)
    est = gt.copy()
    est[:, 4:] = 1.7 * gt[:, 4:] + rng.normal(size=(n, 3)) * 0.01

    class Seq:
        name = "canned"

        def __init__(self):
            self.times, self.poses_gt = times, list(gt)

        def __len__(self):
            return n

        def frame(self, i):
            return np.zeros((4, 4), np.float32), float(times[i])

    class Slam:
        def __init__(self, config, device=None):
            self.device = torch.device("cpu")
            self.trajectory = []
            self.stats = {"n_kf": 9, "n_new_maps": 1, "n_reloc": 2, "n_loss_events": 1,
                          "n_loops": 0}
            self.ms = types.SimpleNamespace(pt_valid=np.arange(50) % 3 == 0, n_maps=2)

        def track_monocular(self, img, t):
            i = len(self.trajectory)
            self.trajectory.append((t, None, None, {"N": "NOT_INITIALIZED", "O": "OK",
                                                    "R": "RECENTLY_LOST"}[CANNED_STATES[i]]))

        def keyframe_trajectory(self):
            keep = np.arange(1, n, 2)
            return times[keep], est[keep]

        def trajectory_of_map(self):
            return times[1:], est[1:]

    class Coord:
        def __init__(self, slam, config, **kw):
            self.slam, self.history = slam, []

        def maybe_ruminate(self):
            row = CANNED_HISTORY.get(len(self.slam.trajectory) - 1)
            if row is not None:
                self.history.append(dict(row))

    monkeypatch.setattr(system_mod, "SlamSystem", Slam)
    monkeypatch.setattr(coord_mod, "RuminationCoordinator", Coord)
    return package_mod.run_once(Seq(), None, **kw)


def test_run_once_row_from_same_history(monkeypatch):
    """The rumination columns (``front_cloud_match_num``,
    ``back_cloud_match_num``, ``new_map_timestamp``, ``merge_inlier_ratio``,
    ``bundle_frames``, ``upload_mb``, ``merge_results`` ...) assembled from the
    same coordinator history and frame states: every column equal to JAX's,
    the ATE columns within 1e-5 relative (float32 alignment in two
    libraries)."""
    import rumi_slam_tpu.rumination.coordinator as jcoord
    import rumi_slam_tpu.system as jsys
    import rumi_slam_tpu_torch.rumination.coordinator as tcoord
    import rumi_slam_tpu_torch.system as tsys

    j = _canned_run(jh, jsys, jcoord, monkeypatch)
    t = _canned_run(th, tsys, tcoord, monkeypatch, device="cpu")
    assert set(t) == set(j)
    assert t["n_merges"] == 2 and t["front_cloud_match_num"] == 902
    assert t["lost_timestamp"] == 4 / 30.0 and t["new_map_timestamp"] == 5 / 30.0
    assert [r["result"] for r in t["merge_results"]] == ["backend_failed", "merged", "merged"]
    for k in j:
        if k in ("runtime_s", "rss_mb"):
            continue
        if k in ("ate", "ate_frame", "err_p50", "err_p90", "err_max"):
            assert t[k] == pytest.approx(j[k], rel=1e-5), k
        else:
            assert t[k] == j[k], k


def test_run_once_with_loss_against_jax_row():
    """``tests/torch_harness_drive.py --tiny --lost`` in the port: frames
    24-29 degraded, the system loses track, opens a new submap, and the
    coordinator's own backend builds the back submap and merges.  Held to
    JAX's row of the same drive: the same maps, merges, loss events and
    attempt outcomes, the same keyframe matches in both merges and the same
    bundle; keyframes and frames tracked within 1, the cloud merge's point
    pairs within 5% and its inlier ratio within 0.05, the completion rate no
    more than 0.1 below JAX's, and the keyframe ATE within the JAX
    rumination test's own bound, 0.3 m.  The back merge is bimodal in both
    packages (inlier ratios 0.09-0.93 over seeds), so only its keyframe
    matches are held."""
    j, t = FLOOR["tiny_lost"], drive.run("rumi_slam_tpu_torch", tiny=True, lost=True)
    assert t["frames"] == j["frames"]
    for k in ("lost_timestamp", "new_map_timestamp", "n_maps", "n_merges", "n_loss_events",
              "drops", "bundle_frames"):
        assert t[k] == j[k], k
    assert j["n_merges"] == 1
    assert abs(t["n_kf"] - j["n_kf"]) <= 1
    assert abs(t["n_tracked"] - j["n_tracked"]) <= 1
    assert abs(t["front_cloud_match_num"] - j["front_cloud_match_num"]) <= (
        0.05 * j["front_cloud_match_num"])
    assert abs(t["merge_inlier_ratio"] - j["merge_inlier_ratio"]) <= 0.05
    assert t["back_cloud_match_num"] > 0
    assert t["upload_mb"] == pytest.approx(j["upload_mb"], rel=1e-6)
    assert t["upload_mb_raw"] == pytest.approx(j["upload_mb_raw"], rel=1e-6)
    assert [(r["result"], r["gba"], r["weld"]) for r in t["merge_results"]] == [
        (r["result"], r["gba"], r["weld"]) for r in j["merge_results"]]
    for side in ("cloud", "back"):
        assert [r[side]["n_kf_matches"] for r in t["merge_results"]] == [
            r[side]["n_kf_matches"] for r in j["merge_results"]], side
    assert t["rate"] >= j["rate"] - 0.1
    assert t["ate"] <= 0.3
    assert t["rss_mb"] > 0 and t["runtime_s"] > 0


def test_write_result_csv_same_bytes(tmp_path):
    row = {"dataset": "fr1_floor", "ate": 0.0123456789, "ate_frame": float("inf"),
           "rate": 0.5, "n_kf": 21, "n_maps": np.int64(2), "upload_mb": 19.6608,
           "drops": 0, "rss_mb": 1905.95072, "unlisted": "ignored"}
    th.write_result_csv(row, tmp_path / "t" / "result.csv")
    jh.write_result_csv(row, tmp_path / "j" / "result.csv")
    assert (tmp_path / "t" / "result.csv").read_bytes() == (tmp_path / "j" / "result.csv").read_bytes()


def test_repeat_experiment_and_summarize(tmp_path, monkeypatch):
    """Two real repeats in the port; JAX's aggregation of the same rows
    (its ``run_once`` replaced by the port's rows) writes the same files."""
    def seq(r):
        return SyntheticSequence(n_frames=8, width=320, height=240, n_points=1500, seed=4 + r,
                                 patch=3)

    rows = th.repeat_experiment(seq, tiny_config(), repeats=2, out_dir=tmp_path / "t",
                                enable_rumination=False, device="cpu")
    assert [r["repeat"] for r in rows] == [0, 1]
    with open(tmp_path / "t" / "experiment_results.csv") as f:
        assert csv.DictReader(f).fieldnames == ["repeat"] + th.RESULT_COLUMNS
    given = iter([{k: v for k, v in r.items() if k != "repeat"} for r in rows])
    monkeypatch.setattr(jh, "run_once", lambda *a, **k: dict(next(given)))
    jrows = jh.repeat_experiment(lambda r: None, None, repeats=2, out_dir=tmp_path / "j")
    for name in ("experiment_results.csv", "run_000/result.csv", "run_001/result.csv"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes(), name
    assert th.summarize(rows) == jh.summarize(jrows)
    assert th.summarize([{"ate": float("inf"), "rate": 0.0}])["n_finite"] == 0


def test_descriptors_at_as_jax():
    img = SyntheticSequence(n_frames=1, width=320, height=240, n_points=1500, seed=4,
                            patch=3).frame(0)[0]
    rng = np.random.default_rng(6)
    uv = np.concatenate([
        rng.uniform([0, 0], [320, 240], (200, 2)),
        [[0.0, 0.0], [319.0, 239.0], [10.5, 20.5], [11.5, 21.5], [-3.0, 250.0]],
    ]).astype(np.float32)
    valid = rng.random(len(uv)) > 0.1
    dj, aj = jorb.descriptors_at(jnp.asarray(img.numpy()), jnp.asarray(uv), jnp.asarray(valid))
    dt, at = torb.descriptors_at(img, torch.from_numpy(uv), torch.from_numpy(valid))
    dj, aj = np.asarray(dj), np.asarray(aj)
    assert dt.dtype == torch.int32 and dt.shape == (len(uv), 8)
    # angles on the atan2 branch cut come out as pi in one package and -pi in
    # the other; a patch of flat background has moments near 0, whose angle is
    # rounding noise in both
    gap = np.angle(np.exp(1j * (at.numpy().astype(np.float64) - aj)))
    assert (np.abs(gap) <= 5e-5).mean() >= 0.99
    to_bin = lambda x: np.mod(np.round(x * (30 / (2 * np.pi))).astype(np.int32), 30)
    same_bin = to_bin(at.numpy()) == to_bin(aj)
    assert same_bin.mean() >= 0.99
    np.testing.assert_array_equal(dt.numpy().view(np.uint32)[same_bin], dj[same_bin])
    assert not dt[~torch.from_numpy(valid)].any() and not at[~torch.from_numpy(valid)].any()


def test_descriptors_at_matches_extraction():
    """``tests/test_loop_closing_system.py``'s contract on the port: at the
    extractor's own level-0 keypoints ``descriptors_at`` gives the extractor's
    descriptors (median Hamming distance at most 8) and angles (median gap
    below 0.1 rad)."""
    img = SyntheticSequence(n_frames=1, width=320, height=240, n_points=1200, seed=3,
                            patch=3).frame(0)[0]
    feats = torb.ORBExtractor(n_features=256, n_levels=1)(img)
    desc, ang = torb.descriptors_at(img, feats.uv, feats.valid)
    sel = feats.valid.numpy()
    d1 = feats.desc.numpy().view(np.uint32)[sel]
    d2 = desc.numpy().view(np.uint32)[sel]
    ham = np.unpackbits((d1 ^ d2).view(np.uint8), axis=-1).sum(-1)
    assert sel.sum() > 100 and np.median(ham) <= 8
    assert np.median(np.abs(feats.angle.numpy()[sel] - ang.numpy()[sel])) < 0.1
