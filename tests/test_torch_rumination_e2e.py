"""The port's rumination end to end on the CPU: loss -> back submap -> double
merge, on the scenario of ``tests/test_rumination_e2e.py`` (110-frame sweep,
seed 11, frames 45..50 featureless, ``tiny_config()`` with
``reloc_window_s=0.1``), driven by ``tests/torch_rumination_drive.py``.

Both outcomes of the JAX package are held:

* with the clear-view backend (every bundle image swapped for the clean
  rendering at its timestamp before the package's own ``build()`` runs) the
  rumination merges;
* with the package's own backend it fails, because the synthetic loss renders
  a flat image that no backend can see through.

The JAX side costs 2-4 minutes a run and is not run here.  Its output on the
same two drives, at the frame counts used here, is
``tests/torch_rumination_floor.json``, written from

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_rumination_drive.py --frames 80
    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_rumination_drive.py --own-backend

and the tests read their expectations from it: the states up to the new
submap, the bundle numbers, the keyframe matches of both merges, the point
pairs of the cloud merge (within 10), the backend's own states.  Clear view, 80 frames: ``merged``, ``gba``
dense, one map of 36 keyframes, keyframe ATE 0.2289 m.  The bound on the ATE is
the JAX test's own, 0.3 m.

The drive renders the scene with the configuration's intrinsics (fx 260), as
the full-width drive on the card does, and the JAX package then records 7 lost
frames (``RRRNNNN``).  ``tests/test_rumination_e2e.py`` renders it with the
sequence's default intrinsics (fx 256) while the system is told 260; there the
JAX package needs one frame more to start the new submap and records 8
(``--default-k`` reproduces it: cloud merge 10 / 425, back merge 5 / 112).
"""

import json
import os

import torch

from torch_rumination_drive import LOST_SPAN, N_FRAMES, run

torch.set_num_threads(1)

FPS = 30.0
CLEAR_VIEW_FRAMES = 80
with open(os.path.join(os.path.dirname(__file__), "torch_rumination_floor.json")) as _f:
    JAX = json.load(_f)


def prefix(states):
    """The states up to the frame that starts the new submap."""
    first_lost = states.index("R")
    return states[:states.index("O", first_lost)]


def check_scenario(out, jax):
    for k in ("seed", "frames", "lost_span", "config_k", "n_new_track_first", "own_backend",
              "full"):
        assert out[k] == jax[k], k
    assert prefix(jax["states"]) == "N" + "O" * 44 + "RRR" + "NNNN"
    assert out["states"].startswith(prefix(jax["states"]) + "O"), out["states"]
    row, jrow = out["history"][0], jax["history"][0]
    for k in ("front", "back", "n_lost_raw", "n_lost_sampled", "bundle_size", "upload_mb",
              "upload_mb_raw", "result"):
        assert row[k] == jrow[k], (k, row, jrow)
    assert row["n_lost_raw"] == 7 and row["bundle_size"] == 20


def test_rumination_end_to_end_clear_view_backend():
    jax = JAX["clear_view"]
    assert jax["frames"] == CLEAR_VIEW_FRAMES
    out = run("rumi_slam_tpu_torch", device="cpu", frames=CLEAR_VIEW_FRAMES)
    check_scenario(out, jax)
    assert out["stats"]["n_new_maps"] == jax["stats"]["n_new_maps"] == 1
    assert out["stats"]["n_loss_events"] >= 1
    assert len(out["history"]) == len(jax["history"]) == 1, out["history"]
    row, jrow = out["history"][0], jax["history"][0]
    assert row["result"] == "merged" and row["gba"] == jrow["gba"] == "dense", row
    assert abs(row["n_cloud_kf"] - jrow["n_cloud_kf"]) <= 2 and row["n_cloud_kf"] >= 10
    for merge in ("cloud_merge", "back_merge"):
        assert row[merge]["n_kf_matches"] == jrow[merge]["n_kf_matches"], merge
    # point pairs of the cloud merge: JAX 289; the port 289-291, by thread count
    assert abs(row["cloud_merge"]["n_pt_pairs"] - jrow["cloud_merge"]["n_pt_pairs"]) <= 10
    # one map left, holding every keyframe; JAX has 36 there
    assert sum(out["kf_per_map"][1:]) == sum(jax["kf_per_map"][1:]) == 0, out["kf_per_map"]
    assert abs(out["kf_per_map"][0] - jax["kf_per_map"][0]) <= 4, out["kf_per_map"]
    # the merged keyframe trajectory spans both sides of the gap
    assert out["kf_span"][0] < 40 / FPS and out["kf_span"][1] > 60 / FPS
    assert jax["kf_ate"] < 0.3 and out["kf_ate"] < 0.3, out["kf_ate"]
    assert out["backend_states"] == jax["backend_states"]
    assert out["backend_states"][0].count("O") >= 16
    # loop closing ran its detection in the live system's mapping rounds
    assert "loop_best_score" in out["stats"] and "loop_best_score" in jax["stats"]


def test_rumination_own_backend_fails_as_in_jax():
    jax = JAX["own_backend"]
    out = run("rumi_slam_tpu_torch", device="cpu", own_backend=True)
    check_scenario(out, jax)
    assert len(out["history"]) == 1
    assert out["history"][0]["result"] == "backend_failed", out["history"]
    assert out["states"] == jax["states"]
    assert out["backend_states"] == jax["backend_states"] == ["NOOOOOOOOORRRRRRRRNN"]
    assert out["kf_per_map"] == jax["kf_per_map"] == [11, 6]
    assert LOST_SPAN == (45, 51) and N_FRAMES == 110
