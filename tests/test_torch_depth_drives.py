"""Drive-level parity of the port's depth modes with the JAX package:
``SlamSystem.track_rgbd`` and ``track_stereo`` over 25 frames of the JAX
depth test's 320x240 scene (seed 5, 1500 points, patch 3, rendered with the
configuration's intrinsics) at ``tiny_config()`` with an 8 cm baseline, and
RGB-D again with frames 15-20 featureless and ``reloc_window_s=0.1``: the
system loses track on frame 15, gives the map up on 19, opens submap 1 and
initialises it from depth on frame 21, the first textured frame.  Each drive
runs in both packages (``tests/torch_system_drive.py::drive``; the port with
the JAX facade's RANSAC draws, though no depth drive here draws).

Depth initialisation needs no RANSAC, so the drives are held to: the same
state on every frame, keyframes on the same frames (and submaps), and
keyframe poses within KF_POSE_ATOL.  What is not exact: the port's ORB
differs from JAX's in a row or two of 256 a frame, and with identical
features (JAX's injected) motion-only BA still lands up to 3e-4 apart on a
frame where an observation sits at the chi2 gate; a keyframe's new depth
points then differ by one, and the difference carries.  Measured: keyframe
poses within 3.3e-3 (RGB-D), 6.8e-3 (stereo) and 8.9e-4 (RGB-D with the
loss); frame-trajectory ATE 0.00882 / 0.00872 m, 0.01560 / 0.01515 m and
0.00656 / 0.00653 m (port / JAX).  KF_POSE_ATOL is 3x the largest gap,
ATE_ATOL 10x.  Both packages must also meet the JAX depth test's own bounds:
metric scale (unscaled ATE under 0.05 m for RGB-D, 0.12 m for stereo, and
under the larger of that and twice the scaled ATE).
"""

import numpy as np
import pytest
import torch

from torch_system_drive import drive, jax_draw_stream

torch.set_num_threads(1)

N_FRAMES = 25
LOST_SPAN = (15, 21)
KF_POSE_ATOL = 2e-2
ATE_ATOL = 5e-3
CASES = {"rgbd": dict(mode="rgbd"), "stereo": dict(mode="stereo"),
         "rgbd_loss": dict(mode="rgbd", lost_span=LOST_SPAN, reloc_window_s=0.1)}
_DRIVES = {}


@pytest.fixture(params=list(CASES))
def drives(request):
    """(JAX summary, port summary) of one case, driven once per module."""
    name = request.param
    if name not in _DRIVES:
        kw = dict(n_frames=N_FRAMES, tiny=True, **CASES[name])
        jax_run = drive(False, **kw)[0]
        port_run = drive(True, next_draw=jax_draw_stream(), **kw)[0]
        _DRIVES[name] = (name, jax_run, port_run)
    return _DRIVES[name]


def test_same_states_and_keyframes(drives):
    name, j, t = drives
    assert t["states"] == j["states"]
    assert t["kf_time"] == j["kf_time"] and t["kf_map"] == j["kf_map"]
    assert t["n_kf"] == j["n_kf"] and t["stats"]["n_new_maps"] == j["stats"]["n_new_maps"]
    if name == "rgbd_loss":
        s = t["states"]
        assert s[14] == "OK" and s[15:19] == ["RECENTLY_LOST"] * 4
        assert t["new_map_frames"] == [19] and s[19:21] == ["NOT_INITIALIZED"] * 2
        assert s[21:] == ["OK"] * 4 and t["kf_map"][-1] == 1
    else:
        assert t["states"] == ["OK"] * N_FRAMES      # initialised on the first frame


def test_keyframe_poses_and_ate(drives):
    name, j, t = drives
    np.testing.assert_allclose(np.asarray(t["kf_pose"]), np.asarray(j["kf_pose"]),
                               atol=KF_POSE_ATOL, rtol=0)
    assert abs(t["ate"] - j["ate"]) < ATE_ATOL
    assert abs(t["ate_unscaled"] - j["ate_unscaled"]) < ATE_ATOL
    tol = 0.12 if name == "stereo" else 0.05
    for r in (j, t):
        assert r["ate_unscaled"] < tol and r["ate_unscaled"] < max(2.0 * r["ate"], tol)
