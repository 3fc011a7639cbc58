"""Facade parity: ``SlamSystem.track_monocular`` over a synthetic sequence in
the JAX package and in the port, on the CPU.

The port's RANSAC draws come from the JAX facade's own key stream
(``PRNGKey(0)``, split at the same calls), so both packages score the same
hypotheses.  Both run ``tiny_config()`` with loop closing off (the port has
none yet) and synchronous mapping.

With the draws alone, what is exact is the state sequence, frame by frame.
What is not, and why: the two-view initialisation scores 256 eight-point
hypotheses, each the null vector of a rank-8 9x9 matrix from a float32
``eigh``; the JAX package's LAPACK and torch's return vectors that differ in
the last digits, which moves a few Sampson errors across the inlier gate,
and another of the many hypotheses tied at the top score wins.  The initial
map then differs slightly (tests/test_torch_optim.py holds ``two_view_init``
itself on a well-conditioned problem), and a keyframe decision near its
threshold can fall on the next frame.  Measured on the verify drive: 15
keyframes in the JAX package, 16 in the port; keyframe poses at shared
timestamps within 0.0193 of each other (0.0016 RMSE after a Sim3 alignment
of the centres); frame-trajectory ATE 0.0233 m against 0.0163 m.  On the
lost-span drive: 11 keyframes in both, 0.0118 and 0.0023, ATE 0.0179 m
against 0.0153 m.  On the relocalisation drive (two featureless frames, then
map-level recovery in both): ATE 0.0178 m against 0.0183 m.  The ``*_ATOL``
bounds below are 2-4x those gaps.

With the JAX package's two-view result handed to the port as well (the one
step whose float32 eigen solve differs), the rest of the facade -- tracking,
keyframe decisions, mapping rounds, local BA -- reproduces the JAX run: the
same states, keyframes on the same frames, the same counts of new and fused
points.  The keyframe poses then differ only by float32 rounding carried
through the drive: measured within 1.3e-4 of each other, ATE 0.023314 m
against 0.023286 m.  The ``EXACT_*`` bounds are 4-7x those gaps.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rumi_slam_tpu.config import tiny_config as jax_tiny_config
from rumi_slam_tpu.evaluation import ate as jate
from rumi_slam_tpu.io.synthetic import SyntheticSequence as JaxSequence
from rumi_slam_tpu.optim import two_view as jtv
from rumi_slam_tpu.system import SlamSystem as JaxSlam
from rumi_slam_tpu_torch.config import tiny_config
from rumi_slam_tpu_torch.evaluation import ate as tate
from rumi_slam_tpu_torch.geometry import lie as tlie
from rumi_slam_tpu_torch.io.synthetic import SyntheticSequence
from rumi_slam_tpu_torch.optim import two_view as ttv
from rumi_slam_tpu_torch.system import SlamSystem, TrackState
from rumi_slam_tpu_torch.tracking import tracker as ttracker

from torch_system_drive import jax_draw_stream

torch.set_num_threads(1)

N_KF_ATOL = 2          # keyframe count
KF_POSE_ATOL = 5e-2    # raw [7] poses of keyframes at shared timestamps
KF_ALIGNED_RMSE = 1e-2  # their centres after a Sim3 alignment
ATE_ATOL = 2e-2        # metres
EXACT_KF_POSE_ATOL = 5e-4  # keyframe poses with JAX's two-view result injected
EXACT_ATE_ATOL = 2e-4      # metres, likewise


def configs(**tracking):
    """(JAX config, port config): ``tiny_config`` as it is in both packages
    (loop closing on, synchronous mapping) with the given tracking
    overrides."""
    jc = jax_tiny_config()
    jc = dataclasses.replace(jc, tracking=dataclasses.replace(jc.tracking, **tracking))
    tc = tiny_config()
    tc = dataclasses.replace(tc, tracking=dataclasses.replace(tc.tracking, **tracking))
    return jc, tc


def jax_two_view_init(draw, ray1, ray2, valid, **kw):
    """The JAX package's ``two_view_init`` on the port's inputs, with the key
    of the JAX draw the port was handed."""
    r = jtv.two_view_init(draw.key, *(jnp.asarray(x.numpy()) for x in (ray1, ray2, valid)),
                          **kw)
    return ttv.TwoViewResult(*(torch.from_numpy(np.array(x)) for x in r))


def run(package, n_frames, lost_span=None, *, jax_init=False, **tracking):
    """One package's drive over the verify sequence (seed 4, patch 3,
    320x240).  Counts the RANSAC key splits (JAX) or draws (port); the port
    draws from the JAX key stream, and with ``jax_init`` takes the JAX
    package's two-view result too."""
    seq = JaxSequence(n_frames=n_frames, width=320, height=240, n_points=1500, seed=4,
                      patch=3, lost_span=lost_span)
    jc, tc = configs(**tracking)
    if package == "jax":
        slam, attr = JaxSlam(jc), "_next_key"
        inner = slam._next_key
    else:
        slam, attr, inner = SlamSystem(tc, device="cpu"), "_next_draw", jax_draw_stream()
    calls = [0]

    def counted():
        calls[0] += 1
        return inner()

    setattr(slam, attr, counted)
    states = []
    with pytest.MonkeyPatch.context() as mp:
        if jax_init:
            mp.setattr(ttv, "two_view_init", jax_two_view_init)
        for i in range(n_frames):
            img, t = seq.frame(i)
            if package == "port":
                img = torch.from_numpy(np.array(img))
            states.append(slam.track_monocular(img, t).name)
    gt = np.stack([np.asarray(p) for p in seq.poses_gt])
    times, poses = slam.trajectory_of_map()
    ate = (jate if package == "jax" else tate).evaluate_trajectory(
        times, poses, seq.times, gt)["ate"]
    return dict(slam=slam, states=states, calls=calls[0], ate=ate)


def pair(j, t):
    return dict(jax=j["slam"], port=t["slam"], jstates=j["states"], tstates=t["states"],
                calls={"jax": j["calls"], "port": t["calls"]}, jate=j["ate"], tate=t["ate"])


@pytest.fixture(scope="module")
def verify_jax():
    return run("jax", 45)


@pytest.fixture(scope="module")
def verify_drive(verify_jax):
    return pair(verify_jax, run("port", 45))


@pytest.fixture(scope="module")
def verify_drive_jax_init(verify_jax):
    return pair(verify_jax, run("port", 45, jax_init=True))


@pytest.fixture(scope="module")
def lost_drive():
    # featureless frames 20..29; a 0.25 s relocalisation window sends the
    # tracker from RECENTLY_LOST to LOST inside the span
    kw = dict(lost_span=(20, 30), reloc_window_s=0.25)
    return pair(run("jax", 40, **kw), run("port", 40, **kw))


@pytest.fixture(scope="module")
def reloc_drive():
    # featureless frames 12..13, well inside the 3 s relocalisation window:
    # frame 14 arrives in RECENTLY_LOST with features
    calls = []
    real = ttracker.relocalize_map

    def counted(*a, **kw):
        tr, ref = real(*a, **kw)
        calls.append(int(tr.n_inliers))
        return tr, ref

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttracker, "relocalize_map", counted)
        d = pair(run("jax", 17, lost_span=(12, 14)), run("port", 17, lost_span=(12, 14)))
    d["port_relocalize_map_inliers"] = calls
    return d


def shared_keyframes(d):
    """Keyframe (times, JAX poses, port poses) at the timestamps both
    packages made a keyframe at."""
    jt, jp = d["jax"].keyframe_trajectory()
    tt, tp = d["port"].keyframe_trajectory()
    common = np.intersect1d(jt, tt)
    return jt, tt, np.asarray(jp)[np.isin(jt, common)], tp[np.isin(tt, common)]


def check_keyframes(d):
    """Keyframe count within N_KF_ATOL; the keyframes both packages made from
    the same frames agree in pose."""
    jslam, tslam = d["jax"], d["port"]
    assert abs(tslam.stats["n_kf"] - jslam.stats["n_kf"]) <= N_KF_ATOL
    jt, _, jp, tp = shared_keyframes(d)
    assert len(tp) >= 0.5 * len(jt)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=KF_POSE_ATOL)
    centres = [tlie.se3_t(tlie.se3_inverse(torch.from_numpy(p))) for p in (tp, jp)]
    assert tate.ate_rmse(*centres) < KF_ALIGNED_RMSE


def test_verify_drive_same_states(verify_drive):
    """The same states, and the port asks for RANSAC draws where the JAX
    facade splits its key: once per init attempt and once per keyframe
    after the two of the initial map (its mapping round)."""
    d = verify_drive
    assert d["tstates"] == d["jstates"]
    n_kf = {k: d[k].stats["n_kf"] for k in ("jax", "port")}
    assert d["calls"]["port"] - n_kf["port"] == d["calls"]["jax"] - n_kf["jax"]
    assert d["calls"]["port"] >= n_kf["port"] - 1
    assert d["tstates"].count("OK") > 0.6 * len(d["tstates"])
    assert d["port"].stats["n_kf"] >= 2


def test_verify_drive_keyframes_and_ate(verify_drive):
    d = verify_drive
    check_keyframes(d)
    assert d["tate"] < 0.15
    assert abs(d["tate"] - d["jate"]) < ATE_ATOL, (d["tate"], d["jate"])


def test_verify_drive_with_jax_init_is_exact(verify_drive_jax_init):
    """With JAX's draws and two-view result, the port makes the same
    keyframes from the same frames as the JAX package, asks for the same
    draws, and adds and fuses the same number of points."""
    d = verify_drive_jax_init
    jslam, tslam = d["jax"], d["port"]
    assert d["tstates"] == d["jstates"]
    assert d["calls"]["port"] == d["calls"]["jax"]
    assert tslam.stats == jslam.stats
    jt, tt, jp, tp = shared_keyframes(d)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=EXACT_KF_POSE_ATOL)
    assert abs(d["tate"] - d["jate"]) < EXACT_ATE_ATOL, (d["tate"], d["jate"])


def test_lost_span_transitions(lost_drive):
    """Both packages go OK -> RECENTLY_LOST -> LOST -> NOT_INITIALIZED on the
    same frames, open a second submap in ``_handle_lost``, and initialise
    again after the span."""
    d = lost_drive
    s = d["tstates"]
    assert s == d["jstates"]
    assert s[20] == "RECENTLY_LOST" and "LOST" not in s[:20]
    lost = s.index("NOT_INITIALIZED", 20)
    assert all(x == "RECENTLY_LOST" for x in s[20:lost])
    assert s[lost:].count("OK") > 0
    for slam in (d["jax"], d["port"]):
        assert slam.stats["n_new_maps"] == 1 and slam.n_maps_host == 2
        assert slam.stats["n_lost_frames"] == d["jax"].stats["n_lost_frames"] > 0
    check_keyframes(d)
    assert abs(d["tate"] - d["jate"]) < ATE_ATOL, (d["tate"], d["jate"])


def test_relocalization_inside_the_window(reloc_drive):
    """Both packages lose track on the span's first frame, stay
    RECENTLY_LOST through it, and relocalise against the map on the first
    frame with features: the port's facade reaches ``relocalize_map`` (the
    lost-span drive above never does), which recovers the pose."""
    d = reloc_drive
    s = d["tstates"]
    assert s == d["jstates"]
    assert s[12:14] == ["RECENTLY_LOST"] * 2 and s[14:] == ["OK"] * 3
    for slam in (d["jax"], d["port"]):
        assert slam.stats["n_reloc"] == 1 and slam.stats["n_new_maps"] == 0
        assert slam.stats["n_lost_frames"] == 2
    assert len(d["port_relocalize_map_inliers"]) == 1
    assert d["port_relocalize_map_inliers"][0] >= d["port"].cfg.tracking.min_track_inliers
    assert abs(d["tate"] - d["jate"]) < ATE_ATOL, (d["tate"], d["jate"])


def test_default_device_is_the_card():
    """``SlamSystem()`` asks for the card: on a host without one it raises
    and does not build on the CPU; ``device="cpu"`` is the explicit way."""
    if torch.cuda.is_available():
        assert SlamSystem(tiny_config()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SlamSystem(tiny_config())
    assert SlamSystem(tiny_config(), device="cpu").device.type == "cpu"


def test_unported_branches_raise():
    """Nothing of the port raises for want of a ROADMAP item any more: the
    sharded global BA (a ``mesh``, item 17) runs, and on a fresh system's
    empty map leaves it as it is.  A missing checkpoint is a
    ``FileNotFoundError``."""
    from rumi_slam_tpu_torch.parallel.distributed import BaMesh
    from rumi_slam_tpu_torch.tracking import local_mapping

    tc = tiny_config()
    assert dataclasses.asdict(tc) == dataclasses.asdict(jax_tiny_config())
    slam = SlamSystem(tc, device="cpu")
    assert local_mapping.global_bundle_adjustment(slam.ms, slam.K, 0,
                                                  mesh=BaMesh("cpu", 4)) is slam.ms
    with pytest.raises(FileNotFoundError):
        slam.load_map("no_such_map.ckpt")


def test_depth_modes_need_a_baseline():
    """``track_rgbd`` and ``track_stereo`` raise ``ValueError`` without a
    baseline, as the JAX facade does."""
    img = torch.zeros((240, 320))
    for slam in (SlamSystem(tiny_config(), device="cpu"), JaxSlam(jax_tiny_config())):
        with pytest.raises(ValueError, match="baseline"):
            slam.track_rgbd(img.numpy(), img.numpy(), 0.0)
        with pytest.raises(ValueError, match="baseline"):
            slam.track_stereo(img.numpy(), img.numpy(), 0.0)


def test_localization_mode_inserts_no_keyframe(verify_drive):
    slam = verify_drive["port"]
    n_kf = slam.stats["n_kf"]
    slam.activate_localization_mode()
    try:
        seq = SyntheticSequence(n_frames=45, width=320, height=240, n_points=1500, seed=4,
                                patch=3)
        states = [slam.track_monocular(seq.frame(i)[0], seq.times[i]).name
                  for i in (44, 44, 44, 44)]
    finally:
        slam.deactivate_localization_mode()
    assert states == ["OK"] * 4 and slam.stats["n_kf"] == n_kf
    t, p = slam.keyframe_trajectory()
    assert len(t) == n_kf and p.shape == (n_kf, 7) and (np.diff(t) > 0).all()
    assert slam.state == TrackState.OK
