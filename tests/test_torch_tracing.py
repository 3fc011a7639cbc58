"""The port's stage timer and the stages it records: host-clock samples as
before, ``slam/<name>`` ranges while a profiler records (and no range
otherwise), the tracking and mapping stages of a short CPU drive, and the
benchmark's readers of those stages on hand-built spans.  Port only."""

import dataclasses
import threading
import time
from unittest import mock

import pytest
import torch

from rumi_slam_tpu_torch.config import tiny_config
from rumi_slam_tpu_torch.geometry import camera, lie
from rumi_slam_tpu_torch.io.synthetic import SyntheticSequence
from rumi_slam_tpu_torch.optim import pose_opt
from rumi_slam_tpu_torch.rumination.coordinator import RuminationCoordinator
from rumi_slam_tpu_torch.system import SlamSystem, TrackState
from rumi_slam_tpu_torch.tracking import tracker
from rumi_slam_tpu_torch.utils import profiling
from rumi_slam_tpu_torch.utils.profiling import StageTimer
from slam_bench import harness
from slam_bench.reference import pose_opt as ref_pose_opt
from slam_bench.trace import StageSpans

NEW_METRICS = ("track_match_ms", "pose_opt_ms", "match_calls_per_frame", "mapping_round_ms",
               "on_frame_ms")


# ---------------------------------------------------------------------------
# StageTimer
# ---------------------------------------------------------------------------

def test_nested_stages_keep_their_stats():
    timer = StageTimer()
    for _ in range(3):
        with timer.stage("outer"):
            with timer.stage("inner"):
                sum(range(1000))
    st = timer.stats()
    assert set(st) == {"outer", "inner"}
    assert st["outer"]["n"] == st["inner"]["n"] == 3
    assert st["outer"]["total_s"] >= st["inner"]["total_s"] > 0
    for s in st.values():
        assert s["max_ms"] >= s["median_ms"] > 0 and s["mean_ms"] > 0
    assert [len(v) for v in timer.samples.values()] == [3, 3]
    rows = timer.report().splitlines()
    assert len(rows) == 3 and rows[1].startswith("inner") and rows[2].startswith("outer")


def test_a_stage_that_raises_is_still_timed():
    timer = StageTimer()
    with pytest.raises(ValueError):
        with timer.stage("bad"):
            raise ValueError("x")
    assert timer.stats()["bad"]["n"] == 1


def test_stages_are_slam_ranges_under_the_profiler():
    timer = StageTimer()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with timer.stage("outer"):
            with timer.stage("inner"):
                torch.ones(8).sum()
    names = [e.name for e in prof.events()]
    assert names.count("slam/outer") == 1 and names.count("slam/inner") == 1
    outer = next(e for e in prof.events() if e.name == "slam/outer")
    inner = next(e for e in prof.events() if e.name == "slam/inner")
    assert outer.time_range.start <= inner.time_range.start
    assert inner.time_range.end <= outer.time_range.end
    assert timer.stats()["outer"]["n"] == 1


def test_no_range_is_entered_without_a_profiler():
    timer = StageTimer()
    calls = []
    real = profiling.record_function

    def counting(name):
        calls.append(name)
        return real(name)

    with mock.patch.object(profiling, "record_function", counting):
        for _ in range(5):
            with timer.stage("a"), timer.stage("b"):
                pass
        assert calls == []
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            with timer.stage("a"):
                pass
    assert calls == ["slam/a"]
    assert timer.stats()["a"]["n"] == 6


def test_stage_helper_without_a_timer_records_nothing():
    with profiling.stage(None, "x"):
        pass
    timer = StageTimer()
    with profiling.stage(timer, "x"):
        pass
    assert timer.stats()["x"]["n"] == 1


# ---------------------------------------------------------------------------
# pose optimisation on the CPU: the eager loop, no graph and no graph stage
# ---------------------------------------------------------------------------

def pose_problem(n, seed):
    """n points 3-8 m in front of a camera, observed with 0.5 px of noise,
    a fifth of them moved by up to 30 px (outliers) and 5% invalid; the
    start pose is the true one perturbed."""
    g = torch.Generator().manual_seed(seed)
    K = torch.tensor([260.0, 260.0, 159.5, 119.5])
    pose = lie.se3_retract(lie.se3_identity(), torch.tensor([0.01, 0.03, -0.02, 0.05, -0.02, 0.03]))
    X = torch.rand(n, 3, generator=g) * torch.tensor([4.0, 3.0, 5.0]) + torch.tensor([-2.0, -1.5, 3.0])
    uv = camera.project_world(K, pose, X)[0] + 0.5 * torch.randn(n, 2, generator=g)
    out = torch.rand(n, generator=g) < 0.2
    uv = torch.where(out[:, None], uv + 60.0 * (torch.rand(n, 2, generator=g) - 0.5), uv)
    valid = torch.rand(n, generator=g) > 0.05
    tau = torch.randn(6, generator=g) * torch.tensor([0.004] * 3 + [0.01] * 3)
    return K, lie.se3_retract(pose, tau), X, uv, valid


@pytest.mark.parametrize("rounds,iters,weighted", [(3, 6, False), (4, 10, False), (3, 6, True)])
def test_pose_optimization_on_the_cpu_is_the_eager_loop(rounds, iters, weighted):
    """Bit for bit the frozen pre-graph copy; no graph is captured and no
    ``pose_opt_graph`` stage opens."""
    K, pose0, X, uv, valid = pose_problem(300, seed=rounds + 10 * weighted)
    inv = torch.rand(300, generator=torch.Generator().manual_seed(5)) + 0.5 if weighted else None
    captures = pose_opt.captures
    timer = StageTimer()
    spans = StageSpans(timer).spans
    res = pose_opt.pose_optimization(K, pose0, X, uv, valid, inv, n_rounds=rounds,
                                     n_iters=iters, timer=timer)
    ref = ref_pose_opt.pose_optimization(K, pose0, X, uv, valid, inv, n_rounds=rounds,
                                         n_iters=iters)
    for a, b in zip(res, ref):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert pose_opt.captures == captures
    assert spans == [] and not timer.samples
    assert getattr(pose_opt._local, "graphs", None) is None
    # the outliers go, most of the rest stay
    assert 0.6 * 300 < int(res.n_inliers) < 0.8 * 300


# ---------------------------------------------------------------------------
# the program's stages on a short CPU drive
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def drive():
    """20 tiny frames with the mapping round on the worker thread and a
    rumination coordinator; every stage of the system's timer is kept."""
    torch.set_num_threads(1)
    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, mapping=dataclasses.replace(cfg.mapping, overlapped=True))
    seq = SyntheticSequence(n_frames=20, width=320, height=240, n_points=1500, seed=4, patch=3)
    slam = SlamSystem(cfg, device="cpu")
    spans = StageSpans(slam.timer).spans    # (name, start, end, thread) of each stage
    RuminationCoordinator(slam, cfg)
    states = []
    for i in range(len(seq)):
        states.append(slam.track_monocular(*seq.frame(i)))
    slam.sync_mapping()
    slam.mapper.shutdown()
    return slam, seq, spans, states


def test_drive_records_the_mapping_round_on_the_worker_thread(drive):
    slam, _, spans, states = drive
    me = threading.get_ident()
    rounds = [s for s in spans if s[0] == "mapping_round"]
    assert rounds and all(tid != me for *_, tid in rounds)
    assert slam.stats.get("n_adopted", 0) >= 1
    lba = [s for s in spans if s[0] == "local_ba"]
    assert len(lba) == len(rounds)
    # each local BA lies inside a round on the same thread
    for _, s, e, tid in lba:
        assert any(rs <= s and e <= re and rt == tid for _, rs, re, rt in rounds)
    assert states.count(TrackState.OK) >= 5


def test_drive_records_one_on_frame_a_frame_and_matches_inside_track(drive):
    slam, seq, spans, _ = drive
    me = threading.get_ident()
    on_frame = [s for s in spans if s[0] == "on_frame"]
    assert len(on_frame) == len(seq) and all(tid == me for *_, tid in on_frame)
    tracks = [(s, e) for n, s, e, tid in spans if n == "track"]
    assert len(tracks) == len(slam.timer.samples["track"]) >= 5
    for name in ("track_match", "pose_opt"):
        kids = [(s, e, tid) for n, s, e, tid in spans if n == name]
        assert len(kids) >= len(tracks)
        assert all(tid == me and any(a <= s and e <= b for a, b in tracks)
                   for s, e, tid in kids)


def test_readers_on_the_drive_agree_with_the_track_stage(drive):
    _, _, spans, _ = drive
    run = harness.Run()
    run.spans = list(spans)
    run.t0 = min(s for _, s, _, _ in run.spans)
    run.t1 = max(e for _, _, e, _ in run.spans)
    track = harness.reader("metrics", "track_ms").read(run)
    got = {n: harness.reader("metrics", n).read(run) for n in NEW_METRICS}
    assert got["match_calls_per_frame"] >= 1.0
    assert got["track_match_ms"] + got["pose_opt_ms"] <= track
    assert got["on_frame_ms"] > 0 and got["mapping_round_ms"] > 0


def overlapped_drive(round_delay_s):
    """The 20 tiny frames of ``drive`` with the worker's mapping round held
    ``round_delay_s`` before it starts: (trajectory poses, keyframe poses,
    frames at which rounds were submitted, frames at which they were
    adopted)."""
    from rumi_slam_tpu_torch.tracking import mapping_worker as MW

    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, mapping=dataclasses.replace(cfg.mapping, overlapped=True))
    seq = SyntheticSequence(n_frames=20, width=320, height=240, n_points=1500, seed=4, patch=3)
    slam = SlamSystem(cfg, device="cpu")
    frame, submitted, adopted = [0], [], []
    submit, apply = slam.mapper.submit, slam._apply_mapping

    def submit_at(*a, **kw):
        ok = submit(*a, **kw)
        if ok:
            submitted.append(frame[0])
        return ok

    def apply_at(out):
        adopted.append(frame[0])
        return apply(out)

    def slow_round(*a, **kw):
        time.sleep(round_delay_s)
        return round_fn(*a, **kw)

    round_fn = MW.run_mapping_round
    slam.mapper.submit, slam._apply_mapping = submit_at, apply_at
    with mock.patch.object(MW, "run_mapping_round", slow_round):
        for i in range(len(seq)):
            frame[0] = i
            slam.track_monocular(*seq.frame(i))
        frame[0] = len(seq)
        slam.sync_mapping()
    slam.mapper.shutdown()
    poses = torch.stack([torch.as_tensor(p) for _, p, _, _ in slam.trajectory])
    return poses, slam.ms.kf_pose[:int(slam.ms.n_kf)], submitted, adopted


def test_overlapped_mapping_is_adopted_two_frames_after_its_keyframe():
    """Each round is adopted at the second frame after its keyframe, whether
    the worker is quick or slow, so the two drives track the same frames to
    the same poses."""
    torch.set_num_threads(1)
    quick = overlapped_drive(0.0)
    slow = overlapped_drive(0.4)
    poses, kf_poses, submitted, adopted = quick
    assert len(submitted) >= 2
    assert adopted == [min(k + SlamSystem.ADOPT_AFTER, 20) for k in submitted]
    assert slow[2:] == quick[2:]
    assert torch.equal(slow[0], poses) and torch.equal(slow[1], kf_poses)


def test_tracking_with_a_timer_gives_the_same_outputs(drive):
    slam, seq, _, _ = drive
    img, _ = seq.frame(len(seq) - 1)
    feats = slam._extract(slam._image(img))
    cfg = slam.cfg
    kw = dict(img_w=cfg.camera.width, img_h=cfg.camera.height,
              max_hamming=cfg.tracking.max_hamming, nn_ratio=cfg.tracking.nn_ratio)
    ms0, tr0 = tracker.track_frame(slam.ms, slam.K, feats, slam.last_pose,
                                   cfg.tracking.match_radius, **kw)
    timer = StageTimer()
    spans = StageSpans(timer).spans
    ms1, tr1 = tracker.track_frame(slam.ms, slam.K, feats, slam.last_pose,
                                   cfg.tracking.match_radius, **kw, timer=timer)
    for a, b in zip(tr0, tr1):
        assert torch.equal(a, b)
    assert torch.equal(ms0.pt_visible, ms1.pt_visible)
    assert torch.equal(ms0.pt_found, ms1.pt_found)
    assert int(tr0.n_inliers) >= cfg.tracking.min_track_inliers
    assert [s[0] for s in spans] == ["track_match", "pose_opt"]
    (_, _, match_end, _), (_, opt_start, _, _) = spans
    assert match_end <= opt_start

    kf = slam.last_kf_id
    r0 = tracker.track_reference_kf(slam.ms, slam.K, feats, kf, slam.last_pose)
    timer = StageTimer()
    spans = StageSpans(timer).spans
    r1 = tracker.track_reference_kf(slam.ms, slam.K, feats, kf, slam.last_pose, timer=timer)
    for a, b in zip(r0, r1):
        assert torch.equal(a, b)
    assert [s[0] for s in spans] == ["pose_opt"]


# ---------------------------------------------------------------------------
# the benchmark's readers on hand-built spans
# ---------------------------------------------------------------------------

def hand_run():
    """Two tracked frames in the window (one plain, one that falls back to
    its reference keyframe and retries with the wide window), one tracked
    frame in the profiled span and one before the window; worker rounds in
    the window, in the profiled span and one inline on the tracking thread."""
    run = harness.Run()
    run.t0, run.t1 = 0.0, 100.0
    run.span = (50.0, 53.0)
    main, worker = run.main_thread, run.main_thread + 1
    run.spans = [
        # before the window: ignored
        ("on_frame", -1.1, -1.09, main),
        ("track_match", -1.0, -0.95, main), ("pose_opt", -0.94, -0.9, main),
        ("track", -1.0, -0.8, main),
        # frame 1: plain
        ("on_frame", 0.9, 0.902, main),
        ("track_match", 1.0, 1.05, main), ("pose_opt", 1.06, 1.1, main),
        ("track", 1.0, 1.2, main),
        # frame 2: reference-KF fallback, then the wide window
        ("on_frame", 1.9, 1.903, main),
        ("track_match", 2.0, 2.1, main),
        ("pose_opt", 2.25, 2.29, main), ("track_ref_kf", 2.1, 2.3, main),
        ("track_match", 2.3, 2.4, main), ("pose_opt", 2.4, 2.45, main),
        ("mapping_round", 2.46, 2.48, main),     # inline round: not the worker's
        ("keyframe", 2.455, 2.49, main),
        ("track", 2.0, 2.5, main),
        # a stage no tracked frame holds (a relocalisation's)
        ("pose_opt", 3.0, 3.5, main), ("relocalize", 3.0, 3.6, main),
        # frame 3 overlaps the profiled span: ignored
        ("on_frame", 51.9, 51.95, main),
        ("track_match", 52.0, 52.1, main), ("pose_opt", 52.1, 52.15, main),
        ("track", 52.0, 52.2, main),
        # the worker
        ("local_ba", 1.2, 1.5, worker), ("mapping_round", 1.1, 1.6, worker),
        ("mapping_round", 4.0, 4.3, worker),
        ("mapping_round", 52.5, 53.5, worker),   # overlaps the profiled span
        ("mapping_round", 99.9, 100.5, worker),  # ends after the window
    ]
    return run


@pytest.mark.parametrize("name,value", [
    ("track_match_ms", 1e3 * (0.05 + 0.1 + 0.1) / 2),
    ("pose_opt_ms", 1e3 * (0.04 + 0.04 + 0.05) / 2),
    ("match_calls_per_frame", (1 + 3) / 2),
    ("mapping_round_ms", 1e3 * (0.5 + 0.3) / 2),
    ("on_frame_ms", 1e3 * (0.002 + 0.003) / 2),
])
def test_reader_on_hand_built_spans(name, value):
    assert harness.reader("metrics", name).read(hand_run()) == pytest.approx(value, rel=1e-9)


def test_pose_opt_graph_share_on_hand_built_spans():
    """Frame 1's call and the first of frame 2's ran as graphs, frame 2's
    second did not; the relocalisation's graph and the profiled frame's do
    not count."""
    run = hand_run()
    main = run.main_thread
    run.spans += [("pose_opt_graph", 1.07, 1.09, main), ("pose_opt_graph", 2.26, 2.28, main),
                  ("pose_opt_graph", 3.1, 3.4, main), ("pose_opt_graph", 52.11, 52.14, main),
                  ("pose_opt_graph", 1.3, 1.4, main + 1)]
    read = harness.reader("metrics", "pose_opt_graph_share").read
    assert read(run) == pytest.approx(2 / 3, rel=1e-12)
    assert read(hand_run()) is None            # a program without the stage
    run.spans = [s for s in run.spans if s[:3] != ("pose_opt_graph", 2.26, 2.28)]
    assert read(run) == pytest.approx(1 / 3, rel=1e-12)


def test_readers_without_the_new_stages_read_nothing():
    """The program before these stages: only the facade's stages."""
    run = hand_run()
    run.spans = [s for s in run.spans if s[0] in ("track", "keyframe", "relocalize")]
    for name in NEW_METRICS:
        assert harness.reader("metrics", name).read(run) is None, name
    assert harness.reader("metrics", "track_ms").read(run) is not None


def test_new_metrics_are_benchmark_entries():
    bench = harness.benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    names = [m["name"] for m in bench["per_layer"]]
    assert names[names.index(NEW_METRICS[0]):][:len(NEW_METRICS)] == list(NEW_METRICS)
    for name in NEW_METRICS:
        m = entries[name]
        mod = harness.reader("metrics", name)
        assert (mod.LAYER, mod.MOVES) == (m["layer"], m["moves"])
        assert m["source"] == "program_span" and "workloads" not in m
    m = entries["pose_opt_graph_share"]
    assert names[-1] == m["name"] and m["layer"] == entries["pose_opt_ms"]["layer"]
    assert (m["unit"], m["better"], m["source"]) == ("share", "higher", "program_span")
    assert "euroc-mono-det.sweep" in m["workloads"]
    assert set(m["workloads"]) <= {w["name"] for w in bench["workloads"]}
