"""Tests of the hand-written CUDA kernel; they need an NVIDIA card and the
CUDA toolkit, and skip without a card.  This file imports no JAX, so it also
runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from rumi_slam_tpu_torch.config import tiny_config
from rumi_slam_tpu_torch.io.synthetic import SyntheticSequence
from rumi_slam_tpu_torch.mapstate import map_state as M
from rumi_slam_tpu_torch.ops import fused_matcher as fm
from rumi_slam_tpu_torch.ops import matcher
from rumi_slam_tpu_torch.ops.orb import Features
from rumi_slam_tpu_torch.optim import ransac
from rumi_slam_tpu_torch.system import SlamSystem
from rumi_slam_tpu_torch.tracking import tracker

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def problem(F, P, seed=0, span=300.0):
    """Seeded descriptors and pixels; some points copy a query's descriptor
    and half of those sit within 20 px of it; ~10% invalid rows each side."""
    rng = np.random.default_rng(seed)
    dq = rng.integers(0, 2**32, (F, 8), dtype=np.uint32)
    dp = rng.integers(0, 2**32, (P, 8), dtype=np.uint32)
    n_copy = min(100, F, P)
    rows = rng.choice(P, n_copy, replace=False)
    qrows = rng.choice(F, n_copy, replace=False)
    dp[rows] = dq[qrows]
    uv_q = rng.uniform(0, span, (F, 2)).astype(np.float32)
    uv_p = rng.uniform(0, span, (P, 2)).astype(np.float32)
    uv_p[rows[: n_copy // 2]] = uv_q[qrows[: n_copy // 2]] + rng.uniform(-14, 14, (n_copy // 2, 2))
    return [torch.from_numpy(a) for a in (dq.view(np.int32), dp.view(np.int32), uv_q, uv_p,
                                          rng.random(F) > 0.1, rng.random(P) > 0.1)]


def run_both(args, radius, dev):
    cu = [a.to(dev) for a in args]
    before = fm.fused_match.launches
    idx_k, dist_k = fm.fused_match(*cu[:4], radius, *cu[4:])
    torch.cuda.synchronize()
    assert fm.fused_match.launches == before + 1
    idx_p, dist_p = fm.fused_match_plain(*cu[:4], radius, *cu[4:])
    return idx_k.cpu(), dist_k.cpu(), idx_p.cpu(), dist_p.cpu()


@pytest.mark.parametrize("F,P,radius", [(256, 1024, 60.0), (1000, 5000, 30.0), (1, 1, 500.0),
                                        (129, 257, 1e4), (2048, 16384, 15.0),
                                        (130, 70000, 1e12), (1024, 16385, 40.0)])
def test_kernel_equals_plain(dev, F, P, radius):
    idx_k, dist_k, idx_p, dist_p = run_both(problem(F, P, seed=F), radius, dev)
    assert torch.equal(idx_k, idx_p)
    m = idx_p >= 0
    assert torch.equal(dist_k[m], dist_p[m]) and torch.isinf(dist_k[~m]).all()


def test_kernel_ties_and_radius_boundary(dev):
    """Equal best distances go to the lowest index and fail the ratio test;
    a point exactly on the radius is inside, as in the plain version."""
    dq, dp, uv_q, uv_p, vq, vp = problem(300, 600, seed=3)
    dp[10] = dq[0]
    dp[500] = dq[0]                          # tie for query 0
    uv_p[10] = uv_p[500] = uv_q[0]
    dp[20] = dq[1]
    uv_q[1] = torch.tensor([100.0, 50.0])
    uv_p[20] = torch.tensor([103.0, 54.0])          # exactly 5 px away
    vq[:2] = True
    vp[[10, 20, 500]] = True
    idx_k, _, idx_p, _ = run_both((dq, dp, uv_q, uv_p, vq, vp), 5.0, dev)
    assert torch.equal(idx_k, idx_p)
    assert idx_k[0] == -1 and idx_k[1] == 20


def test_kernel_ties_across_splits_and_exact_radius_at_full_width(dev):
    """P = 16384 is one tile per split: equal descriptors in different
    splits go to the lowest index, whatever order the blocks ran in, and a
    point exactly on the radius in the last split is inside."""
    dq, dp, uv_q, uv_p, vq, vp = problem(1024, 16384, seed=8, span=600.0)
    vq[:3] = True
    one_bit = torch.zeros(8, dtype=torch.int32)
    one_bit[0] = 1
    for q, rows in ((0, [300, 9000, 16383]), (1, [255, 256])):
        dp[rows] = dq[q] ^ one_bit               # a tie at distance 1
        uv_p[rows] = uv_q[q]
        vp[rows] = True
    dp[16000] = dq[2]
    uv_q[2] = torch.tensor([200.0, 100.0])
    uv_p[16000] = torch.tensor([212.0, 105.0])   # exactly 13 px away
    vp[16000] = True
    cu = [a.to(dev) for a in (dq, dp, uv_q, uv_p, vq, vp)]
    for _ in range(3):
        idx_k, dist_k = fm.fused_match(*cu[:4], 13.0, *cu[4:], ratio=1.01)
        idx_p, dist_p = fm.fused_match_plain(*cu[:4], 13.0, *cu[4:], ratio=1.01)
        assert torch.equal(idx_k, idx_p) and torch.equal(dist_k, dist_p)
        assert idx_k[:3].tolist() == [300, 255, 16000]
    idx_s, _ = fm.fused_match_plain_split(*cu[:4], 13.0, *cu[4:], ratio=1.01, n_splits=64)
    assert torch.equal(idx_s, idx_p)


def bank_problem(Na, Nb, seed, valid_share):
    """Seeded query and bank descriptors; 60 bank rows copy a query, some of
    them twice (ties) and some with a one-bit neighbour (a close second)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2**32, (Na, 8), dtype=np.uint32)
    b = rng.integers(0, 2**32, (Nb, 8), dtype=np.uint32)
    n = min(60, Na, Nb // 4)
    rows = rng.choice(Nb, 3 * n, replace=False)
    qrows = rng.choice(Na, n, replace=False)
    b[rows[:n]] = a[qrows]
    b[rows[n:n + n // 3]] = a[qrows[:n // 3]]                          # ties
    b[rows[2 * n:2 * n + n // 3]] = a[qrows[-(n // 3):]] ^ np.uint32(1)  # one bit away
    return [torch.from_numpy(x) for x in (a.view(np.int32), rng.random(Na) > 0.1,
                                          b.view(np.int32), rng.random(Nb) < valid_share)]


@pytest.mark.parametrize("Na,Nb,valid_share", [(256, 4096, 0.9), (1000, 50000, 0.5), (1, 1, 1.0),
                                               (129, 257, 0.9), (1024, 262144, 0.08),
                                               (300, 16384, 0.0)])
def test_bank_kernel_equals_match_chunked(dev, Na, Nb, valid_share):
    """The gate-off instantiation against ``matcher.match_chunked`` (one
    chunk: the kernel needs no divisor of the bank's rows)."""
    a, va, b, vb = [x.to(dev) for x in bank_problem(Na, Nb, Na + Nb, valid_share)]
    before = fm.match_bank.launches
    for max_dist, ratio in ((80.0, 0.9), (100.0, 1.01)):
        idx_k, dist_k = fm.match_bank(a, va, b, vb, n_chunks=1, max_dist=max_dist, ratio=ratio)
        torch.cuda.synchronize()
        idx_p, dist_p = matcher.match_chunked(a, va, b, vb, n_chunks=1, max_dist=max_dist,
                                              ratio=ratio)
        assert torch.equal(idx_k, idx_p) and torch.equal(dist_k, dist_p)
    assert fm.match_bank.launches == before + 2
    assert valid_share < 0.5 or Nb < 4096 or int((idx_k >= 0).sum()) > 20


def test_bank_kernel_rejects_bad_inputs(dev):
    a, va, b, vb = [x.to(dev) for x in bank_problem(64, 512, 1, 0.9)]
    with pytest.raises(ValueError, match="desc_p"):
        fm.match_bank(a, va, b[:, :4], vb, n_chunks=1)
    with pytest.raises(ValueError, match="valid_q"):
        fm.match_bank(a, va.to(torch.uint8), b, vb, n_chunks=1)
    with pytest.raises(ValueError, match="is on"):
        fm.match_bank(a, va, b, vb.cpu(), n_chunks=1)


def test_kernel_rejects_bad_inputs(dev):
    dq, dp, uv_q, uv_p, vq, vp = [a.to(dev) for a in problem(64, 128, seed=4)]
    with pytest.raises(ValueError, match="desc_q"):
        fm.fused_match(dq.long(), dp, uv_q, uv_p, 10.0, vq, vp)
    with pytest.raises(ValueError, match="contiguous"):
        fm.fused_match(dq, dp, uv_q, uv_p.t().contiguous().t(), 10.0, vq, vp)
    with pytest.raises(ValueError, match="is on"):
        fm.fused_match(dq, dp.cpu(), uv_q, uv_p, 10.0, vq, vp)


def test_track_frame_on_card_equals_cpu(dev):
    """track_frame through the kernel on the card equals track_frame through
    the plain version on the CPU."""
    rng = np.random.default_rng(5)
    n, F = 600, 256
    K = torch.tensor([260.0, 260.0, 159.5, 119.5])
    X = torch.from_numpy(rng.uniform([-2, -1.5, 3], [2, 1.5, 8], (n, 3)).astype(np.float32))
    desc = torch.from_numpy(rng.integers(0, 2**32, (n, 8), dtype=np.uint32).view(np.int32))
    ms = M.empty(4, F, 1024)
    ms.pt_xyz[:n], ms.pt_desc[:n], ms.pt_valid[:n], ms.pt_map_id[:n] = X, desc, True, 0
    pose = torch.tensor([1.0, 0, 0, 0, 0.02, -0.01, 0.03])
    from rumi_slam_tpu_torch.geometry import camera

    uv = camera.project_world(K, pose, X[:F])[0] + torch.from_numpy(
        rng.normal(scale=0.7, size=(F, 2)).astype(np.float32))
    feats = Features(uv=uv.contiguous(), response=torch.ones(F), angle=torch.zeros(F),
                     octave=torch.zeros(F, dtype=torch.int32), desc=desc[:F].clone(),
                     valid=torch.ones(F, dtype=torch.bool))
    pred = torch.tensor([1.0, 0, 0, 0, 0.0, 0.0, 0.0])
    _, tr_c = tracker.track_frame(ms, K, feats, pred, 15.0, img_w=320, img_h=240)
    to = lambda x: x.to(dev)
    _, tr_g = tracker.track_frame(M.MapState(*map(to, ms)), to(K), Features(*map(to, feats)),
                                  to(pred), 15.0, img_w=320, img_h=240)
    assert torch.equal(tr_g.assoc.cpu(), tr_c.assoc)
    assert int(tr_g.n_inliers) == int(tr_c.n_inliers) > 100
    torch.testing.assert_close(tr_g.pose.cpu(), tr_c.pose, rtol=0, atol=1e-4)


def test_relocalize_map_on_card_equals_cpu(dev, monkeypatch):
    """``relocalize_map`` through the gate-off kernel on the card against
    ``relocalize_map`` through ``match_chunked`` on the CPU, given the same
    RANSAC draw, on the map of a short drive and a frame the map has seen.
    The matcher's output is equal bit for bit.  PnP then solves each
    hypothesis with a float32 eigen decomposition (``pnp._dlt_pose``) whose
    last digits differ between the card's solver and the CPU's, and takes the
    consensus set of the best raw hypothesis, a noisy subset of the true
    matches.  Handed the card's hypotheses, the CPU returns the same
    ``assoc``; solving its own, it recovers the pose, agrees wherever both
    associate a feature and polishes to a pose within 0.01 (the two consensus
    sets may share few rows or none)."""
    from rumi_slam_tpu_torch.optim import pnp

    seq = SyntheticSequence(n_frames=14, width=320, height=240, n_points=1500, seed=4, patch=3)
    slam = SlamSystem(tiny_config(), device="cpu")
    for i in range(14):
        slam.track_monocular(*seq.frame(i))
    assert slam.stats["n_kf"] >= 3
    feats = slam.extractor(seq.frame(12)[0])
    to = lambda x: x.to(dev)
    ms_g, K_g, feats_g = M.MapState(*map(to, slam.ms)), to(slam.K), Features(*map(to, feats))
    matched, solved = [], []
    match_bank, dlt_pose = tracker.match_bank, pnp._dlt_pose
    monkeypatch.setattr(tracker, "match_bank",
                        lambda *a, **kw: matched.append(match_bank(*a, **kw)) or matched[-1])
    draw = lambda: ransac.sampler(torch.Generator().manual_seed(1))
    before = fm.match_bank.launches
    monkeypatch.setattr(pnp, "_dlt_pose",
                        lambda X, rays: solved.append(dlt_pose(X, rays)) or solved[-1])
    tr_g, ref_g = tracker.relocalize_map(draw(), ms_g, K_g, feats_g)
    assert fm.match_bank.launches == before + 1 and len(solved) == 1
    monkeypatch.setattr(pnp, "_dlt_pose", lambda X, rays: solved[0].cpu())
    tr_h, ref_h = tracker.relocalize_map(draw(), slam.ms, slam.K, feats)
    monkeypatch.setattr(pnp, "_dlt_pose", dlt_pose)
    tr_c, _ = tracker.relocalize_map(draw(), slam.ms, slam.K, feats)
    (idx_g, dist_g), _, (idx_c, dist_c) = matched
    assert torch.equal(idx_g.cpu(), idx_c) and torch.equal(dist_g.cpu(), dist_c)
    assert int(tr_g.n_candidates) == int(tr_c.n_candidates)
    a_g, a_c = tr_g.assoc.cpu(), tr_c.assoc
    # the card's hypotheses on the CPU: the same result from there on
    assert torch.equal(a_g, tr_h.assoc) and int(ref_g) == int(ref_h)
    torch.testing.assert_close(tr_g.pose.cpu(), tr_h.pose, rtol=0, atol=1e-4)
    # the CPU's own hypotheses
    both = (a_g >= 0) & (a_c >= 0)
    n_min = min(int(tr_g.n_inliers), int(tr_c.n_inliers))
    assert n_min >= 12
    assert torch.equal(a_g[both], a_c[both])
    torch.testing.assert_close(tr_g.pose.cpu(), tr_c.pose, rtol=0, atol=1e-2)


# ---------------------------------------------------------------------------
# loop closing, checkpoint and rumination on the card (tiny sizes)
# ---------------------------------------------------------------------------

def test_horn_alignment_batched_eigh_card_vs_cpu(dev):
    """256 3-point hypotheses: the batched 4x4 ``eigh`` on the card against
    the CPU's on the same input, degenerate triples left out.  A nearly
    collinear triple is ill-conditioned and the two solvers then differ in
    the third digit (4.4e-3 seen on an H100), so the bulk is held tightly
    (median 1e-5, 95% within 1e-3) and the worst loosely (0.05)."""
    from rumi_slam_tpu_torch.geometry import alignment

    g = torch.Generator().manual_seed(0)
    src = torch.randn((200, 3), generator=g) * 2.0
    dst = 1.3 * src @ torch.linalg.qr(torch.randn((3, 3), generator=g))[0].T + 0.5
    idx = torch.randint(0, 200, (256, 3), generator=g)
    distinct = torch.tensor([len(set(r)) == 3 for r in idx.tolist()])
    S_cpu = alignment.horn_alignment(src[idx], dst[idx])
    S_gpu = alignment.horn_alignment(src.to(dev)[idx.to(dev)], dst.to(dev)[idx.to(dev)]).cpu()
    d = (S_gpu - S_cpu)[distinct].abs().amax(dim=1)
    assert float(d.median()) < 1e-5 and float((d < 1e-3).float().mean()) >= 0.95
    assert float(d.max()) < 0.05


def test_pose_graph_card_vs_cpu(dev):
    from rumi_slam_tpu_torch.geometry import lie
    from rumi_slam_tpu_torch.optim import pose_graph

    n = 12
    truth = torch.zeros((n, 7))
    truth[:, 0] = 1.0
    truth[:, 4] = 0.5 * torch.arange(n)
    est = truth.clone()
    est[n - 1, 4] += 0.3
    S_t = lie.sim3_from_se3(truth)
    ei = torch.tensor(list(range(n - 1)) + [0, 0, 0], dtype=torch.int32)
    ej = torch.tensor(list(range(1, n)) + [n - 1, 0, 0], dtype=torch.int32)
    w = torch.tensor([1.0] * (n - 1) + [3.0, 0.0, 0.0])
    edges = pose_graph.PoseGraphEdges(ei, ej, pose_graph.relative_sim3(S_t[ei.long()],
                                                                       S_t[ej.long()]), w)
    fixed = torch.zeros(n, dtype=torch.bool)
    fixed[0] = True
    out_c = pose_graph.optimize_pose_graph(lie.sim3_from_se3(est), edges, fixed)
    out_g = pose_graph.optimize_pose_graph(
        lie.sim3_from_se3(est).to(dev), pose_graph.PoseGraphEdges(*(x.to(dev) for x in edges)),
        fixed.to(dev))
    assert out_g.is_cuda and float((out_g.cpu() - out_c).abs().max()) < 1e-3
    assert float((out_g[n - 1, 4:7].cpu() - truth[n - 1, 4:7]).norm()) < 0.02


def test_checkpoint_roundtrip_on_the_card(dev, tmp_path):
    from rumi_slam_tpu_torch.mapstate import checkpoint

    seq = SyntheticSequence(n_frames=12, width=320, height=240, n_points=1500, seed=4, patch=3,
                            device=dev)
    slam = SlamSystem(tiny_config())
    for i in range(12):
        slam.track_monocular(*seq.frame(i))
    path = slam.save_map(tmp_path / "m.ckpt")
    loaded = checkpoint.load(path)                  # the card is the default
    for k, a, b in zip(slam.ms._fields, slam.ms, loaded):
        assert b.is_cuda and torch.equal(a, b), k
    cpu = checkpoint.load(path, device="cpu")
    assert not cpu.kf_pose.is_cuda and torch.equal(cpu.kf_desc, slam.ms.kf_desc.cpu())


def test_async_shard_hands_over_complete_tensors(dev):
    """A build under the shard's own stream: the CloudMap that ``poll``
    returns is complete and usable on the default stream at once."""
    import time

    from rumi_slam_tpu_torch.rumination import cloud_map
    from rumi_slam_tpu_torch.rumination.remote import AsyncRuminationShard
    from rumi_slam_tpu_torch.rumination.sampler import RecordedFrame

    class Backend:
        device = dev
        last_weld_info = None

        def build(self, bundle, anchor_times=(), anchor_split=None):
            assert torch.cuda.current_stream() != torch.cuda.default_stream()
            x = torch.ones((2048, 2048), device=dev)
            for _ in range(50):                      # queue real work on the side stream
                x = (x @ x) / 2048.0
            ms = M.empty(8, 16, 64, dev)
            return cloud_map.from_map_state(ms._replace(pt_xyz=ms.pt_xyz + x[0, 0]), 0)

    shard = AsyncRuminationShard(tiny_config(), backend=Backend())
    try:
        assert shard.submit(1, [RecordedFrame(0.0, np.zeros((8, 8), np.float32))])
        got, deadline = None, time.time() + 60
        while got is None and time.time() < deadline:
            got = shard.poll()
            time.sleep(0.005)
        assert got is not None and shard.last_error is None
        assert bool((got[1].pt_xyz == 1.0).all())
    finally:
        shard.shutdown()


def test_mapping_worker_runs_on_the_submitters_stream(dev, monkeypatch):
    """A system with overlapped mapping driven under a stream of its own: the
    worker thread (whose current stream would be the default one) runs every
    round on the stream the snapshot was queued on."""
    import dataclasses

    from rumi_slam_tpu_torch.tracking import mapping_worker as MW

    seen, real = [], MW.run_mapping_round

    def spy(*a, **kw):
        seen.append(torch.cuda.current_stream())
        return real(*a, **kw)

    monkeypatch.setattr(MW, "run_mapping_round", spy)
    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, mapping=dataclasses.replace(cfg.mapping, overlapped=True))
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        seq = SyntheticSequence(n_frames=20, width=320, height=240, n_points=1500, seed=4,
                                patch=3, device=dev)
        slam = SlamSystem(cfg)
        for i in range(20):
            slam.track_monocular(*seq.frame(i))
        slam.sync_mapping()
    slam.mapper.shutdown()
    side.synchronize()
    assert seen and all(s == side for s in seen)
    assert slam.stats.get("n_adopted", 0) >= 1
    assert bool(torch.isfinite(slam.ms.kf_pose).all())


def depth_frames(n=1):
    """The tiny depth scene (seed 5) with an 8 cm baseline: (system config,
    sequence)."""
    import dataclasses

    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, camera=dataclasses.replace(
        cfg.camera, baseline=0.08, th_depth=30.0, depth_factor=1.0))
    seq = SyntheticSequence(n_frames=n, width=320, height=240, n_points=1500, seed=5, patch=3,
                            K=cfg.intrinsics())
    return cfg, seq


def test_depth_from_rgbd_on_card_equals_cpu(dev):
    """The same keypoints and depth map (pixel coordinates at .5 among them):
    the card rounds half to even as the CPU does, and gates alike."""
    from rumi_slam_tpu_torch.ops import stereo

    cfg, seq = depth_frames()
    _, depth, _ = seq.frame_rgbd(0)
    rng = np.random.default_rng(0)
    uv = np.concatenate([rng.uniform(0, [319, 239], (1000, 2)),
                         np.floor(rng.uniform(0, [319, 239], (24, 2))) + 0.5]).astype(np.float32)
    uv = torch.from_numpy(uv)
    out = [stereo.depth_from_rgbd(depth.to(d), uv.to(d), cfg.camera.bf, depth_factor=1.0,
                                  max_z=30.0) for d in (dev, "cpu")]
    assert torch.equal(out[0][1].cpu(), out[1][1])
    torch.testing.assert_close(out[0][0].cpu(), out[1][0], rtol=1e-6, atol=0)
    assert int((out[1][1] > 0).sum()) > 100


def test_match_stereo_on_card_equals_cpu(dev):
    """One set of ORB features of a stereo pair (extracted on the CPU) through
    ``match_stereo`` on the card and on the CPU: the same matches, so the
    same ``ur`` and ``z``."""
    from rumi_slam_tpu_torch.ops import stereo

    cfg, seq = depth_frames()
    img_l, img_r, _ = seq.frame_stereo(0, 0.08)
    slam = SlamSystem(cfg, device="cpu")
    fl, fr = slam._extract(img_l), slam._extract(img_r)
    ur_c, z_c = stereo.match_stereo(fl, fr, cfg.camera.bf)
    ur_g, z_g = stereo.match_stereo(Features(*(x.to(dev) for x in fl)),
                                    Features(*(x.to(dev) for x in fr)), cfg.camera.bf)
    assert torch.equal(ur_g.cpu(), ur_c)
    torch.testing.assert_close(z_g.cpu(), z_c, rtol=1e-6, atol=0)
    assert int((z_c > 0).sum()) > 30


@pytest.mark.parametrize("mode", ["rgbd", "stereo"])
def test_depth_drive_on_card(dev, mode):
    """Six frames of the tiny depth drive on the card: initialised from depth
    on the first frame, OK on every frame, the gated kernel launched once
    for each frame tracked in OK."""
    cfg, _ = depth_frames()
    seq = SyntheticSequence(n_frames=6, width=320, height=240, n_points=1500, seed=5, patch=3,
                            K=cfg.intrinsics(dev), device=dev)
    slam = SlamSystem(cfg, device=dev)
    before = fm.fused_match.launches
    for i in range(len(seq)):
        st = (slam.track_rgbd(*seq.frame_rgbd(i)) if mode == "rgbd"
              else slam.track_stereo(*seq.frame_stereo(i, 0.08)))
        assert st.name == "OK"
    assert fm.fused_match.launches - before >= len(slam.timer.samples["track"]) == 5
    assert slam.stats["n_kf"] >= 2


def _inertial_window():
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch_inertial_window as W

    return W


def test_preintegrate_on_card_equals_cpu(dev):
    """Nine intervals of 50 IMU samples in one batched call, with padding rows:
    each field within 1e-4 of its largest entry (450 float32 steps summed in
    another order)."""
    W = _inertial_window()
    from rumi_slam_tpu_torch.inertial import preintegration as P

    gyro, acc, dts = (torch.from_numpy(x) for x in W.window(1, n_points=200, n_pose_points=64)["imu"])
    dts = dts.clone()
    dts[:, -5:] = 0.0
    cpu = P.preintegrate(gyro, acc, dts, P.zero_bias(device="cpu"))
    card = P.preintegrate(gyro.to(dev), acc.to(dev), dts.to(dev), P.zero_bias(device=dev))
    for a, b in zip(card[:-1], cpu[:-1]):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-4 * float(b.abs().max()))


def test_inertial_solvers_on_card_equal_cpu(dev):
    """The three inertial solvers on a reduced window (4 keyframes, 300
    points): the card within 1e-4 of the CPU in orientations, positions and
    points, 1e-3 m/s in velocities and 1e-5 in scale, the same pose
    inliers, the cost never rising.  ``chip_smoke.py`` phase 12 (c) sets
    these limits from its readings on the full window."""
    W = _inertial_window()
    win = W.window(2, n_kf=4, n_points=300, obs_per_point=3, n_pose_points=200)
    card = W.solve_all(W.to_device(win, dev), dev)
    cpu = W.solve_all(W.to_device(win, "cpu"), "cpu")
    io, cio = card["inertial_only"], cpu["inertial_only"]
    assert abs(float(io.scale) - float(cio.scale)) <= 1e-5 * float(cio.scale)
    assert float(io.cost) <= float(card["inertial_only_0"].cost)
    torch.testing.assert_close(io.velocities.cpu(), cio.velocities, rtol=0, atol=1e-3)
    for name in ("pose_inertial", "visual_inertial_ba"):
        a, b = card[name], cpu[name]
        torch.testing.assert_close(a.q_wb.cpu(), b.q_wb, rtol=0, atol=1e-4)
        torch.testing.assert_close(a.p_wb.cpu(), b.p_wb, rtol=0, atol=1e-4)
        torch.testing.assert_close(a.v.cpu(), b.v, rtol=0, atol=1e-3)
    assert int(card["pose_inertial"].n_inliers) == int(cpu["pose_inertial"].n_inliers)
    vi = card["visual_inertial_ba"]
    torch.testing.assert_close(vi.points.cpu(), cpu["visual_inertial_ba"].points, rtol=0,
                               atol=1e-4)
    assert float(vi.cost) <= float(vi.cost0)


@pytest.mark.parametrize("rank_deficient", [False, True])
def test_marginalize_on_card_equals_cpu(dev, rank_deficient):
    from rumi_slam_tpu_torch.optim import ba

    rng = np.random.default_rng(3)
    J = rng.normal(size=(60, 30)).astype(np.float32)
    if rank_deficient:
        J[:, 11] = J[:, 10]
    H, b = torch.from_numpy(J.T @ J), torch.from_numpy(rng.normal(size=30).astype(np.float32))
    Hc, bc = ba.marginalize(H, b, 6, 15)
    Hg, bg = ba.marginalize(H.to(dev), b.to(dev), 6, 15)
    scale = float(H.abs().max())
    torch.testing.assert_close(Hg.cpu(), Hc, rtol=0, atol=1e-4 * scale)
    torch.testing.assert_close(bg.cpu(), bc, rtol=0, atol=1e-4 * max(float(b.abs().max()), 1.0))
    assert not Hg[6:15].any() and not bg[6:15].any()
