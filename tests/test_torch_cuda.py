"""Tests of the hand-written CUDA kernel; they need an NVIDIA card and the
CUDA toolkit, and skip without a card.  This file imports no JAX, so it also
runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from rumi_slam_tpu_torch.mapstate import map_state as M
from rumi_slam_tpu_torch.ops import fused_matcher as fm
from rumi_slam_tpu_torch.ops.orb import Features
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
                                        (129, 257, 1e4), (2048, 16384, 15.0)])
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
