"""Parity of the port's local mapping (``tracking/local_mapping.py``) and
mapping round (``tracking/mapping_worker.py``) with the JAX package.

The inputs are real: the MapState snapshots handed to the mapping rounds of
a short port drive (tests/torch_system_drive.py ``mapping_inputs``), carried
into the JAX package with ``to_numpy``.  Both packages then run each
function on the same map.

Tolerances: associations, validity and counts are exact; the outputs of the
windowed bundle adjustment (6 float32 LM iterations over normal equations
summed in another order) are allclose at 1e-4 for poses and 1e-3 (absolute
and relative) for points, and its chi2 gate at the final estimate may classify a rare
observation on the other side (at most 0.5% of the window's associations).
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rumi_slam_tpu.config import tiny_config as jax_tiny_config
from rumi_slam_tpu.mapstate import map_state as jM
from rumi_slam_tpu.tracking import local_mapping as jLM
from rumi_slam_tpu.tracking import mapping_worker as jMW
from rumi_slam_tpu_torch.config import tiny_config
from rumi_slam_tpu_torch.mapstate import map_state as tM
from rumi_slam_tpu_torch.tracking import local_mapping as tLM
from rumi_slam_tpu_torch.tracking import mapping_worker as tMW

from torch_system_drive import jax_draw, mapping_inputs

torch.set_num_threads(1)

POSE_ATOL = 1e-4
POINT_ATOL = 1e-3
POINT_RTOL = 1e-3
ASSOC_FLIP = 0.005


def to_jax(t_ms):
    return jM.MapState(**{k: jnp.asarray(v) for k, v in tM.to_numpy(t_ms).items()})


def np_of(ms):
    return tM.to_numpy(ms) if isinstance(ms, tM.MapState) else {
        k: np.asarray(v) for k, v in ms._asdict().items()}


def assert_fields_equal(t_ms, j_ms, fields):
    tn, jn = np_of(t_ms), np_of(j_ms)
    for k in fields:
        np.testing.assert_array_equal(tn[k], jn[k], err_msg=k)


@pytest.fixture(scope="module")
def rounds():
    rounds, slam, _ = mapping_inputs(12)
    assert len(rounds) >= 3
    return rounds, slam


@pytest.fixture(scope="module")
def snapshot(rounds):
    """The last recorded round: (port map, JAX map, kf_id, kf_count)."""
    ms, kf_id, kf_count = rounds[0][-1]
    return ms, to_jax(ms), kf_id, kf_count


@pytest.fixture(scope="module")
def K():
    k = tiny_config().intrinsics()
    return k, jnp.asarray(k.numpy())


def clone(ms):
    return tM.MapState(*(x.clone() for x in ms))


def assert_untouched(ms, copy):
    for k, a, b in zip(tM.MapState._fields, ms, copy):
        assert torch.equal(a, b), k


def test_octave_inv_sigma2():
    o = np.arange(8, dtype=np.int32)
    np.testing.assert_allclose(tLM.octave_inv_sigma2(torch.from_numpy(o)).numpy(),
                               np.asarray(jLM.octave_inv_sigma2(jnp.asarray(o))), rtol=1e-6)


def test_triangulate_with_neighbor(snapshot, K):
    t_ms, j_ms, kf_id, _ = snapshot
    ids, valid = tM.local_window(t_ms, kf_id, window=5)
    n_total = 0
    for j in range(1, 5):
        if not bool(valid[j]):
            continue
        ref = int(ids[j])
        copy = clone(t_ms)
        out_t, n_t = tLM.triangulate_with_neighbor(t_ms, K[0], kf_id, ref)
        assert_untouched(t_ms, copy)
        out_j, n_j = jLM.triangulate_with_neighbor(j_ms, K[1], kf_id, ref)
        assert int(n_t) == int(n_j)
        assert_fields_equal(out_t, out_j, ("kf_point", "pt_valid", "n_pt", "pt_desc",
                                           "pt_ref_kf", "pt_octave", "pt_map_id"))
        np.testing.assert_allclose(out_t.pt_xyz.numpy(), np.asarray(out_j.pt_xyz), rtol=1e-5,
                                   atol=1e-5)
        n_total += int(n_t)
    assert n_total > 5


def test_fuse_with_neighbors(snapshot, K):
    t_ms, j_ms, kf_id, _ = snapshot
    copy = clone(t_ms)
    out_t, nf_t = tLM.fuse_with_neighbors(t_ms, K[0], kf_id, window=4, img_w=320, img_h=240)
    assert_untouched(t_ms, copy)
    out_j, nf_j = jLM.fuse_with_neighbors(j_ms, K[1], kf_id, window=4, img_w=320, img_h=240)
    assert int(nf_t) == int(nf_j)
    assert_fields_equal(out_t, out_j, ("kf_point", "pt_valid"))


def test_fuse_with_neighbors_merges_duplicates(snapshot, K):
    """Duplicate a KF's points into new slots observed by the next KF: the
    pass fuses them back, in both packages alike."""
    t_ms, _, kf_id, _ = snapshot
    prev = int(kf_id) - 1
    row = t_ms.kf_point[prev]
    has = row >= 0
    t_dup, ids = tM.add_points(t_ms, t_ms.pt_xyz[row.clamp_min(0).long()],
                               t_ms.pt_desc[row.clamp_min(0).long()], has, prev)
    t_dup = t_dup._replace(kf_point=tM.put_row(t_dup.kf_point, prev,
                                                torch.where(has, ids, row)))
    out_t, nf_t = tLM.fuse_with_neighbors(t_dup, K[0], kf_id, window=4, img_w=320, img_h=240)
    out_j, nf_j = jLM.fuse_with_neighbors(to_jax(t_dup), K[1], kf_id, window=4,
                                          img_w=320, img_h=240)
    assert int(nf_t) == int(nf_j) > int(tLM.fuse_with_neighbors(
        t_ms, K[0], kf_id, window=4, img_w=320, img_h=240)[1])
    assert_fields_equal(out_t, out_j, ("kf_point", "pt_valid"))
    kp = out_t.kf_point.numpy()
    assert out_t.pt_valid.numpy()[kp[kp >= 0]].all()


@pytest.mark.parametrize("fixed_ring", [0, 6])
def test_local_bundle_adjustment(snapshot, K, fixed_ring):
    t_ms, j_ms, kf_id, _ = snapshot
    copy = clone(t_ms)
    out_t = tLM.local_bundle_adjustment(t_ms, K[0], kf_id, window=5, n_iters=6,
                                        fixed_ring=fixed_ring)
    assert_untouched(t_ms, copy)
    out_j = jLM.local_bundle_adjustment(j_ms, K[1], kf_id, window=5, n_iters=6,
                                        fixed_ring=fixed_ring)
    np.testing.assert_allclose(out_t.kf_pose.numpy(), np.asarray(out_j.kf_pose), rtol=0,
                               atol=POSE_ATOL)
    v = t_ms.pt_valid.numpy()
    np.testing.assert_allclose(out_t.pt_xyz.numpy()[v], np.asarray(out_j.pt_xyz)[v],
                               rtol=POINT_RTOL, atol=POINT_ATOL)
    kp_t, kp_j = out_t.kf_point.numpy(), np.asarray(out_j.kf_point)
    assert (kp_t != kp_j).sum() <= ASSOC_FLIP * (kp_j >= 0).sum()
    assert not np.array_equal(out_t.kf_pose.numpy(), t_ms.kf_pose.numpy())


def test_cull_points(snapshot):
    t_ms, j_ms, _, _ = snapshot
    # make some points look poorly found
    vis = t_ms.pt_visible + 6.0 * (torch.arange(t_ms.max_pt) % 3 == 0)
    t_in = t_ms._replace(pt_visible=vis)
    out_t = tLM.cull_points(t_in)
    out_j = jLM.cull_points(j_ms._replace(pt_visible=jnp.asarray(vis.numpy())))
    assert_fields_equal(out_t, out_j, ("pt_valid", "kf_point"))
    assert (out_t.pt_valid != t_in.pt_valid).any()


@pytest.mark.parametrize("fn,kw", [("cull_keyframes", dict(redundancy=0.2, protect_recent=1)),
                                   ("evict_for_capacity", dict(protect_recent=1))])
def test_keyframe_culling_and_eviction(snapshot, fn, kw):
    t_ms, j_ms, kf_id, _ = snapshot
    copy = clone(t_ms)
    out_t = getattr(tLM, fn)(t_ms, int(kf_id), **kw)
    assert_untouched(t_ms, copy)
    out_j = getattr(jLM, fn)(j_ms, int(kf_id), **kw)
    assert_fields_equal(out_t, out_j, ("kf_valid", "kf_point"))
    assert (~out_t.kf_valid & t_ms.kf_valid).any()


# ------------------------------------------------------------- the mapping round

def jax_cfg():
    """``tiny_config()`` as it is: loop closing on, as in the port's."""
    return jax_tiny_config()


@pytest.mark.parametrize("which", [0, -1])
def test_run_mapping_round_matches_jax_and_keeps_its_snapshot(rounds, K, which):
    t_ms, kf_id, kf_count = rounds[0][which]
    copy = clone(t_ms)
    out_t = tMW.run_mapping_round(t_ms, K[0], tiny_config(), kf_id, use_stereo=False,
                                  draw=jax_draw(jax.random.PRNGKey(0)), kf_count=kf_count)
    assert_untouched(t_ms, copy)            # the snapshot is bit-unchanged
    assert out_t.snap is t_ms
    out_j = jMW.run_mapping_round(to_jax(t_ms), K[1], jax_cfg(), kf_id, use_stereo=False,
                                  key=jax.random.PRNGKey(0), kf_count=kf_count)
    assert out_t.events == out_j.events
    assert_fields_equal(out_t.mapped, out_j.mapped, ("n_pt", "pt_desc", "pt_ref_kf",
                                                     "pt_octave", "kf_valid"))
    tm, jm = np_of(out_t.mapped), np_of(out_j.mapped)
    np.testing.assert_allclose(tm["kf_pose"], jm["kf_pose"], rtol=0, atol=POSE_ATOL)
    assert (tm["kf_point"] != jm["kf_point"]).sum() <= ASSOC_FLIP * (jm["kf_point"] >= 0).sum()
    assert (tm["pt_valid"] != jm["pt_valid"]).sum() <= ASSOC_FLIP * jm["pt_valid"].sum()


def test_run_mapping_round_refuses_loop_closing(snapshot, K):
    """The round refused ``loop_closing=True`` while loop closing was not
    ported; now it runs the detection at the cadence, in both packages
    alike, and off the cadence or with loop closing off it does not."""
    t_ms, j_ms, kf_id, _ = snapshot
    cfg = tiny_config()
    assert cfg.mapping.loop_closing
    at = cfg.mapping.loop_check_interval * 3
    key = jax.random.PRNGKey(0)
    out_t = tMW.run_mapping_round(t_ms, K[0], cfg, kf_id, use_stereo=False,
                                  draw=jax_draw(key), kf_count=at)
    out_j = jMW.run_mapping_round(j_ms, K[1], jax_cfg(), kf_id, use_stereo=False, key=key,
                                  kf_count=at)
    assert "loop_best_score" in out_t.events and out_t.events == out_j.events
    off = dataclasses.replace(cfg, mapping=dataclasses.replace(cfg.mapping, loop_closing=False))
    for c, count in ((cfg, at + 1), (off, at)):
        out = tMW.run_mapping_round(t_ms, K[0], c, kf_id, use_stereo=False, draw=None,
                                    kf_count=count)
        assert "loop_best_score" not in out.events


def test_merge_mapping_result_three_way(snapshot):
    """Worker rows and point storage from the worker, appended rows and the
    counter increments from the tracker, in both packages alike."""
    snap, _, kf_id, _ = snapshot
    n = int(snap.n_kf)
    mapped = snap._replace(
        kf_pose=tM.put_row(snap.kf_pose, 1, snap.kf_pose[1] + 0.5),
        pt_valid=tM.put_row(snap.pt_valid, 2, False),
        pt_found=snap.pt_found + 2.0)
    mapped, _ = tM.add_points(mapped, torch.ones((2, 3)), torch.zeros((2, 8), dtype=torch.int32),
                              torch.ones(2, dtype=torch.bool), 1)
    cur = snap._replace(pt_visible=snap.pt_visible + 1.0)
    cur, kid = tM.insert_keyframe(cur, snap.kf_pose[0], _feats_of(snap, 0), 9.0,
                                  snap.kf_point[0])
    out_t = tMW.merge_mapping_result(cur, snap, mapped)
    out_j = jMW.merge_mapping_result(to_jax(cur), to_jax(snap), to_jax(mapped))
    assert_fields_equal(out_t, out_j, tM.MapState._fields)
    assert int(kid) == n and bool(out_t.kf_valid[n])
    assert float(out_t.kf_pose[1, 0]) == float(snap.kf_pose[1, 0]) + 0.5
    assert int(out_t.n_pt) == int(mapped.n_pt)


def _feats_of(ms, k):
    from rumi_slam_tpu_torch.ops.orb import Features

    return Features(uv=ms.kf_uv[k], response=torch.ones(ms.max_feat), angle=ms.kf_angle[k],
                    octave=ms.kf_octave[k], desc=ms.kf_desc[k], valid=ms.kf_feat_valid[k])


# ------------------------------------------------------------- the worker thread

def test_worker_runs_round_and_error_surfaces(rounds, K, monkeypatch):
    """A round on the worker equals the inline round; a failing round
    re-raises on the tracker side at flush, and the same thread then takes
    the next task."""
    t_ms, kf_id, kf_count = rounds[0][-1]
    cfg = tiny_config()
    worker = tMW.MappingWorker(cfg, K[0])
    try:
        assert worker.idle()
        assert worker.submit(t_ms, kf_id, use_stereo=False, draw=None, kf_count=kf_count)
        assert not worker.submit(t_ms, kf_id, use_stereo=False, draw=None, kf_count=kf_count)
        out = worker.flush(timeout=120.0)
        inline = tMW.run_mapping_round(t_ms, K[0], cfg, kf_id, use_stereo=False, draw=None,
                                       kf_count=kf_count)
        for k, a, b in zip(tM.MapState._fields, out.mapped, inline.mapped):
            assert torch.equal(a, b), k
        assert worker.idle() and worker.poll() is None

        real = tMW.run_mapping_round
        calls = {"n": 0}

        def boom(*a, **kw):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("injected mapping failure")
            return real(*a, **kw)

        monkeypatch.setattr(tMW, "run_mapping_round", boom)
        assert worker.submit(t_ms, kf_id, use_stereo=False, draw=None, kf_count=kf_count)
        with pytest.raises(RuntimeError, match="mapping worker round"):
            worker.flush(timeout=120.0)
        assert worker.idle()
        assert worker.submit(t_ms, kf_id, use_stereo=False, draw=None, kf_count=kf_count)
        deadline = time.monotonic() + 120.0
        out = None
        while out is None and time.monotonic() < deadline:
            out = worker.poll()
            time.sleep(0.01)
        assert out is not None and calls["n"] == 2
    finally:
        worker.shutdown()


def test_capacity_eviction_and_compaction_keep_tracking():
    """A run that asks for far more keyframes than ``max_kf`` (10) holds:
    the facade evicts, culls and compacts (remapping the new keyframe's
    point ids through ``pt_map``) and keeps tracking.  The JAX package on
    the same drive: 29 of 30 frames OK, 24 keyframes asked for, 11 full
    events, 5 compactions; the port: 29, 22, 12, 4."""
    from rumi_slam_tpu_torch.io.synthetic import SyntheticSequence
    from rumi_slam_tpu_torch.system import SlamSystem

    cfg = tiny_config()
    cfg = dataclasses.replace(
        cfg, mapping=dataclasses.replace(cfg.mapping, max_kf=10, max_pt=1024, kf_culling=True),
        tracking=dataclasses.replace(cfg.tracking, kf_min_interval=1, kf_tracked_ratio=1.1))
    seq = SyntheticSequence(n_frames=30, width=320, height=240, n_points=1500, seed=4, patch=3)
    slam = SlamSystem(cfg, device="cpu")
    ok = sum(slam.track_monocular(*seq.frame(i)).name == "OK" for i in range(len(seq)))
    ms = slam.ms
    assert ok >= 27
    assert slam.stats["n_kf"] > 10 and slam.stats["kf_full"] >= 1
    assert slam.stats["n_compactions"] >= 1
    assert int(ms.n_kf) <= 10 and int(ms.n_pt) <= 1024
    kp = ms.kf_point[ms.kf_valid]
    assert int(kp.max()) < int(ms.n_pt)           # no reference past the live prefix
    assert 0 <= slam.last_kf_id < int(ms.n_kf) and bool(ms.kf_valid[slam.last_kf_id])
