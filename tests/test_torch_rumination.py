"""Parity of the port's rumination pipeline with the JAX package, function by
function: bulk keyframe import and relabelling, the sweep trajectory, LK
optical flow, the lost-frame sampler and bundle assembler, the CloudMap, the
Sim(3) merge, the coordinator's import, and the asynchronous shard.

Same numpy inputs from a seed go through both.  Tolerances: index and mask
outputs exact; LK flow 0.05 px; Sim(3) solves, welding BA and the full merge
1e-3 (float32 LM iterations over sums taken in another order).  RANSAC
draws: the port is handed the JAX package's own index sets
(``torch_system_drive.jax_draw``).

The end-to-end scenario is in ``tests/test_torch_rumination_e2e.py``.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rumi_slam_tpu.config import MergeConfig as jMergeConfig
from rumi_slam_tpu.config import SamplerConfig as jSamplerConfig
from rumi_slam_tpu.io import synthetic as jsyn
from rumi_slam_tpu.mapstate import map_state as jM
from rumi_slam_tpu.ops import optical_flow as jOF
from rumi_slam_tpu.rumination import cloud_map as jCM
from rumi_slam_tpu.rumination import coordinator as jCo
from rumi_slam_tpu.rumination import merge as jMg
from rumi_slam_tpu.rumination import sampler as jSa
from rumi_slam_tpu.rumination.backend import RuminationBackend as jBackend
from rumi_slam_tpu_torch.config import MergeConfig, SamplerConfig, tiny_config
from rumi_slam_tpu_torch.io import synthetic as tsyn
from rumi_slam_tpu_torch.mapstate import map_state as tM
from rumi_slam_tpu_torch.ops import optical_flow as tOF
from rumi_slam_tpu_torch.rumination import cloud_map as tCM
from rumi_slam_tpu_torch.rumination import coordinator as tCo
from rumi_slam_tpu_torch.rumination import merge as tMg
from rumi_slam_tpu_torch.rumination import remote as tRe
from rumi_slam_tpu_torch.rumination import sampler as tSa
from rumi_slam_tpu_torch.rumination.backend import RuminationBackend
from rumi_slam_tpu_torch.system import SlamSystem

from test_optical_flow import _textured
from test_rumination import K as jK
from test_rumination import build_two_submaps
from torch_system_drive import jax_draw

torch.set_num_threads(1)

SOLVE_ATOL = 1e-3
tK = torch.tensor(np.asarray(jK))


def T(x):
    return torch.from_numpy(np.array(x))


def to_jax(t_ms):
    return jM.MapState(**{k: jnp.asarray(v) for k, v in tM.to_numpy(t_ms).items()})


def to_torch(j_ms):
    return tM.from_numpy({k: np.asarray(v) for k, v in j_ms._asdict().items()}, device="cpu")


def assert_maps(t_ms, j_ms, *, exact=None, close=(), atol=SOLVE_ATOL):
    tn = tM.to_numpy(t_ms)
    jn = {k: np.asarray(v) for k, v in j_ms._asdict().items()}
    for k in (tM.MapState._fields if exact is None else exact):
        if k not in close:
            np.testing.assert_array_equal(tn[k], jn[k], err_msg=k)
    for k in close:
        np.testing.assert_allclose(tn[k], jn[k], atol=atol, err_msg=k)


# ---------------------------------------------------------------------------
# map state
# ---------------------------------------------------------------------------

def _bulk_rows(rng, Mk, F, P):
    poses = rng.normal(size=(Mk, 7)).astype(np.float32)
    return dict(
        poses=poses, uv=rng.uniform(0, 300, (Mk, F, 2)).astype(np.float32),
        octave=rng.integers(0, 3, (Mk, F)).astype(np.int32),
        angle=rng.normal(size=(Mk, F)).astype(np.float32),
        desc=rng.integers(0, 2**32, (Mk, F, 8), dtype=np.uint32),
        feat_valid=rng.uniform(size=(Mk, F)) > 0.3,
        point_assoc=rng.integers(-1, P, (Mk, F)).astype(np.int32),
        times=rng.uniform(0, 9, Mk).astype(np.float32))


@pytest.mark.parametrize("case", ["invalid_rows_in_the_middle", "overflow_past_max_kf",
                                  "nothing_valid"])
def test_add_keyframes_bulk(case):
    rng = np.random.default_rng(8)
    K, F, P, Mk = 10, 12, 50, 7
    j_ms, _, _ = build_two_submaps(F=F, n_shared_kf=2)       # 4 keyframes to start from
    j_ms = jM.MapState(**{k: (v[:K] if k.startswith("kf_") else v)
                          for k, v in j_ms._asdict().items()})
    t_ms = to_torch(j_ms)
    rows = _bulk_rows(rng, Mk, F, P)
    valid = {"invalid_rows_in_the_middle": np.array([1, 0, 1, 1, 0, 0, 1], bool),
             "overflow_past_max_kf": np.ones(Mk, bool),          # 4 + 7 > 10
             "nothing_valid": np.zeros(Mk, bool)}[case]
    out_j, ids_j = jM.add_keyframes_bulk(
        j_ms, *(jnp.asarray(rows[k]) for k in rows), jnp.asarray(valid), map_id=3)
    t_rows = {k: T(v.view(np.int32) if v.dtype == np.uint32 else v) for k, v in rows.items()}
    out_t, ids_t = tM.add_keyframes_bulk(t_ms, *t_rows.values(), T(valid), map_id=3)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    assert_maps(out_t, out_j)
    assert ids_t.dtype == torch.int32
    if case == "overflow_past_max_kf":
        assert int(out_t.n_kf) == K and int((ids_t >= 0).sum()) == K - 4
    # the input map is untouched
    assert_maps(t_ms, j_ms)


def test_relabel_map():
    j_ms, _, _ = build_two_submaps()
    t_ms = to_torch(j_ms)
    assert_maps(tM.relabel_map(t_ms, 1, 0), jM.relabel_map(j_ms, 1, 0))
    assert int(tM.map_kf_count(tM.relabel_map(t_ms, 1, 0), 1)) == 0


# ---------------------------------------------------------------------------
# synthetic sweep
# ---------------------------------------------------------------------------

def test_sweep_sequence():
    kw = dict(n_frames=12, width=160, height=120, n_points=400, seed=11, patch=4,
              lost_span=(5, 7), trajectory="sweep")
    sj, st = jsyn.SyntheticSequence(**kw), tsyn.SyntheticSequence(**kw)
    np.testing.assert_allclose(torch.stack(st.poses_gt).numpy(),
                               np.stack([np.asarray(p) for p in sj.poses_gt]), atol=1e-6)
    np.testing.assert_array_equal(st.times, sj.times)
    for i in (0, 5, 11):
        a, b = st.frame(i)[0].numpy(), np.asarray(sj.frame(i)[0])
        assert np.mean(a != b) < 1e-3        # a splat on a rounding edge may move a pixel
    assert float(st.frame(5)[0].std()) == 0.0


# ---------------------------------------------------------------------------
# optical flow
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shift", [(3, 2), (-4, 1), (6, -5)])
def test_lk_flow(shift):
    """The shifts of ``tests/test_optical_flow.py``; flow within 0.05 px of
    the JAX package's, the same ``ok`` mask, and the shift recovered."""
    dx, dy = shift
    img = _textured()
    cur = np.roll(np.roll(img, dy, axis=0), dx, axis=1)
    rng = np.random.default_rng(1)
    pts = rng.uniform([20, 20], [140, 100], size=(40, 2)).astype(np.float32)
    pts[:3] = [[1.5, 2.0], [158.0, 118.5], [0.0, 60.0]]      # at the border
    valid = np.ones(40, bool)
    f_j, ok_j = jOF.lk_flow(jnp.asarray(img), jnp.asarray(cur), jnp.asarray(pts),
                            jnp.asarray(valid))
    f_t, ok_t = tOF.lk_flow(T(img), T(cur), T(pts), T(valid))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), atol=0.05)
    med = np.median(f_t.numpy()[ok_t.numpy()][3:], axis=0)
    np.testing.assert_allclose(med, [dx, dy], atol=0.7)


def test_mean_flow_magnitude_and_gradient():
    img = _textured(seed=2)
    cur = np.roll(img, 5, axis=1)
    rng = np.random.default_rng(3)
    pts = rng.uniform([20, 20], [140, 100], (40, 2)).astype(np.float32)
    ones = np.ones(40, bool)
    m_j = float(jOF.mean_flow_magnitude(jnp.asarray(img), jnp.asarray(cur), jnp.asarray(pts),
                                        jnp.asarray(ones)))
    m_t = float(tOF.mean_flow_magnitude(T(img), T(cur), T(pts), T(ones)))
    assert abs(m_t - m_j) < 0.05 and 3.0 < m_t < 7.0
    gx_j, gy_j = jOF._gradients(jnp.asarray(img))
    gx_t, gy_t = tOF._gradients(T(img))
    np.testing.assert_allclose(gx_t.numpy(), np.asarray(gx_j), atol=1e-4)
    np.testing.assert_allclose(gy_t.numpy(), np.asarray(gy_j), atol=1e-4)


# ---------------------------------------------------------------------------
# sampler
# ---------------------------------------------------------------------------

def test_lost_frame_sampler_selects_the_same_times():
    """20 frames of a synthetic sweep fed to both samplers: the same raw list,
    the same PD-selected times, the same thresholds."""
    seq = tsyn.SyntheticSequence(n_frames=20, width=320, height=240, n_points=1200, seed=11,
                                 patch=4, trajectory="sweep")
    cfg = dict(pd_setpoint=1.5, pd_kp=0.8, pd_kd=0.08)
    s_j, s_t = jSa.LostFrameSampler(jSamplerConfig(**cfg)), tSa.LostFrameSampler(SamplerConfig(**cfg))
    thresholds = []
    for i in range(20):
        img, t = seq.frame(i)
        s_j.record(jnp.asarray(img.numpy()), t)
        s_t.record(img, t)
        thresholds.append((s_j._thresh, s_t._thresh))
    assert [f.time for f in s_t.all_frames] == [f.time for f in s_j.all_frames]
    assert [f.time for f in s_t.sampled] == [f.time for f in s_j.sampled]
    assert 2 <= len(s_t.sampled) < 20
    np.testing.assert_allclose([a for a, _ in thresholds], [b for _, b in thresholds], atol=0.05)
    assert isinstance(s_t.sampled[0].image, np.ndarray)
    np.testing.assert_array_equal(s_t.sampled[-1].image, s_j.sampled[-1].image)
    s_t.reset()
    assert not s_t.all_frames and not s_t.sampled and s_t._last_img is None


def test_sampler_reseeds_from_gradients_on_a_degraded_frame():
    """A blurred, low-contrast frame has no FAST corners: both packages seed
    the LK points from gradient energy, and pick the same ones."""
    from scipy import ndimage

    img = ndimage.gaussian_filter(_textured(240, 320, seed=5), 4.0)
    img = (100.0 + 0.2 * (img - img.mean())).astype(np.float32)
    p_j, v_j = jSa.LostFrameSampler(jSamplerConfig())._reseed_points(jnp.asarray(img))
    p_t, v_t = tSa.LostFrameSampler(SamplerConfig())._reseed_points(T(img))
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))
    assert int(v_t.sum()) >= 20


def test_bundle_assembler_and_pd_controller():
    cfg = dict(n_track_last=5, n_new_track_first=5, min_bundle=8)
    a_j, a_t = jSa.BundleAssembler(jSamplerConfig(**cfg)), tSa.BundleAssembler(SamplerConfig(**cfg))

    def frames(mod, ts):
        return [mod.RecordedFrame(float(t), np.zeros((4, 4))) for t in ts]

    front, back = list(range(10)), [10.0 + t for t in range(6)]
    lost = [9.5 + 0.1 * i for i in range(5)] + [3.0, 12.5, 9.5]   # outside the gap, repeated
    b_j = a_j.assemble(frames(jSa, front), frames(jSa, lost), frames(jSa, back))
    b_t = a_t.assemble(frames(tSa, front), frames(tSa, lost), frames(tSa, back))
    assert [f.time for f in b_t] == [f.time for f in b_j]
    assert b_t[0].time == 5.0 and len(b_t) == 15
    assert a_t.assemble(frames(tSa, front), [], frames(tSa, back)) is None
    assert a_t.combine(frames(tSa, [0, 1]), frames(tSa, [1.5]), frames(tSa, [2])) is None
    assert a_t.gates_pass(5, 5.0, 1.0) is True and a_j.gates_pass(5, 5.0, 1.0) is True
    assert a_t.gates_pass(4, 5.0, 1.0) is False and a_j.gates_pass(4, 5.0, 1.0) is False
    assert a_t.gates_pass(5, 1.0, 1.0) is False and a_j.gates_pass(5, 1.0, 1.0) is False
    pd_j, pd_t = jSa.PDController(0.8, 0.08, 12.0), tSa.PDController(0.8, 0.08, 12.0)
    for x in (30.0, 2.0, 11.0):
        assert pd_t.step(x) == pd_j.step(x)


# ---------------------------------------------------------------------------
# cloud map
# ---------------------------------------------------------------------------

def _cloud(j_ms, map_id=1):
    cm_j = jCM.from_map_state(j_ms, map_id)
    cm_t = tCM.from_map_state(to_torch(j_ms), map_id)
    return cm_j, cm_t


def assert_cloud(cm_t, cm_j):
    for name, a, b in zip(cm_t._fields, cm_t, cm_j):
        assert (a is None) == (b is None), name
        if a is not None:
            a = a.numpy()
            np.testing.assert_array_equal(a.view(np.uint32) if name == "kf_desc" else a,
                                          np.asarray(b), err_msg=name)


def test_cloud_map_export_and_strip():
    j_ms, _, _ = build_two_submaps()
    cm_j, cm_t = _cloud(j_ms)
    assert_cloud(cm_t, cm_j)
    assert_cloud(tCM.strip_descriptors(cm_t), jCM.strip_descriptors(cm_j))
    assert int(cm_t.kf_valid.sum()) == 4 and int(cm_t.pt_valid.sum()) == 96


def test_reduce_feature_capacity_512_to_256():
    rng = np.random.default_rng(12)
    j_ms, _, _ = build_two_submaps(F=512, n_shared_kf=2)
    # knock out associations and features so that all three priorities occur
    j_ms = j_ms._replace(
        kf_point=jnp.where(jnp.asarray(rng.uniform(size=j_ms.kf_point.shape) > 0.35),
                           j_ms.kf_point, -1),
        kf_feat_valid=j_ms.kf_feat_valid & jnp.asarray(rng.uniform(size=j_ms.kf_point.shape) > 0.2))
    cm_j, cm_t = _cloud(j_ms)
    r_j, r_t = jCM.reduce_feature_capacity(cm_j, 256), tCM.reduce_feature_capacity(cm_t, 256)
    assert r_t.kf_uv.shape[1] == 256 and r_t.kf_desc.shape[1:] == (256, 8)
    assert_cloud(r_t, r_j)
    assert tCM.reduce_feature_capacity(cm_t, 512) is cm_t


def test_insert_cloud_map():
    """A CloudMap with more feature slots than the map (128 -> 96) and with
    its descriptors stripped comes in as submap 2 in both packages alike."""
    j_src, _, _ = build_two_submaps(F=128, n_shared_kf=3)
    cm_j, cm_t = _cloud(j_src)
    j_ms, _, _ = build_two_submaps(F=96, n_shared_kf=2)
    t_ms = to_torch(j_ms)
    for strip in (False, True):
        cj = jCM.strip_descriptors(cm_j) if strip else cm_j
        ct = tCM.strip_descriptors(cm_t) if strip else cm_t
        out_j, ids_j = jCo.insert_cloud_map(j_ms, cj, 2)
        out_t, ids_t = tCo.insert_cloud_map(t_ms, ct, 2)
        np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
        assert_maps(out_t, out_j)
        assert int(tM.map_kf_count(out_t, 2)) == 3 and bool(out_t.kf_is_cloud[ids_t[ids_t >= 0].long()].all())


# ---------------------------------------------------------------------------
# merge
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def submaps():
    j_ms, S_true, _ = build_two_submaps()
    # one feature without a point and one dead feature per keyframe
    j_ms = j_ms._replace(kf_point=j_ms.kf_point.at[:, 5].set(-1),
                         kf_feat_valid=j_ms.kf_feat_valid.at[:, 9].set(False))
    t_ms = to_torch(j_ms)
    m_j = jMg.match_kfs_by_time(j_ms.kf_time, j_ms.kf_valid, j_ms.kf_map_id, 0, 1, max_pairs=8)
    m_t = tMg.match_kfs_by_time(t_ms.kf_time, t_ms.kf_valid, t_ms.kf_map_id, 0, 1, max_pairs=8)
    p_j = jMg.associate_points(j_ms, m_j, radius=3.0)
    p_t = tMg.associate_points(t_ms, m_t, radius=3.0)
    return j_ms, t_ms, m_j, m_t, p_j, p_t


def assert_tuple_equal(t, j):
    for name, a, b in zip(t._fields, t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


def test_match_kfs_by_time(submaps):
    j_ms, t_ms, m_j, m_t, _, _ = submaps
    assert_tuple_equal(m_t, m_j)
    assert int(m_t.valid.sum()) == 4 and m_t.dst_kf.dtype == torch.int32
    m_j2 = jMg.match_kfs_by_time(j_ms.kf_time, j_ms.kf_valid, j_ms.kf_map_id, 0, 1, max_pairs=3)
    m_t2 = tMg.match_kfs_by_time(t_ms.kf_time, t_ms.kf_valid, t_ms.kf_map_id, 0, 1, max_pairs=3)
    assert_tuple_equal(m_t2, m_j2)          # the cut keeps the most recent pairs


def test_associate_points(submaps):
    _, _, _, _, p_j, p_t = submaps
    assert_tuple_equal(p_t, p_j)
    assert int(p_t.valid.sum()) > 100


def test_compute_submap_sim3_from_jax_triples(submaps):
    j_ms, t_ms, m_j, m_t, p_j, p_t = submaps
    key = jax.random.PRNGKey(0)
    S_j, r_j, inl_j = jMg.compute_submap_sim3(key, jK, j_ms, m_j, p_j)
    taken = []
    base = jax_draw(key)

    def draw(logits, shape):
        taken.append(base(logits, shape))
        return taken[-1]

    S_t, r_t, inl_t = tMg.compute_submap_sim3(draw, tK, t_ms, m_t, p_t)
    np.testing.assert_allclose(S_t.numpy(), np.asarray(S_j), atol=SOLVE_ATOL)
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    assert abs(float(r_t) - float(r_j)) < 1e-6 and float(r_t) > 0.8
    assert abs(float(torch.exp(S_t[7])) - 1.4) < 0.02
    S_t2, _, _ = tMg.compute_submap_sim3_from(taken[0], tK, t_ms, m_t, p_t)
    assert taken[0].shape == (64, 3) and torch.equal(S_t, S_t2)


def test_transform_submap_and_correct_pose(submaps):
    j_ms, t_ms, *_ = submaps
    S = np.asarray(jMg.lie.sim3_exp(jnp.asarray([0.1, -0.2, 0.05, 0.3, -0.1, 0.2, 0.25])))
    out_j, out_t = jMg.transform_submap(j_ms, 1, jnp.asarray(S)), tMg.transform_submap(t_ms, 1, T(S))
    assert_maps(out_t, out_j, close=("kf_pose", "pt_xyz"), atol=1e-5)
    np.testing.assert_array_equal(out_t.kf_pose[0].numpy(), t_ms.kf_pose[0].numpy())
    p_j = np.asarray(jCo.correct_pose(j_ms.kf_pose[3], jnp.asarray(S)))
    np.testing.assert_allclose(tCo.correct_pose(t_ms.kf_pose[3], T(S)).numpy(), p_j, atol=1e-6)


def test_fuse_points(submaps):
    j_ms, t_ms, _, _, p_j, p_t = submaps
    rng = np.random.default_rng(2)
    inl = rng.uniform(size=p_t.valid.shape[0]) > 0.3
    assert_maps(tMg.fuse_points(t_ms, p_t, T(inl)), jMg.fuse_points(j_ms, p_j, jnp.asarray(inl)))


@pytest.mark.parametrize("w,covis", [(16, 0), (16, 5), (4, 3)])
def test_welding_window(submaps, w, covis):
    j_ms, t_ms, m_j, m_t, _, _ = submaps
    ids_j, v_j = jMg._welding_window(m_j, w, j_ms, covis)
    ids_t, v_t = tMg._welding_window(m_t, w, t_ms, covis)
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))


def test_welding_ba(submaps):
    j_ms, t_ms, m_j, m_t, p_j, p_t = submaps
    rng = np.random.default_rng(4)
    S, _, inl = jMg.compute_submap_sim3(jax.random.PRNGKey(0), jK, j_ms, m_j, p_j)
    j_in = jM.relabel_map(jMg.fuse_points(jMg.transform_submap(j_ms, 1, S), p_j, inl), 1, 0)
    j_in = j_in._replace(pt_xyz=j_in.pt_xyz + jnp.asarray(
        rng.normal(scale=0.01, size=j_in.pt_xyz.shape), jnp.float32))
    t_in = to_torch(j_in)
    out_j = jMg.welding_ba(j_in, jK, m_j, covis=5)
    out_t = tMg.welding_ba(t_in, tK, m_t, covis=5)
    assert_maps(out_t, out_j, close=("kf_pose", "pt_xyz"))
    assert float(np.abs(out_t.pt_xyz.numpy() - t_in.pt_xyz.numpy()).max()) > 1e-3


def test_merge_submaps(submaps):
    j_ms, t_ms, *_ = submaps
    key = jax.random.PRNGKey(1)
    out_j, ok_j, i_j = jMg.merge_submaps(j_ms, jK, 1, 0, jMergeConfig(max_match_kf=8), key)
    out_t, ok_t, i_t = tMg.merge_submaps(t_ms, tK, 1, 0, MergeConfig(max_match_kf=8),
                                         jax_draw(key))
    assert ok_t and ok_j
    assert i_t["n_kf_matches"] == i_j["n_kf_matches"] and i_t["n_pt_pairs"] == i_j["n_pt_pairs"]
    assert abs(i_t["inlier_ratio"] - i_j["inlier_ratio"]) < 1e-6
    assert abs(i_t["scale"] - i_j["scale"]) < SOLVE_ATOL and abs(i_t["scale"] - 1.4) < 0.02
    assert_maps(out_t, out_j, close=("kf_pose", "pt_xyz"))
    assert int(tM.map_kf_count(out_t, 1)) == 0 and int(tM.map_kf_count(out_t, 0)) == 8
    assert int(out_t.pt_valid.sum()) < int(t_ms.pt_valid.sum())


def test_merge_rejects_garbage_as_jax_does(submaps):
    j_ms, t_ms, *_ = submaps
    rng = np.random.default_rng(9)
    junk = rng.uniform(-20, 20, t_ms.pt_xyz.shape).astype(np.float32)
    j_bad = j_ms._replace(pt_xyz=jnp.where((j_ms.pt_map_id == 1)[:, None], jnp.asarray(junk),
                                           j_ms.pt_xyz))
    t_bad = to_torch(j_bad)
    key = jax.random.PRNGKey(2)
    out_j, ok_j, i_j = jMg.merge_submaps(j_bad, jK, 1, 0, jMergeConfig(max_match_kf=8), key)
    out_t, ok_t, i_t = tMg.merge_submaps(t_bad, tK, 1, 0, MergeConfig(max_match_kf=8),
                                         jax_draw(key))
    assert not ok_t and not ok_j
    assert i_t["reason"] == i_j["reason"] == "low_inliers"
    assert out_t is t_bad                                   # untouched on failure
    # no keyframe of the source map at all: the other early exit
    _, ok, info = tMg.merge_submaps(t_bad, tK, 5, 0, MergeConfig(max_match_kf=8), None)
    assert not ok and info["reason"] == "no_kf_matches"


# ---------------------------------------------------------------------------
# backend, coordinator, shard
# ---------------------------------------------------------------------------

def test_backend_normalize():
    img = _textured(120, 160, seed=7)
    out_j = jBackend._normalize(img)
    out_t = RuminationBackend._normalize(img).numpy()
    np.testing.assert_allclose(out_t, out_j, atol=2e-3)
    flat = np.full((24, 32), 40.0, np.float32)
    np.testing.assert_array_equal(RuminationBackend._normalize(flat).numpy(), flat)


def test_backend_config_budgets():
    import dataclasses

    from rumi_slam_tpu import config as jconfig
    from rumi_slam_tpu_torch.config import Config

    b = RuminationBackend(tiny_config(), device="cpu")
    j = jBackend(jconfig.tiny_config())
    assert dataclasses.asdict(b.cfg) == dataclasses.asdict(j.cfg)
    # the default configuration maps on a worker thread; the port's offline
    # system maps inline (on the thread and CUDA stream of ``build``'s caller),
    # and that is the only field in which the two differ
    b, j = dataclasses.asdict(RuminationBackend(Config(), device="cpu").cfg), \
        dataclasses.asdict(jBackend(jconfig.Config()).cfg)
    assert j["mapping"].pop("overlapped") is True and b["mapping"].pop("overlapped") is False
    assert b == j


def _submaps_seen_once():
    """``build_two_submaps`` with every point observed by one keyframe of its
    map only (keyframe pair ``k`` keeps features ``f % 4 == k``).  All four
    keyframes of a map carry the same descriptors, so a query against the full
    bank finds its best and second-best at distance 0 and fails the ratio test;
    with one observation per point the bank is unambiguous."""
    j_ms, _, _ = build_two_submaps()
    F = j_ms.kf_point.shape[1]
    keep = (jnp.arange(F)[None, :] % 4) == (jnp.arange(j_ms.kf_point.shape[0])[:, None] // 2)
    return j_ms._replace(kf_point=jnp.where(keep, j_ms.kf_point, -1))


@pytest.mark.parametrize("dst,src", [(0, 1), (1, 0)])
def test_weld_submaps(monkeypatch, dst, src):
    """``_weld_submaps`` on the two submaps of ``build_two_submaps`` (map 1 is
    map 0 moved by a Sim(3) of scale 1.4), with JAX's draws
    (``PRNGKey(1000 + rank)``) injected: the same tries with the same inlier
    counts, the same anchors, scale within 1e-3 and the welded map within 1e-3;
    one map is left and the known scale is recovered within 0.02."""
    from types import SimpleNamespace

    j_ms = _submaps_seen_once()
    t_ms = to_torch(j_ms)
    jb = jBackend(__import__("rumi_slam_tpu.config", fromlist=["tiny_config"]).tiny_config())
    tb = RuminationBackend(tiny_config(), device="cpu")
    monkeypatch.setattr(RuminationBackend, "_weld_draw", staticmethod(
        lambda rank: jax_draw(jax.random.PRNGKey(1000 + rank))))
    out_j = jb._weld_submaps(SimpleNamespace(ms=j_ms, K=jK), dst, src)
    out_t = tb._weld_submaps(SimpleNamespace(ms=t_ms, K=tK), dst, src)
    assert out_j is not None and out_t is not None
    assert tb.last_weld_tries["dst"] == dst and tb.last_weld_tries["src"] == src
    assert tb.last_weld_tries["pnp"] == [tuple(x) for x in jb.last_weld_tries["pnp"]]
    assert len(tb.last_weld_tries["pnp"]) == 4
    wi_t, wi_j = tb.last_weld_info, jb.last_weld_info
    assert wi_t["n_anchors"] == wi_j["n_anchors"] == 4
    assert wi_t["anchor_inliers"] == wi_j["anchor_inliers"]
    assert abs(wi_t["scale"] - wi_j["scale"]) < SOLVE_ATOL
    assert abs(wi_t["scale_ratio_spread"] - wi_j["scale_ratio_spread"]) < SOLVE_ATOL
    assert abs(wi_t["scale"] - (1.4 if dst == 0 else 1 / 1.4)) < 0.02
    assert_maps(out_t, out_j, close=("kf_pose", "pt_xyz"))
    assert int(tM.map_kf_count(out_t, src)) == 0 and int(tM.map_kf_count(out_t, dst)) == 8
    # the welded keyframe pairs at equal times coincide
    pose = out_t.kf_pose.numpy()
    t = out_t.kf_time.numpy()
    for a in range(8):
        for b in range(a + 1, 8):
            if t[a] == t[b]:
                np.testing.assert_allclose(pose[a], pose[b], atol=0.02)


def test_weld_submaps_needs_two_anchors(monkeypatch):
    """Junk points in the target map: every try stays under ``min_inliers`` and
    the weld gives up, in both packages, with the tries recorded."""
    from types import SimpleNamespace

    j_ms = _submaps_seen_once()
    junk = np.random.default_rng(3).uniform(-20, 20, j_ms.pt_xyz.shape).astype(np.float32)
    j_ms = j_ms._replace(pt_xyz=jnp.where((j_ms.pt_map_id == 0)[:, None], jnp.asarray(junk),
                                          j_ms.pt_xyz))
    jb = jBackend(__import__("rumi_slam_tpu.config", fromlist=["tiny_config"]).tiny_config())
    tb = RuminationBackend(tiny_config(), device="cpu")
    monkeypatch.setattr(RuminationBackend, "_weld_draw", staticmethod(
        lambda rank: jax_draw(jax.random.PRNGKey(1000 + rank))))
    assert jb._weld_submaps(SimpleNamespace(ms=j_ms, K=jK), 0, 1) is None
    assert tb._weld_submaps(SimpleNamespace(ms=to_torch(j_ms), K=tK), 0, 1) is None
    assert tb.last_weld_info is None and len(tb.last_weld_tries["pnp"]) == 4
    assert [t for t, _ in tb.last_weld_tries["pnp"]] == [t for t, _ in jb.last_weld_tries["pnp"]]
    assert max(n for _, n in tb.last_weld_tries["pnp"]) < 10
    assert max(n for _, n in jb.last_weld_tries["pnp"]) < 10


class StubBackend:
    """The stub of ``tests/test_async_rumination.py`` on torch tensors."""

    def __init__(self, delay=0.05, fail=False, crash=False):
        self.delay, self.fail, self.crash, self.calls = delay, fail, crash, 0
        self.last_weld_info = None

    def build(self, bundle, anchor_times=(), anchor_split=None):
        self.calls += 1
        time.sleep(self.delay)
        if self.crash:
            raise ValueError("backend crashed")
        if self.fail:
            return None
        n_kf, n_feat, n_pt = 4, 8, 16
        pose = torch.zeros((n_kf, 7))
        pose[:, 0] = 1.0
        return tCM.CloudMap(
            kf_pose=pose, kf_uv=torch.zeros((n_kf, n_feat, 2)),
            kf_octave=torch.zeros((n_kf, n_feat), dtype=torch.int32),
            kf_feat_valid=torch.ones((n_kf, n_feat), dtype=torch.bool),
            kf_point=torch.full((n_kf, n_feat), -1, dtype=torch.int32),
            kf_time=torch.arange(n_kf, dtype=torch.float32),
            kf_valid=torch.ones(n_kf, dtype=torch.bool),
            pt_xyz=torch.zeros((n_pt, 3)), pt_valid=torch.ones(n_pt, dtype=torch.bool))


def _bundle(n=5):
    return [tSa.RecordedFrame(float(i), np.zeros((8, 8), np.float32)) for i in range(n)]


def _wait(shard, timeout=10):
    deadline = time.time() + timeout
    got = None
    while got is None and time.time() < deadline:
        got = shard.poll()
        time.sleep(0.01)
    return got


def test_async_shard_roundtrip_and_overlap_refusal():
    shard = tRe.AsyncRuminationShard(tiny_config(), device="cpu", backend=StubBackend(delay=0.2))
    try:
        assert shard.submit(7, _bundle())
        assert not shard.submit(8, _bundle())          # saturated
        job, cm = _wait(shard)
        assert job == 7 and int(cm.kf_valid.sum()) == 4
        assert not shard.busy and shard.last_error is None
        assert shard.submit(9, _bundle())              # free again
        assert _wait(shard)[0] == 9
    finally:
        shard.shutdown()


@pytest.mark.parametrize("how", ["fail", "crash"])
def test_async_shard_reports_failure(how):
    """A build that returns None and a build that raises both reach the
    coordinator as a failed build; the exception is kept on the shard."""
    shard = tRe.AsyncRuminationShard(tiny_config(), device="cpu",
                                     backend=StubBackend(**{how: True}))
    try:
        assert shard.submit(9, _bundle())
        assert _wait(shard) == (9, None)
        if how == "crash":
            assert isinstance(shard.last_error, ValueError)
        else:
            assert shard.last_error is None
    finally:
        shard.shutdown()


def test_async_shard_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tRe.AsyncRuminationShard(tiny_config())
    assert tRe.pick_rumination_device() is None


def test_async_shard_takes_its_backends_device():
    class OnCpu(StubBackend):
        device = torch.device("cpu")

    shard = tRe.AsyncRuminationShard(tiny_config(), backend=OnCpu())
    shard.shutdown()
    assert shard.device.type == "cpu"
    with pytest.raises(ValueError, match="the backend handed in runs on 'cpu'"):
        tRe.AsyncRuminationShard(tiny_config(), device="cuda", backend=OnCpu())


def test_coordinator_failed_build_is_a_single_attempt():
    """The JAX package's regression tests on the port: a failed synchronous
    build marks the back map attempted, and the sampler is cleared when the
    bundle is published."""
    slam = SlamSystem(tiny_config(), device="cpu")
    backend = StubBackend(fail=True, delay=0.0)
    coord = tCo.RuminationCoordinator(slam, slam.cfg, backend=backend)
    assert slam.image_recorder == coord.on_frame
    coord._assemble_bundle = lambda info, f, b: _bundle(10)
    img = torch.zeros((32, 32))       # three LK levels with a 15 px window need >= 32
    for i in range(6):
        coord.sampler.record(img, 1.0 + 0.1 * i)
    assert coord.sampler.all_frames
    info = coord._run_rumination(0, 1)
    assert info["result"] == "backend_failed" and backend.calls == 1
    assert 1 in coord.merged_maps and coord.history == [info]
    assert not coord.sampler.all_frames and not coord.sampler.sampled
    # nothing to do while there is one map: no device read, no build
    assert coord.maybe_ruminate() is None and backend.calls == 1


def test_coordinator_async_harvest_of_a_failed_build():
    slam = SlamSystem(tiny_config(), device="cpu")
    shard = tRe.AsyncRuminationShard(slam.cfg, device="cpu", backend=StubBackend(crash=True))
    try:
        coord = tCo.RuminationCoordinator(slam, slam.cfg, async_shard=shard,
                                          backend=StubBackend())
        coord._assemble_bundle = lambda info, f, b: _bundle(10)
        assert coord._run_rumination(0, 1) is None and coord._pending is not None
        deadline = time.time() + 10
        info = None
        while info is None and time.time() < deadline:
            info = coord.maybe_ruminate()
            time.sleep(0.01)
        assert info["result"] == "backend_failed" and coord._pending is None
        assert isinstance(shard.last_error, ValueError)
    finally:
        shard.shutdown()
