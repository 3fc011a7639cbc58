"""Parity of the port's MapState API with the JAX package's, on the same
numpy inputs.  Integer and boolean fields are exact, and so are float fields
that are only copied; computed floats (curvature) are allclose at 1e-6.
Every function also leaves the MapState it was given unchanged."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rumi_slam_tpu.mapstate import map_state as jM
from rumi_slam_tpu.ops.orb import Features as JFeatures
from rumi_slam_tpu_torch.mapstate import map_state as tM
from rumi_slam_tpu_torch.ops.orb import Features as TFeatures

torch.set_num_threads(1)

K_CAP, F, P_CAP = 6, 16, 48


def feats(rng, valid_frac=0.8):
    d = dict(uv=rng.uniform(0, 300, (F, 2)).astype(np.float32),
             response=rng.uniform(0, 1, F).astype(np.float32),
             angle=rng.uniform(-3, 3, F).astype(np.float32),
             octave=rng.integers(0, 3, F).astype(np.int32),
             desc=rng.integers(0, 2**32, (F, 8), dtype=np.uint32),
             valid=rng.random(F) < valid_frac)
    return (JFeatures(**{k: jnp.asarray(v) for k, v in d.items()}),
            TFeatures(**{k: torch.from_numpy(v.view(np.int32) if k == "desc" else v)
                         for k, v in d.items()}))


def as_np(ms):
    return {k: np.asarray(v) for k, v in ms._asdict().items()}


def assert_ms_equal(t_ms, j_ms, skip=()):
    tn, jn = tM.to_numpy(t_ms), as_np(j_ms)
    for k in jn:
        if k in skip:
            continue
        assert tn[k].dtype == jn[k].dtype, k
        np.testing.assert_array_equal(tn[k], jn[k], err_msg=k)


def built_map(seed=0, n_kf=4, n_pt=30):
    """A JAX map with ``n_kf`` keyframes over ``n_pt`` points, each feature
    bound to a random point (some unbound), two submaps; and its port."""
    rng = np.random.default_rng(seed)
    ms = jM.empty(K_CAP, F, P_CAP)
    xyz = rng.uniform(-1, 1, (n_pt, 3)).astype(np.float32)
    desc = rng.integers(0, 2**32, (n_pt, 8), dtype=np.uint32)
    ms, _ = jM.add_points(ms, jnp.asarray(xyz), jnp.asarray(desc), jnp.ones(n_pt, bool), 0)
    for k in range(n_kf):
        jf, _ = feats(rng)
        assoc = np.where(rng.random(F) < 0.7, rng.integers(0, n_pt, F), -1).astype(np.int32)
        pose = np.concatenate([[1, 0, 0, 0], rng.normal(0, 0.3, 3)]).astype(np.float32)
        ms, _ = jM.insert_keyframe(ms, jnp.asarray(pose), jf, 0.1 * k + 0.05, jnp.asarray(assoc),
                                   map_id=0 if k < n_kf - 1 else 1)
    ms = ms._replace(pt_valid=ms.pt_valid.at[3].set(False), n_maps=jnp.int32(2))
    return ms, tM.from_numpy(as_np(ms), device="cpu")


@pytest.fixture
def maps():
    return built_map()


def unchanged(t_ms):
    """Deep copy of a port MapState, to check later that nothing wrote into it."""
    return tM.MapState(*(x.clone() for x in t_ms))


def assert_same_tensors(a, b):
    for k, x, y in zip(tM.MapState._fields, a, b):
        assert torch.equal(x, y), k


# ------------------------------------------------------------- insertion

def test_insert_keyframe_until_full_and_past_capacity():
    rng = np.random.default_rng(1)
    jms, tms = jM.empty(K_CAP, F, P_CAP), tM.empty(K_CAP, F, P_CAP, device="cpu")
    for k in range(K_CAP + 2):           # the last two are no-ops
        jf, tf = feats(rng)
        assoc = rng.integers(-1, P_CAP, F).astype(np.int32)
        pose = rng.normal(size=7).astype(np.float32)
        ur = None if k % 2 else rng.uniform(-1, 50, F).astype(np.float32)
        jms, jid = jM.insert_keyframe(jms, jnp.asarray(pose), jf, 0.5 * k, jnp.asarray(assoc),
                                      ur=None if ur is None else jnp.asarray(ur),
                                      is_cloud=k == 2)
        before = unchanged(tms)
        tms2, tid = tM.insert_keyframe(tms, torch.from_numpy(pose), tf, 0.5 * k,
                                       torch.from_numpy(assoc),
                                       ur=None if ur is None else torch.from_numpy(ur),
                                       is_cloud=k == 2)
        assert_same_tensors(tms, before)
        tms = tms2
        assert int(tid) == int(jid) and tid.dtype == torch.int32
        assert_ms_equal(tms, jms)
    assert int(tms.n_kf) == K_CAP


@pytest.mark.parametrize("n_rows,n_valid_frac", [(20, 0.6), (40, 0.9)])
def test_add_points_with_overflow(n_rows, n_valid_frac):
    """Slots go to valid rows in order; rows past capacity get -1."""
    rng = np.random.default_rng(n_rows)
    jms, tms = built_map(seed=3)
    for _ in range(2):
        xyz = rng.normal(size=(n_rows, 3)).astype(np.float32)
        desc = rng.integers(0, 2**32, (n_rows, 8), dtype=np.uint32)
        valid = rng.random(n_rows) < n_valid_frac
        octv = rng.integers(0, 4, n_rows).astype(np.int32)
        ang = rng.normal(size=n_rows).astype(np.float32)
        jms, jids = jM.add_points(jms, jnp.asarray(xyz), jnp.asarray(desc), jnp.asarray(valid),
                                  2, octave=jnp.asarray(octv), angle=jnp.asarray(ang))
        before = unchanged(tms)
        tms2, tids = tM.add_points(tms, torch.from_numpy(xyz),
                                   torch.from_numpy(desc.view(np.int32)),
                                   torch.from_numpy(valid), 2, octave=torch.from_numpy(octv),
                                   angle=torch.from_numpy(ang))
        assert_same_tensors(tms, before)
        tms = tms2
        np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
        assert_ms_equal(tms, jms)
    assert int(tms.n_pt) == P_CAP and (tids.numpy() == -1).any()


def test_set_associations(maps):
    jms, tms = maps
    assoc = np.random.default_rng(4).integers(-1, 30, F).astype(np.int32)
    out_j = jM.set_associations(jms, 1, jnp.asarray(assoc))
    out_t = tM.set_associations(tms, 1, torch.from_numpy(assoc))
    assert_ms_equal(out_t, out_j)


# ------------------------------------------------------------- descriptor refresh

def refresh_case():
    """KF 0 observes point 0 in row 2 and point 3 in rows 5 and 6 (a
    duplicate); every other row is unassociated, several after row 2."""
    jms, _ = built_map(seed=5)
    kp = np.full((K_CAP, F), -1, np.int32)
    kp[0, 2], kp[0, 5], kp[0, 6], kp[0, 9] = 0, 3, 3, 7
    jms = jms._replace(kf_point=jnp.asarray(kp), kf_feat_valid=jnp.ones((K_CAP, F), bool))
    return jms, tM.from_numpy(as_np(jms), device="cpu")


def test_refresh_point_descriptors_jax_loses_slot_0():
    """The duplicate-scatter check.  The JAX package writes every row of the
    KF, the unassociated ones clipped to slot 0 with slot 0's old value; on
    the CPU the later write wins, so point 0 keeps its old descriptor,
    octave and angle although row 2 observed it.  The port writes only the
    observing rows: point 0 takes row 2's values.  Among observing rows the
    later one wins in both packages (point 3 takes row 6).  ROADMAP queue 3
    records the JAX behaviour as a fault of the JAX package."""
    jms, tms = refresh_case()
    out_j = jM.refresh_point_descriptors(jms, 0)
    out_t = tM.refresh_point_descriptors(tms, 0)
    kd = np.asarray(jms.kf_desc[0])
    np.testing.assert_array_equal(np.asarray(out_j.pt_desc[0]), np.asarray(jms.pt_desc[0]))
    np.testing.assert_array_equal(out_t.pt_desc[0].numpy().view(np.uint32), kd[2])
    assert int(out_t.pt_octave[0]) == int(jms.kf_octave[0, 2])
    assert float(out_t.pt_angle[0]) == float(jms.kf_angle[0, 2])
    np.testing.assert_array_equal(np.asarray(out_j.pt_desc[3]), kd[6])


def test_refresh_point_descriptors_matches_jax_off_slot_0():
    """Parity on every slot but 0, where the JAX package loses the refresh
    (test above)."""
    jms, tms = refresh_case()
    before = unchanged(tms)
    out_j = jM.refresh_point_descriptors(jms, 0)
    out_t = tM.refresh_point_descriptors(tms, 0)
    assert_same_tensors(tms, before)
    tn, jn = tM.to_numpy(out_t), as_np(out_j)
    for k in ("pt_desc", "pt_octave", "pt_angle"):
        np.testing.assert_array_equal(tn[k][1:], jn[k][1:], err_msg=k)
    assert_ms_equal(out_t, out_j, skip=("pt_desc", "pt_octave", "pt_angle"))


# ------------------------------------------------------------- covisibility

@pytest.mark.parametrize("map_id", [None, 0, 1])
def test_incidence_and_covisibility(maps, map_id):
    jms, tms = maps
    np.testing.assert_array_equal(tM.incidence(tms, map_id).numpy(),
                                  np.asarray(jM.incidence(jms, map_id)))
    c = tM.covisibility(tms, map_id)
    assert c.dtype == torch.int32
    np.testing.assert_array_equal(c.numpy(), np.asarray(jM.covisibility(jms, map_id)))


def test_point_obs_count(maps):
    jms, tms = maps
    np.testing.assert_array_equal(tM.point_obs_count(tms).numpy(),
                                  np.asarray(jM.point_obs_count(jms)))


@pytest.mark.parametrize("kf_id,window", [(0, 3), (1, 5), (2, 6), (3, 2)])
def test_local_window_with_ties(kf_id, window):
    """Equal covisibility weights come out lowest slot first, as lax.top_k
    orders them."""
    jms, _ = built_map(seed=6, n_kf=5, n_pt=6)   # few points: many equal weights
    tms = tM.from_numpy(as_np(jms), device="cpu")
    ids_j, ok_j = jM.local_window(jms, kf_id, window=window)
    ids_t, ok_t = tM.local_window(tms, kf_id, window=window)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))


# ------------------------------------------------------------- compaction, statistics

def test_compact_maps_and_fields(maps):
    jms, _ = maps
    jms = jms._replace(kf_valid=jms.kf_valid.at[1].set(False),
                       pt_valid=jms.pt_valid.at[jnp.arange(0, 30, 4)].set(False),
                       pt_ref_kf=jms.pt_ref_kf.at[5].set(2).at[6].set(1))
    tms = tM.from_numpy(as_np(jms), device="cpu")
    before = unchanged(tms)
    out_j, kf_j, pt_j = jM.compact(jms)
    out_t, kf_t, pt_t = tM.compact(tms)
    assert_same_tensors(tms, before)
    np.testing.assert_array_equal(kf_t, kf_j)
    np.testing.assert_array_equal(pt_t, pt_j)
    assert_ms_equal(out_t, out_j)


def test_submap_statistics(maps):
    jms, tms = maps
    for m in (0, 1, 2):
        assert int(tM.map_kf_count(tms, m)) == int(jM.map_kf_count(jms, m))
        assert float(tM.map_duration(tms, m)) == float(jM.map_duration(jms, m))
        np.testing.assert_allclose(float(tM.map_trajectory_curvature(tms, m)),
                                   float(jM.map_trajectory_curvature(jms, m)), rtol=1e-6)


def test_empty_and_from_numpy_default_to_the_card():
    """Both constructors place the map on the card unless asked for the CPU;
    a host without a card raises, as ``checkpoint.load`` does."""
    d = tM.to_numpy(tM.empty(2, 4, 8, device="cpu"))
    if torch.cuda.is_available():
        assert tM.empty(2, 4, 8).kf_pose.device.type == "cuda"
        assert tM.from_numpy(d).pt_xyz.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tM.empty(2, 4, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tM.from_numpy(d)
