"""Parity of the port's loop closing with the JAX package: Horn alignment,
the Sim(3) pose graph (Jacobians, edge list, both optimisers, point
correction), the global bundle adjustment, and ``tracking/loop_closing.py``.

Same numpy inputs from a seed go through the JAX function and its
counterpart.  Tolerances: closed forms 1e-4 (Horn's quaternion with w >= 0 in
both); Jacobians 1e-4; edge lists, candidate ids and scores, and inlier masks
exact; optimiser outputs (8-25 float32 Gauss-Newton/LM iterations over
normal equations summed in another order) 1e-3.

The JAX package has never closed a loop in a recorded drive, so loop closing
is held function by function on known-answer inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rumi_slam_tpu.geometry import alignment as jA
from rumi_slam_tpu.geometry import camera as jcam
from rumi_slam_tpu.geometry import lie as jL
from rumi_slam_tpu.mapstate import map_state as jM
from rumi_slam_tpu.optim import pose_graph as jPG
from rumi_slam_tpu.tracking import local_mapping as jLM
from rumi_slam_tpu.tracking import loop_closing as jLC
from rumi_slam_tpu_torch.config import Config, tiny_config
from rumi_slam_tpu_torch.geometry import alignment as tA
from rumi_slam_tpu_torch.geometry import lie as tL
from rumi_slam_tpu_torch.mapstate import map_state as tM
from rumi_slam_tpu_torch.optim import pose_graph as tPG
from rumi_slam_tpu_torch.tracking import local_mapping as tLM
from rumi_slam_tpu_torch.tracking import loop_closing as tLC

from torch_system_drive import jax_draw, mapping_inputs

torch.set_num_threads(1)

OPT_ATOL = 1e-3


def T(x):
    return torch.from_numpy(np.asarray(x))


def to_jax(t_ms):
    return jM.MapState(**{k: jnp.asarray(v) for k, v in tM.to_numpy(t_ms).items()})


def to_torch(j_ms):
    return tM.from_numpy({k: np.asarray(v) for k, v in j_ms._asdict().items()}, device="cpu")


# ---------------------------------------------------------------------------
# Horn
# ---------------------------------------------------------------------------

def _cloud_pair(rng, n):
    src = rng.normal(size=(n, 3)).astype(np.float32) * 2.0
    S = np.asarray(jL.sim3_make(jL.so3_exp(jnp.asarray([0.3, -0.2, 0.5])),
                                jnp.asarray([0.4, -1.0, 2.0]), jnp.asarray(1.7)))
    dst = np.asarray(jL.sim3_apply(jnp.asarray(S), jnp.asarray(src)))
    dst = dst + rng.normal(scale=0.01, size=dst.shape).astype(np.float32)
    return src, dst, S


@pytest.mark.parametrize("weighted", [False, True])
def test_horn_alignment(weighted):
    rng = np.random.default_rng(3)
    src, dst, S_true = _cloud_pair(rng, 60)
    w = rng.uniform(0, 1, 60).astype(np.float32) if weighted else None
    if weighted:
        w[::7] = 0.0
    S_j = np.asarray(jA.horn_alignment(jnp.asarray(src), jnp.asarray(dst),
                                       None if w is None else jnp.asarray(w)))
    S_t = tA.horn_alignment(T(src), T(dst), None if w is None else T(w)).numpy()
    np.testing.assert_allclose(S_t, S_j, atol=1e-4)
    np.testing.assert_allclose(S_t, S_true, atol=0.02)
    assert S_t[0] >= 0


def test_horn_alignment_three_point_batch():
    """The RANSAC form: [H, 3] triples in one batched call against the JAX
    package's vmap."""
    rng = np.random.default_rng(4)
    src, dst, _ = _cloud_pair(rng, 40)
    idx = rng.integers(0, 40, size=(32, 3))
    idx[0] = [1, 1, 5]          # a degenerate triple (repeated row)
    S_j = np.asarray(jax.vmap(lambda ii: jA.horn_alignment(jnp.asarray(src)[ii],
                                                           jnp.asarray(dst)[ii]))(jnp.asarray(idx)))
    S_t = tA.horn_alignment(T(src)[T(idx)], T(dst)[T(idx)]).numpy()
    assert S_t.shape == (32, 8)
    # a triple with a repeated row is rank-deficient: its top eigenvector is
    # not unique, and the two LAPACKs pick different ones
    good = np.array([len(set(row)) == 3 for row in idx.tolist()])
    assert not good[0] and good.sum() >= 24
    np.testing.assert_allclose(S_t[good], S_j[good], atol=2e-3)
    assert np.isfinite(S_t).all()


# ---------------------------------------------------------------------------
# pose graph
# ---------------------------------------------------------------------------

def _rand_sim3(rng, n, zero_rot=False):
    tau = rng.normal(size=(n, 7)).astype(np.float32) * 0.5
    if zero_rot:
        tau[:, :3] = 0
    return np.array(jL.sim3_exp(jnp.asarray(tau)))


def test_sim3_edge_jacobians():
    """Forward-mode Jacobians of the edge residual against ``jax.jacfwd``
    (1e-4), on random Sim(3) pairs and on zero rotations, where the ``lie``
    logs take their small-angle branch: a fresh map's sequential edges are
    all identity rotations."""
    rng = np.random.default_rng(0)
    E = 16
    Si, Sj = _rand_sim3(rng, E), _rand_sim3(rng, E)
    Si[:5], Sj[:5] = _rand_sim3(rng, 5, True), _rand_sim3(rng, 5, True)
    ident = [1, 0, 0, 0, 0, 0, 0, 0]
    Si[0], Sj[0] = ident, ident
    Sm = np.array(jPG.relative_sim3(jnp.asarray(Si), jnp.asarray(Sj)))
    Sm[5:] = np.array(jL.sim3_retract(jnp.asarray(Sm[5:]),
                                      jnp.asarray(rng.normal(size=(E - 5, 7)) * 0.05,
                                                  jnp.float32)))

    def residual_of(ti, tj, a, b, m):
        return jPG.edge_residual(jL.sim3_retract(a, ti), jL.sim3_retract(b, tj), m)

    z = jnp.zeros(7)
    axes = (None, None, 0, 0, 0)
    Ji = np.asarray(jax.vmap(jax.jacfwd(residual_of, 0), in_axes=axes)(z, z, Si, Sj, Sm))
    Jj = np.asarray(jax.vmap(jax.jacfwd(residual_of, 1), in_axes=axes)(z, z, Si, Sj, Sm))
    r = np.asarray(jax.vmap(residual_of, in_axes=axes)(z, z, Si, Sj, Sm))

    tSi, tSj, tSm = T(Si), T(Sj), T(Sm)
    r_t, (Ji_t, Jj_t) = tPG.tangent_jacobians(
        lambda ti, tj: tPG.edge_residual(tL.sim3_retract(tSi, ti), tL.sim3_retract(tSj, tj), tSm),
        (7, 7), (E,))
    assert torch.isfinite(Ji_t).all() and torch.isfinite(Jj_t).all()
    np.testing.assert_allclose(r_t.numpy(), r, atol=1e-5)
    np.testing.assert_allclose(Ji_t.numpy(), Ji, atol=1e-4)
    np.testing.assert_allclose(Jj_t.numpy(), Jj, atol=1e-4)
    # the all-identity edge: both blocks are +-identity
    np.testing.assert_allclose(Ji_t[0].numpy(), np.eye(7), atol=1e-6)


def test_build_edges_from_covisibility():
    """Edge list order, the ``max_edges`` cut and the padding are exact."""
    rng = np.random.default_rng(5)
    K = 24
    Wc = rng.integers(0, 300, size=(K, K)).astype(np.int32)
    Wc = np.triu(Wc, 1) + np.triu(Wc, 1).T
    valid = rng.uniform(size=K) > 0.2
    S = _rand_sim3(rng, K)
    for max_edges in (40, 512):
        e_j = jPG.build_edges_from_covisibility(jnp.asarray(S), Wc, valid, max_edges=max_edges)
        e_t = tPG.build_edges_from_covisibility(T(S), T(Wc), T(valid), max_edges=max_edges)
        np.testing.assert_array_equal(e_t.i.numpy(), np.asarray(e_j.i))
        np.testing.assert_array_equal(e_t.j.numpy(), np.asarray(e_j.j))
        np.testing.assert_array_equal(e_t.weight.numpy(), np.asarray(e_j.weight))
        np.testing.assert_allclose(e_t.S_ij.numpy(), np.asarray(e_j.S_ij), atol=1e-5)
        assert e_t.i.dtype == torch.int32 and e_t.i.shape == (max_edges,)
    assert int((e_t.weight > 0).sum()) > 40       # the cut at 40 did cut


def _sim3_chain(K=6, drift=0.3):
    truth = np.zeros((K, 7), np.float32)
    truth[:, 0] = 1.0
    truth[:, 4] = 0.5 * np.arange(K)
    est = truth.copy()
    est[K - 1, 4] += drift
    return truth, est


def test_optimize_pose_graph_loop_edge():
    """The chain of ``tests/test_components.py``: a loop edge pulls back the
    drift of the far end, with a repeated edge and zero-weight padding on
    (0, 0) added so that the assembly must accumulate duplicates."""
    K = 6
    truth, est = _sim3_chain(K)
    S_truth = jL.sim3_from_se3(jnp.asarray(truth))
    ei = list(range(K - 1)) + [0, 2, 0, 0]
    ej = list(range(1, K)) + [K - 1, 3, 0, 0]
    w = [1.0] * (K - 1) + [3.0, 0.7, 0.0, 0.0]
    S_m = jnp.stack([jPG.relative_sim3(S_truth[a], S_truth[b]) for a, b in zip(ei, ej)])
    fixed = np.zeros(K, bool)
    fixed[0] = True
    S_est = np.asarray(jL.sim3_from_se3(jnp.asarray(est)))
    e_j = jPG.PoseGraphEdges(i=jnp.asarray(ei, jnp.int32), j=jnp.asarray(ej, jnp.int32),
                             S_ij=S_m, weight=jnp.asarray(w, jnp.float32))
    e_t = tPG.PoseGraphEdges(i=torch.tensor(ei, dtype=torch.int32),
                             j=torch.tensor(ej, dtype=torch.int32),
                             S_ij=T(S_m), weight=torch.tensor(w))
    out_j = np.asarray(jPG.optimize_pose_graph(jnp.asarray(S_est), e_j, jnp.asarray(fixed),
                                               n_iters=10))
    out_t = tPG.optimize_pose_graph(T(S_est), e_t, T(fixed), n_iters=10).numpy()
    np.testing.assert_allclose(out_t, out_j, atol=OPT_ATOL)
    assert np.linalg.norm(out_t[K - 1, 4:7] - truth[K - 1, 4:7]) < 0.02


def _yaw_chain(n=10, seed=0):
    rng = np.random.default_rng(seed)
    Ts = [jL.se3_identity()]
    for _ in range(1, n):
        yaw = 0.15 * rng.normal()
        step = jnp.asarray([0.4, 0.0, 0.1 * rng.normal()], jnp.float32)
        T_rel = jL.se3(jL.so3_exp(jnp.asarray([0.0, 0.0, yaw])), step)
        Ts.append(jL.se3_compose(T_rel, Ts[-1]))
    return jnp.stack(Ts)


def test_optimize_pose_graph_4dof():
    """The yaw-drift chain of ``tests/test_pose_graph_4dof.py``."""
    K = 10
    T_gt = _yaw_chain(K)
    ii = list(range(1, K)) + [K - 1]
    jj = list(range(K - 1)) + [0]
    Tm = jnp.stack([jL.se3_compose(T_gt[a], jL.se3_inverse(T_gt[b])) for a, b in zip(ii, jj)])
    rng = np.random.default_rng(1)
    T0, drift = [T_gt[0]], 0.0
    for a in range(1, K):
        drift += 0.03
        D = jL.se3(jL.so3_exp(jnp.asarray([0.0, 0.0, drift])),
                   jnp.asarray(0.05 * rng.normal(size=3), jnp.float32))
        T0.append(jL.se3_compose(D, T_gt[a]))
    T0 = jnp.stack(T0)
    fixed = np.zeros(K, bool)
    fixed[0] = True
    e_j = jPG.PoseGraphEdgesSE3(i=jnp.asarray(ii, jnp.int32), j=jnp.asarray(jj, jnp.int32),
                                T_ij=Tm, weight=jnp.ones(K, jnp.float32))
    e_t = tPG.PoseGraphEdgesSE3(i=torch.tensor(ii, dtype=torch.int32),
                                j=torch.tensor(jj, dtype=torch.int32), T_ij=T(Tm),
                                weight=torch.ones(K))
    out_j = np.asarray(jPG.optimize_pose_graph_4dof(T0, e_j, jnp.asarray(fixed), n_iters=15))
    out_t = tPG.optimize_pose_graph_4dof(T(T0), e_t, T(fixed), n_iters=15).numpy()
    np.testing.assert_allclose(out_t, out_j, atol=OPT_ATOL)

    def centers(x):
        return tL.se3_t(tL.se3_inverse(T(x))).numpy()

    err1 = np.linalg.norm(centers(out_t) - centers(T_gt), axis=1).mean()
    assert err1 < 0.02


def test_correct_points():
    rng = np.random.default_rng(6)
    K, P = 5, 40
    S_old, S_new = _rand_sim3(rng, K), _rand_sim3(rng, K)
    pts = rng.normal(size=(P, 3)).astype(np.float32)
    ref = rng.integers(-1, K, size=P).astype(np.int32)
    valid = rng.uniform(size=P) > 0.2
    out_j = np.asarray(jPG.correct_points(jnp.asarray(pts), jnp.asarray(ref), jnp.asarray(valid),
                                          jnp.asarray(S_old), jnp.asarray(S_new)))
    out_t = tPG.correct_points(T(pts), T(ref), T(valid), T(S_old), T(S_new)).numpy()
    np.testing.assert_allclose(out_t, out_j, atol=1e-5)
    np.testing.assert_array_equal(out_t[~valid | (ref < 0)], pts[~valid | (ref < 0)])


# ---------------------------------------------------------------------------
# global bundle adjustment
# ---------------------------------------------------------------------------

def _gba_map():
    """The perturbed small full map of ``tests/test_pallas_and_gba.py``, with
    two keyframes of another submap and some cloud keyframes added."""
    rng = np.random.default_rng(1)
    K = jnp.asarray([260.0, 260.0, 159.5, 119.5])
    n_kf, n_feat, n_pt = 8, 64, 64
    X_true = jnp.asarray(rng.uniform([-2, -2, 3], [2, 2, 9], (n_pt, 3)), jnp.float32)
    poses_true = jnp.stack([
        jL.se3(jL.so3_exp(jnp.asarray(rng.normal(scale=0.02, size=3), jnp.float32)),
               jnp.asarray([0.25 * i, 0.02 * i, 0.0], jnp.float32)) for i in range(n_kf)])
    kf_uv = jnp.stack([jcam.project_world(K, poses_true[i], X_true)[0] for i in range(n_kf)])
    map_id = np.zeros(n_kf, np.int32)
    map_id[3] = 1                       # a keyframe of another submap in the middle
    is_cloud = np.zeros(n_kf, bool)
    is_cloud[5] = True
    ms = jM.empty(n_kf, n_feat, n_pt)._replace(
        kf_uv=kf_uv, kf_feat_valid=jnp.ones((n_kf, n_feat), bool),
        kf_point=jnp.tile(jnp.arange(n_pt, dtype=jnp.int32)[None, :], (n_kf, 1)),
        kf_map_id=jnp.asarray(map_id), kf_valid=jnp.ones(n_kf, bool),
        kf_is_cloud=jnp.asarray(is_cloud),
        kf_octave=jnp.asarray(rng.integers(0, 3, (n_kf, n_feat)), jnp.int32),
        kf_time=jnp.arange(n_kf, dtype=jnp.float32),
        pt_valid=jnp.asarray(np.arange(n_pt) % 9 != 0),
        pt_map_id=jnp.zeros(n_pt, jnp.int32), n_kf=jnp.int32(n_kf), n_pt=jnp.int32(n_pt))
    pert_pose = poses_true.at[2:, 4:7].add(
        jnp.asarray(rng.normal(scale=0.05, size=(n_kf - 2, 3)), jnp.float32))
    pert_pts = X_true + jnp.asarray(rng.normal(scale=0.05, size=(n_pt, 3)), jnp.float32)
    return ms._replace(kf_pose=pert_pose, pt_xyz=pert_pts), K, poses_true, X_true


def test_global_bundle_adjustment():
    j_ms, K, poses_true, X_true = _gba_map()
    t_ms = to_torch(j_ms)
    out_j = jLM.global_bundle_adjustment(j_ms, K, 0, n_iters=25)
    out_t = tLM.global_bundle_adjustment(t_ms, T(K), 0, n_iters=25)
    np.testing.assert_allclose(out_t.kf_pose.numpy(), np.asarray(out_j.kf_pose), atol=OPT_ATOL)
    np.testing.assert_allclose(out_t.pt_xyz.numpy(), np.asarray(out_j.pt_xyz), atol=OPT_ATOL)
    # the other submap's keyframe and the dead points stay where they were
    np.testing.assert_array_equal(out_t.kf_pose[3].numpy(), np.asarray(j_ms.kf_pose[3]))
    dead = ~np.asarray(j_ms.pt_valid)
    np.testing.assert_array_equal(out_t.pt_xyz.numpy()[dead], np.asarray(j_ms.pt_xyz)[dead])
    live = np.asarray(j_ms.pt_valid)
    assert np.linalg.norm(out_t.pt_xyz.numpy()[live] - np.asarray(X_true)[live], axis=-1).mean() < 0.02
    # the input map is untouched
    np.testing.assert_array_equal(t_ms.kf_pose.numpy(), np.asarray(j_ms.kf_pose))


def test_global_bundle_adjustment_small_map_and_mesh():
    """A one-keyframe submap is left as it is on both routes; with a mesh
    the map (another submap's keyframe and a cloud keyframe among its rows)
    goes through the sharded PCG engine and lands where JAX's does."""
    from jax.sharding import Mesh

    from conftest import cpu_mesh_devices
    from rumi_slam_tpu_torch.parallel.distributed import BaMesh

    j_ms, K, _, _ = _gba_map()
    t_ms = to_torch(j_ms)
    out = tLM.global_bundle_adjustment(t_ms, T(K), 1, n_iters=3)     # one keyframe: no-op
    assert out is t_ms
    assert tLM.global_bundle_adjustment(t_ms, T(K), 1, mesh=BaMesh("cpu", 2)) is t_ms
    devs = cpu_mesh_devices(4)
    if devs is None:
        pytest.skip("needs the virtual CPU mesh of tests/conftest.py")
    out_j = jLM.global_bundle_adjustment(j_ms, K, 0, n_iters=6, mesh=Mesh(np.array(devs), ("ba",)))
    out_t = tLM.global_bundle_adjustment(t_ms, T(K), 0, n_iters=6, mesh=BaMesh("cpu", 4))
    np.testing.assert_allclose(out_t.kf_pose.numpy(), np.asarray(out_j.kf_pose), rtol=0, atol=2e-4)
    np.testing.assert_allclose(out_t.pt_xyz.numpy(), np.asarray(out_j.pt_xyz), rtol=0, atol=5e-4)
    # keyframe 3 belongs to submap 1 and stays where it was
    np.testing.assert_array_equal(out_t.kf_pose[3].numpy(), t_ms.kf_pose[3].numpy())


# ---------------------------------------------------------------------------
# loop closing
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def drive_map():
    """The map of a short port drive (tiny config, 30 frames): (port map, JAX
    map, K torch, K jax)."""
    rounds, slam, _ = mapping_inputs(30)
    slam.sync_mapping()
    k = tiny_config().intrinsics()
    return slam.ms, to_jax(slam.ms), k, jnp.asarray(k.numpy())


def test_detect_loop_candidates(drive_map):
    t_ms, _, _, _ = drive_map
    n_kf = int(t_ms.n_kf)
    assert n_kf >= 8
    # in a 30-frame drive every keyframe is covisible with every other, and
    # covisible ones are no candidates: thin out the first keyframes'
    # observations so that they fall below the covisibility threshold
    thin = (torch.arange(t_ms.max_kf)[:, None] < 4) & (torch.arange(t_ms.max_feat)[None] % 8 != 0)
    t_ms = t_ms._replace(kf_point=torch.where(thin, -1, t_ms.kf_point))
    j_ms = to_jax(t_ms)
    some_score = False
    for kf_id in (n_kf - 1, n_kf - 3):
        for gap in (20, 3):
            c_j = jLC.detect_loop_candidates(j_ms, kf_id, top_k=3, min_time_gap_slots=gap)
            c_t = tLC.detect_loop_candidates(t_ms, kf_id, top_k=3, min_time_gap_slots=gap)
            np.testing.assert_array_equal(c_t.score.numpy(), np.asarray(c_j.score))
            live = np.asarray(c_j.score) > 0
            np.testing.assert_array_equal(c_t.kf_id.numpy()[live], np.asarray(c_j.kf_id)[live])
            some_score |= bool(live.any())
    assert some_score


def _two_kf_loop_map(F=96):
    """Two keyframes of one camera over one scene, the candidate's points
    moved by ``S_true^-1`` (``tests/test_rumination.py::build_two_submaps``
    with one KF pair and a few wrong point positions)."""
    rng = np.random.default_rng(31)
    K = jnp.asarray([260.0, 260.0, 159.5, 119.5])
    ms = jM.empty(max_kf=8, max_feat=F, max_pt=512)
    X = jnp.asarray(rng.uniform([-2, -1.5, 3], [2, 1.5, 8], (F, 3)).astype(np.float32))
    desc = jnp.asarray(rng.integers(0, 2**32, (F, 8), dtype=np.uint32))
    S_true = jL.sim3_make(jL.so3_exp(jnp.asarray([0.05, -0.1, 0.08])),
                          jnp.asarray([0.5, -0.3, 0.9]), jnp.asarray(1.4))
    X_1 = jL.sim3_apply(jL.sim3_inverse(S_true), X)
    X_1 = X_1.at[::8].add(jnp.asarray(rng.normal(scale=1.0, size=(F // 8, 3)), jnp.float32))
    ms, pid0 = jM.add_points(ms, X, desc, jnp.ones(F, bool), 0, map_id=0)
    ms, pid1 = jM.add_points(ms, X_1, desc, jnp.ones(F, bool), 0, map_id=0)
    from rumi_slam_tpu.ops.orb import Features

    def feats(uv):
        return Features(uv=uv, response=jnp.ones(F), angle=jnp.zeros(F),
                        octave=jnp.zeros(F, jnp.int32), desc=desc, valid=jnp.ones(F, bool))

    T0 = jL.se3(jL.so3_exp(jnp.asarray([0.0, 0.02, 0.0])), jnp.asarray([0.1, 0.0, 0.0]))
    uv0, _ = jcam.project_world(K, T0, X)
    ms, _ = jM.insert_keyframe(ms, T0, feats(uv0), 0.0, pid0, map_id=0)
    Q = jL.sim3_compose(jL.sim3_from_se3(T0), S_true)
    T1 = jL.se3(Q[:4], Q[4:7] / jL.sim3_scale(Q))
    ms, _ = jM.insert_keyframe(ms, T1, feats(uv0), 1.0, pid1, map_id=0)
    return ms, K, S_true


def test_verify_loop_from_jax_triples():
    """The port, handed the JAX package's own index sets, finds the same
    inlier mask and the same refined Sim(3) (1e-3), which is the known one."""
    j_ms, K, S_true = _two_kf_loop_map()
    t_ms = to_torch(j_ms)
    key = jax.random.PRNGKey(7)
    S_j, n_j, inl_j = jLC.verify_loop(key, K, j_ms, 0, 1)
    S_t, n_t, inl_t = tLC.verify_loop(jax_draw(key), T(K), t_ms, 0, 1)
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    assert int(n_t) == int(n_j) >= 60
    np.testing.assert_allclose(S_t.numpy(), np.asarray(S_j), atol=OPT_ATOL)
    assert abs(float(tL.sim3_scale(S_t)) - 1.4) < 0.02


def test_verify_loop_own_draws():
    """With its own draws (a seeded CPU generator) the port recovers the
    known Sim(3) all the same, and ``verify_loop_from`` repeats it."""
    from rumi_slam_tpu_torch.optim import ransac

    j_ms, K, S_true = _two_kf_loop_map()
    t_ms = to_torch(j_ms)
    taken = []
    base = ransac.sampler(torch.Generator().manual_seed(5))

    def draw(logits, shape):
        taken.append(base(logits, shape))
        return taken[-1]

    S, n, inl = tLC.verify_loop(draw, T(K), t_ms, 0, 1, n_hyp=64)
    assert taken[0].shape == (64, 3)
    assert int(n) >= 60 and abs(float(tL.sim3_scale(S)) - 1.4) < 0.02
    S2, n2, _ = tLC.verify_loop_from(taken[0], T(K), t_ms, 0, 1)
    assert int(n2) == int(n) and torch.equal(S, S2)


def test_close_loop(drive_map):
    t_ms, j_ms, tK, jK = drive_map
    n_kf = int(t_ms.n_kf)
    S_drift = np.asarray(jL.sim3_exp(jnp.asarray([0.01, -0.02, 0.015, 0.05, -0.03, 0.04, 0.03])))
    out_j = jLC.close_loop(j_ms, jK, n_kf - 1, 1, jnp.asarray(S_drift), min_covis_edge=40)
    out_t = tLC.close_loop(t_ms, tK, n_kf - 1, 1, T(S_drift), min_covis_edge=40)
    np.testing.assert_allclose(out_t.kf_pose.numpy(), np.asarray(out_j.kf_pose), atol=OPT_ATOL)
    np.testing.assert_allclose(out_t.pt_xyz.numpy(), np.asarray(out_j.pt_xyz), atol=2e-3)
    # the graph moved the query end and held the candidate
    moved = np.abs(out_t.kf_pose.numpy() - t_ms.kf_pose.numpy()).max(axis=1)
    assert moved[1] < 1e-6 and moved[n_kf - 1] > 1e-3


def test_mapping_round_runs_loop_detection(drive_map):
    """With loop closing on (the default), a round at the cadence reports the
    retrieval score; the short drive holds no loop, so none closes."""
    from rumi_slam_tpu_torch.tracking import mapping_worker as tMW
    from rumi_slam_tpu_torch.optim import ransac

    t_ms, _, tK, _ = drive_map
    cfg = tiny_config()
    assert cfg.mapping.loop_closing and Config().mapping.loop_closing
    kf_id = int(t_ms.n_kf) - 1
    out = tMW.run_mapping_round(t_ms, tK, cfg, kf_id, use_stereo=False,
                                draw=ransac.sampler(torch.Generator().manual_seed(0)),
                                kf_count=cfg.mapping.loop_check_interval * 2)
    assert "loop_best_score" in out.events and out.events["loop"] is False
    out2 = tMW.run_mapping_round(t_ms, tK, cfg, kf_id, use_stereo=False,
                                 draw=None, kf_count=cfg.mapping.loop_check_interval * 2 + 1)
    assert "loop_best_score" not in out2.events
