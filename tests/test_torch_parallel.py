"""Parity of the port's sharded bundle adjustment with the JAX package: the
host-side partitions (exact), the per-shard terms (1e-4 relative), both
solvers at D=8 (poses 2e-4, points 5e-4, cost 1e-5 relative), the port at
D=1 against D=8, the in-system ``global_bundle_adjustment(mesh=...)`` route,
and the coordinator's choice between the PCG and the dense global BA.

JAX runs on the 8-device virtual CPU mesh of ``tests/conftest.py``; the port
batches its shards on the CPU (``BaMesh("cpu", D)``).  The same numpy inputs
from a seed go through both.  On the CPU JAX's own D=1 and D=8 PCG results
lie 3.4e-5 apart in poses, 9.3e-5 in points and 1.1e-6 relative in cost.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from conftest import cpu_mesh_devices
from rumi_slam_tpu.mapstate import map_state as jM
from rumi_slam_tpu.parallel import sharded_ba as jS
from rumi_slam_tpu.tracking import local_mapping as jLM
from rumi_slam_tpu_torch.mapstate import map_state as tM
from rumi_slam_tpu_torch.parallel import distributed as tD
from rumi_slam_tpu_torch.parallel import sharded_ba as tS
from rumi_slam_tpu_torch.rumination import coordinator as tCo
from rumi_slam_tpu_torch.tracking import local_mapping as tLM

from test_parallel import K as jK
from test_parallel import make_problem
from torch_parallel_problem import dense_inputs, gather_points, pcg_inputs, scatter_points
from torch_parallel_problem import make_problem as port_make_problem

torch.set_num_threads(1)

TERMS_RTOL = 1e-4
POSE_ATOL, POINT_ATOL, COST_RTOL = 2e-4, 5e-4, 1e-5
tK = torch.tensor(np.asarray(jK))


def T(x):
    return torch.from_numpy(np.array(x))


def problem_np():
    return tuple(np.asarray(a) for a in make_problem())


def jax_mesh(D):
    devs = cpu_mesh_devices(D)
    if devs is None:
        pytest.skip("needs the virtual CPU mesh of tests/conftest.py")
    return Mesh(np.array(devs), ("ba",))


def close_rel(t, j, rtol, what):
    t, j = np.asarray(t), np.asarray(j)
    scale = max(float(np.abs(j).max()), 1e-12)
    gap = float(np.abs(t - j).max())
    assert gap <= rtol * scale, (what, gap, scale)


# ----------------------------------------------------------------- partitions

def test_port_make_problem_equals_jax():
    """``tests/torch_parallel_problem.py`` builds ``make_problem``'s inputs
    without JAX (for the card), the same within float32 rounding."""
    for t, j in zip(port_make_problem(), problem_np()):
        assert t.dtype == j.dtype and t.shape == j.shape
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-4)


@pytest.mark.parametrize("D,R,drop_conf", [(1, 6, False), (3, 6, True), (8, 6, False),
                                           (3, 4, False)])
def test_partitions_equal_jax(D, R, drop_conf):
    """Both partitions, array for array; R=4 < 6 observations a point drops
    some, and zeroed confidences are skipped by the grouped one."""
    _, _, X, cam_idx, pt_idx, uv, conf = problem_np()
    if drop_conf:
        conf = conf.copy()
        conf[::7] = 0.0
    n = X.shape[0]
    for j, t in ((jS.partition_problem(cam_idx, pt_idx, uv, conf, n, D),
                  tS.partition_problem(cam_idx, pt_idx, uv, conf, n, D)),
                 (jS.partition_problem_grouped(cam_idx, pt_idx, uv, conf, n, D, R),
                  tS.partition_problem_grouped(cam_idx, pt_idx, uv, conf, n, D, R))):
        assert j.keys() == t.keys()
        for k in j:
            np.testing.assert_array_equal(np.asarray(t[k]), np.asarray(j[k]), err_msg=k)
            assert np.asarray(t[k]).dtype == np.asarray(j[k]).dtype, k
    g = tS.partition_problem_grouped(cam_idx, pt_idx, uv, conf, n, D, R)
    assert (g["dropped_obs"] > 0) == (R < 6)


# ----------------------------------------------------------------- per-shard terms

def _lam():
    return np.float32(3e-3)


def test_shard_terms_match_jax():
    D = 3
    _, poses, X, cam_idx, pt_idx, uv, conf = problem_np()
    part = jS.partition_problem(cam_idx, pt_idx, uv, conf, X.shape[0], D)
    pts = scatter_points(X, part["point_rows"], X.shape[0]).reshape(D, -1, 3)
    t_out = tS._shard_terms(tK, T(poses), T(pts), T(part["cam_idx"]), T(part["pt_local"]),
                            T(part["uv"]), T(part["conf"]), torch.tensor(_lam()))
    free = jnp.ones(poses.shape[0])
    names = ("S_local", "b_local", "Wblk", "Hpp_inv", "bp", "cost")
    for d in range(D):
        j_out = jS._shard_terms(jK, jnp.asarray(poses), jnp.asarray(pts[d]),
                                jnp.asarray(part["cam_idx"][d]),
                                jnp.asarray(part["pt_local"][d]), jnp.asarray(part["uv"][d]),
                                jnp.asarray(part["conf"][d]), _lam(), free)
        for name, t, j in zip(names, t_out, j_out):
            close_rel(t[d].numpy(), j, TERMS_RTOL, (name, d))


def test_grouped_terms_match_jax():
    D = 3
    _, poses, X, cam_idx, pt_idx, uv, conf = problem_np()
    part = jS.partition_problem_grouped(cam_idx, pt_idx, uv, conf, X.shape[0], D, 6)
    pts = scatter_points(X, part["point_rows"], X.shape[0]).reshape(D, -1, 3)
    t_out = tS._grouped_terms(tK, T(poses), T(pts), T(part["cam_idx"]), T(part["uv"]),
                              T(part["conf"]), torch.tensor(_lam()))
    names = ("Hcc", "bc_corr", "A", "Hpp_inv", "bp", "cost")
    for d in range(D):
        j_out = jS._grouped_terms(jK, jnp.asarray(poses), jnp.asarray(pts[d]),
                                  jnp.asarray(part["cam_idx"][d]), jnp.asarray(part["uv"][d]),
                                  jnp.asarray(part["conf"][d]), _lam())
        for name, t, j in zip(names, t_out, j_out):
            close_rel(t[d].numpy(), j, TERMS_RTOL, (name, d))


def test_inv6x6_matches_jax():
    rng = np.random.default_rng(2)
    J = rng.normal(size=(16, 9, 6)).astype(np.float32)
    M = np.einsum("cki,ckj->cij", J, J) + 0.1 * np.eye(6, dtype=np.float32)
    close_rel(tS._inv6x6(T(M)).numpy(), jS._inv6x6(jnp.asarray(M)), TERMS_RTOL, "inv6x6")


# ----------------------------------------------------------------- solvers

def run_dense(pkg, D, n_iters=8):
    prob = problem_np()
    args, rows = dense_inputs(prob, D)
    if pkg == "jax":
        p, x, c = jS.sharded_bundle_adjust(jax_mesh(D), jK, jnp.asarray(prob[1]),
                                           *map(jnp.asarray, args), n_iters=n_iters)
    else:
        p, x, c = tS.sharded_bundle_adjust(tD.BaMesh("cpu", D), tK, T(prob[1]), *map(T, args),
                                           n_iters=n_iters)
    return np.asarray(p), gather_points(x, rows, prob[2].shape[0]), float(c)


def run_pcg(pkg, D, n_iters=8, cg_iters=24):
    prob = problem_np()
    args, rows = pcg_inputs(prob, D)
    if pkg == "jax":
        p, x, c = jS.sharded_bundle_adjust_pcg(jax_mesh(D), jK, jnp.asarray(prob[1]),
                                               *map(jnp.asarray, args), n_iters=n_iters,
                                               cg_iters=cg_iters)
    else:
        p, x, c = tS.sharded_bundle_adjust_pcg(tD.BaMesh("cpu", D), tK, T(prob[1]),
                                               *map(T, args), n_iters=n_iters,
                                               cg_iters=cg_iters)
    return np.asarray(p), gather_points(x, rows, prob[2].shape[0]), float(c)


def assert_same_solution(a, b):
    (pa, xa, ca), (pb, xb, cb) = a, b
    assert np.abs(pa - pb).max() <= POSE_ATOL, np.abs(pa - pb).max()
    assert np.abs(xa - xb).max() <= POINT_ATOL, np.abs(xa - xb).max()
    assert abs(ca - cb) <= COST_RTOL * abs(cb), (ca, cb)


@pytest.mark.parametrize("solver", ["dense", "pcg"])
def test_solver_matches_jax_at_8_shards(solver):
    run = run_dense if solver == "dense" else run_pcg
    t, j = run("torch", 8), run("jax", 8)
    assert_same_solution(t, j)
    start = run("torch", 8, n_iters=1)[2]
    assert t[2] < start


def test_pcg_one_shard_equals_eight():
    assert_same_solution(run_pcg("torch", 1), run_pcg("torch", 8))


# ----------------------------------------------------------------- in-system route

def mapstate_problem():
    """``tests/test_parallel.py::test_sharded_gba_on_mapstate``'s map: 6
    keyframes observing 64 of 128 points each, poses of keyframes 2-5 and
    every point moved by 5 cm."""
    from rumi_slam_tpu.geometry import camera, lie
    from rumi_slam_tpu.ops.orb import Features

    rng = np.random.default_rng(5)
    n_pts, F, C = 128, 64, 6
    ms = jM.empty(max_kf=8, max_feat=F, max_pt=256)
    X = jnp.asarray(rng.uniform([-2, -1.5, 3], [2, 1.5, 8], (n_pts, 3)).astype(np.float32))
    desc = jnp.asarray(rng.integers(0, 2**32, (n_pts, 8), dtype=np.uint32))
    ms, ids = jM.add_points(ms, X, desc, jnp.ones(n_pts, bool), 0)
    poses_true = []
    for i in range(C):
        q = np.asarray(lie.so3_exp(jnp.asarray(rng.normal(scale=0.02, size=3).astype(np.float32))))
        poses_true.append(np.concatenate([q, np.array([0.25 * i, 0, 0], np.float32)]))
    for i in range(C):
        Tc = jnp.asarray(poses_true[i])
        uv, _ = camera.project_world(jK, Tc, X)
        take = jnp.asarray((np.arange(F) + i * 16) % n_pts)
        feats = Features(uv=uv[take], response=jnp.ones(F), angle=jnp.zeros(F),
                         octave=jnp.zeros(F, jnp.int32), desc=desc[take],
                         valid=jnp.ones(F, bool))
        ms, _ = jM.insert_keyframe(ms, Tc, feats, float(i), ids[take])
    kfp = np.asarray(ms.kf_pose).copy()
    kfp[2:C, 4:7] += rng.normal(scale=0.05, size=(C - 2, 3))
    ptx = np.asarray(ms.pt_xyz).copy()
    ptx[:n_pts] += rng.normal(scale=0.05, size=(n_pts, 3))
    return ms._replace(kf_pose=jnp.asarray(kfp), pt_xyz=jnp.asarray(ptx))


def reproj_err(kf_pose, pt_xyz, kf_point, kf_uv, n_kf=6):
    from rumi_slam_tpu.geometry import camera

    tot, n = 0.0, 0
    for i in range(n_kf):
        sel = kf_point[i] >= 0
        uv, _ = camera.project_world(jK, jnp.asarray(kf_pose[i]),
                                     jnp.asarray(pt_xyz[kf_point[i][sel]]))
        tot += float(np.sum(np.linalg.norm(np.asarray(uv) - kf_uv[i][sel], axis=-1)))
        n += int(sel.sum())
    return tot / max(n, 1)


def test_sharded_gba_on_mapstate_matches_jax():
    jms = mapstate_problem()
    d = {k: np.asarray(v) for k, v in jms._asdict().items()}
    tms = tM.from_numpy(d, device="cpu")
    j2 = jLM.global_bundle_adjustment(jms, jK, 0, n_iters=10, mesh=jax_mesh(4))
    t2 = tLM.global_bundle_adjustment(tms, tK, 0, n_iters=10, mesh=tD.BaMesh("cpu", 4))
    kp, uv = d["kf_point"], d["kf_uv"]
    e0 = reproj_err(d["kf_pose"], d["pt_xyz"], kp, uv)
    ej = reproj_err(np.asarray(j2.kf_pose), np.asarray(j2.pt_xyz), kp, uv)
    et = reproj_err(t2.kf_pose.numpy(), t2.pt_xyz.numpy(), kp, uv)
    assert ej < 0.25 * e0 and et < 0.25 * e0, (e0, ej, et)
    assert np.abs(t2.kf_pose.numpy() - np.asarray(j2.kf_pose)).max() <= POSE_ATOL
    assert np.abs(t2.pt_xyz.numpy() - np.asarray(j2.pt_xyz)).max() <= POINT_ATOL
    # only the map's rows move
    np.testing.assert_array_equal(t2.kf_pose[6:].numpy(), tms.kf_pose[6:].numpy())
    np.testing.assert_array_equal(t2.pt_xyz[128:].numpy(), tms.pt_xyz[128:].numpy())


def test_sharded_gba_logs_dropped_observations(capsys, monkeypatch):
    """More observations of a point than ``max_obs_per_point``: dropped with
    a log line, the solve still runs."""
    from rumi_slam_tpu_torch.utils import verbose

    tms = tM.from_numpy({k: np.asarray(v) for k, v in mapstate_problem()._asdict().items()},
                        device="cpu")
    monkeypatch.setattr(verbose, "_threshold", verbose.Level.QUIET)
    out = tLM._global_ba_sharded(tms, tK, 0, tD.BaMesh("cpu", 2), n_iters=2,
                                 max_obs_per_point=2)
    assert "[gba] sharded GBA dropped" in capsys.readouterr().err
    assert torch.isfinite(out.kf_pose).all() and torch.isfinite(out.pt_xyz).all()


# ----------------------------------------------------------------- coordinator

@pytest.mark.parametrize("mesh", [None, tD.BaMesh("cpu", 4)])
def test_coordinator_routes_gba_through_ba_mesh(monkeypatch, mesh):
    seen = []

    def fake_gba(ms, K, map_id, *, n_iters, mesh=None):
        seen.append((map_id, n_iters, mesh))
        return ms

    monkeypatch.setattr(tD, "ba_mesh", lambda: mesh)
    monkeypatch.setattr(tCo, "global_bundle_adjustment", fake_gba)
    ms, kind = tCo.post_merge_gba("ms", tK, 3, n_iters=7)
    assert ms == "ms" and seen == [(3, 7, mesh)]
    assert kind == ("dense" if mesh is None else "pcg")


# ----------------------------------------------------------------- the scaling bench

def _load_tool(name):
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "tools" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_tool_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_scaling_bench_problem_matches_jax(monkeypatch):
    """``tools/scaling_bench_torch.py`` builds and perturbs the JAX bench's
    problem (here at 16 cameras x 512 points), and its CPU run gives the
    same cost at D=1 and D=2."""
    jb, tb = _load_tool("scaling_bench"), _load_tool("scaling_bench_torch")
    size = dict(N_CAMS=16, N_PTS=512, OBS_PER_PT=8)
    for k, v in size.items():
        monkeypatch.setattr(jb, k, v)
    jK_, jp, jX, jcam, juv, jconf = jb.build_problem()
    jpn, jXn = jb.perturb(jp, jX)
    tK_, tp, tX, tcam, tuv, tconf = tb.build_problem(n_cams=16, n_pts=512, obs_per_pt=8,
                                                     device="cpu")
    tpn, tXn = tb.perturb(tp, tX)
    np.testing.assert_array_equal(tK_.numpy(), np.asarray(jK_))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tX, jX)
    np.testing.assert_array_equal(tcam, jcam)
    np.testing.assert_allclose(tuv, juv, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(tconf, jconf)
    np.testing.assert_allclose(tpn.numpy(), np.asarray(jpn), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tXn, jXn, rtol=0, atol=1e-6)
    for D in (1, 3):
        for j, t in zip(jb.shard_arrays(jX, jcam, juv, jconf, D),
                        tb.shard_arrays(jX, jcam, juv, jconf, D)):
            np.testing.assert_array_equal(t, j)
    res = tb.run("cpu", n_cams=16, n_pts=512, shards=(1, 2), reps=1)
    c1, c2 = (r["cost"] for r in res["one_card_shard_rows"])
    assert res["device"] == "cpu" and res["problem"]["obs"] == 512 * 8
    assert abs(c1 - c2) <= 1e-4 * c1, (c1, c2)
    assert [r["points_on_device"] for r in res["work_scaling_rows"]] == [512, 256]
