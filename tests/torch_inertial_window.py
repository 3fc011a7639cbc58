"""A visual-inertial window at ORB-SLAM3's local inertial BA size, for the
port's inertial solvers on the card against the CPU (``chip_smoke.py``
phase 12 (c), ``tests/test_torch_cuda.py``).

``window(seed)`` simulates a body flying a smooth curve with the discrete
model the preintegration integrates (so the inertial residuals vanish at the
true states), samples a 200 Hz IMU (``steps`` samples an interval between
keyframes) and world points in front of the cameras, and returns numpy
inputs for the three solvers:

* ``visual_inertial_ba``: ``n_kf`` keyframes (the first held fixed),
  ``n_points`` points, each seen by at least ``obs_per_point`` keyframes and
  observed by that many drawn at random among them, 0.5 px noise, perturbed
  states and points (a point observed once or twice has a free depth, and
  the point step can carry it behind the camera);
* ``pose_inertial_optimization``: the last keyframe against the one before
  it, ``n_pose_points`` of the points, a perturbed current state;
* ``inertial_only_optimization``: the keyframes' true orientations and
  positions divided by a scale of 2.5.

``to_device(win, device)`` makes tensors of them and preintegrates the IMU on
that device.  The module imports only numpy at its top; the port where used.
"""

from __future__ import annotations

import numpy as np

K = np.array([525.0, 525.0, 319.5, 239.5], np.float32)
WIDTH, HEIGHT = 640, 480
TRUE_SCALE = 2.5


def _simulate(n_kf, steps, dt, rng):
    import torch

    from rumi_slam_tpu_torch.geometry import lie

    g_w = np.array([0.0, 0.0, -9.81])
    q, p, v = np.array([1.0, 0, 0, 0]), np.zeros(3), np.array([0.3, -0.1, 0.05])
    states = [(q.copy(), p.copy(), v.copy())]
    gyro, acc = [], []
    for k in range(n_kf - 1):
        for s in range(steps):
            i = k * steps + s
            w_b = np.array([0.2 * np.sin(0.02 * i), 0.1, -0.05])
            a_w = np.array([0.8 * np.cos(0.01 * i), -0.5, 0.3])
            R = lie.quat_to_matrix(torch.tensor(q, dtype=torch.float32)).double().numpy()
            gyro.append(w_b)
            acc.append(R.T @ (a_w - g_w))
            p = p + v * dt + 0.5 * a_w * dt * dt
            v = v + a_w * dt
            dq = lie.so3_exp(torch.tensor(w_b * dt, dtype=torch.float32))
            q = lie.quat_normalize(lie.quat_mul(torch.tensor(q, dtype=torch.float32), dq)
                                   ).double().numpy()
        states.append((q.copy(), p.copy(), v.copy()))
    qs, ps, vs = (np.stack([s[j] for s in states]).astype(np.float32) for j in range(3))
    shape = (n_kf - 1, steps, 3)
    imu = (np.asarray(gyro, np.float32).reshape(shape), np.asarray(acc, np.float32).reshape(shape),
           np.full(shape[:2], dt, np.float32))
    return qs, ps, vs, imu


def _project(qs, ps, X):
    """Pixels [N, M, 2] and depths [N, M] of world points X [M, 3] from body
    poses (camera = body)."""
    import torch

    from rumi_slam_tpu_torch.geometry import camera, lie

    T_cw = lie.se3_inverse(lie.se3(torch.from_numpy(qs), torch.from_numpy(ps)))
    pc = lie.se3_apply(T_cw[:, None, :], torch.from_numpy(X)[None])
    return camera.project(torch.from_numpy(K), pc).numpy(), pc[..., 2].numpy()


def _rotate(q, d):
    """q * exp(d) for quaternions q [..., 4] and rotation vectors d [..., 3]."""
    import torch

    from rumi_slam_tpu_torch.geometry import lie

    return lie.quat_normalize(lie.quat_mul(torch.from_numpy(np.asarray(q, np.float32)), lie.so3_exp(
        torch.from_numpy(np.asarray(d, np.float32))))).numpy()


def window(seed=0, *, n_kf=10, steps=50, dt=0.005, n_points=2000, obs_per_point=8,
           n_pose_points=1024, noise_px=0.5):
    rng = np.random.default_rng(seed)
    qs, ps, vs, imu = _simulate(n_kf, steps, dt, rng)
    X = rng.uniform([-3.0, -2.2, 4.0], [3.5, 2.2, 9.0], (3 * n_points, 3)).astype(np.float32)
    uv_all, z_all = _project(qs, ps, X)
    seen = ((z_all > 0.5) & (uv_all[..., 0] >= 0) & (uv_all[..., 0] < WIDTH)
            & (uv_all[..., 1] >= 0) & (uv_all[..., 1] < HEIGHT))
    keep = np.nonzero(seen.sum(0) >= obs_per_point)[0][:n_points]
    if len(keep) < n_points:
        raise ValueError(f"only {len(keep)} points are seen by {obs_per_point} keyframes")
    X, uv_all, seen = X[keep], uv_all[:, keep], seen[:, keep]
    cam_idx, pt_idx = [], []
    for j in range(n_points):
        take = rng.permutation(np.nonzero(seen[:, j])[0])[:obs_per_point]
        cam_idx += sorted(take.tolist())
        pt_idx += [j] * len(take)
    cam_idx, pt_idx = np.asarray(cam_idx, np.int32), np.asarray(pt_idx, np.int32)
    uv = (uv_all[cam_idx, pt_idx] + noise_px * rng.normal(size=(len(cam_idx), 2))).astype(np.float32)

    def perturb(q, scale):
        d = scale * rng.normal(size=(len(q), 3))
        d[0] = 0
        return _rotate(q, d)

    pert = rng.normal(size=(2, n_kf, 3)).astype(np.float32)
    pert[:, 0] = 0
    sel = rng.choice(n_points, n_pose_points, replace=False)
    uv_pose, z_pose = _project(qs[-1:], ps[-1:], X[sel])
    win = dict(
        imu=imu, qs=qs, ps=ps, vs=vs, X=X,
        q0=perturb(qs, 0.01), p0=ps + 0.03 * pert[0], v0=vs + 0.05 * pert[1],
        X0=(X + 0.03 * rng.normal(size=X.shape)).astype(np.float32),
        cam_idx=cam_idx, pt_idx=pt_idx, uv=uv, conf=np.ones(len(uv), np.float32),
        kf_free=np.arange(n_kf) > 0,
        pose_X=X[sel],
        pose_uv=(uv_pose[0] + noise_px * rng.normal(size=(n_pose_points, 2))).astype(np.float32),
        pose_valid=(z_pose[0] > 0.5),
        # the perturbation of tests/test_inertial.py::test_pose_inertial_optimization_recovers_pose
        pose_q0=_rotate(qs[-1], [0.03, -0.02, 0.01]),
        pose_p0=ps[-1] + np.float32([0.05, -0.04, 0.06]),
        pose_v0=vs[-1] + np.float32([0.2, 0.1, -0.15]),
    )
    return win


def to_device(win, device):
    """Tensors of ``win`` on ``device``, with the IMU preintegrated there
    (one batched call over the keyframe intervals)."""
    import torch

    from rumi_slam_tpu_torch.inertial import preintegration as P

    t = {k: torch.from_numpy(np.array(v)).to(device) for k, v in win.items() if k != "imu"}
    gyro, acc, dts = (torch.from_numpy(x).to(device) for x in win["imu"])
    t["pres"] = P.preintegrate(gyro, acc, dts, P.zero_bias(device=device))
    return t


def solvers(t, device):
    """The three solvers on the window's tensors ``t`` (on ``device``), each
    a callable of no arguments: ``inertial_only`` (20 iterations) and
    ``inertial_only_0`` (0 iterations: the cost at the start),
    ``pose_inertial`` (30 iterations: Huber-weighted pixel rows take about 27
    to converge from the perturbation) and ``visual_inertial_ba`` (8, the JAX
    package's default)."""
    import torch

    from rumi_slam_tpu_torch.geometry import lie
    from rumi_slam_tpu_torch.inertial import inertial_ba as iba
    from rumi_slam_tpu_torch.inertial import preintegration as P

    Kt = torch.from_numpy(K).to(device)
    T_cb = lie.se3_identity(device=device)
    pres = t["pres"]
    last = P.Preintegrated(*(x[-1] for x in pres[:-1]), P.ImuBias(*(b[-1] for b in pres.bias)))
    z = torch.zeros_like(t["v0"])
    pt_free = torch.ones(len(t["X0"]), dtype=torch.bool, device=device)
    return {
        "inertial_only": lambda: iba.inertial_only_optimization(
            t["qs"], t["ps"] / TRUE_SCALE, pres, n_iters=20),
        "inertial_only_0": lambda: iba.inertial_only_optimization(
            t["qs"], t["ps"] / TRUE_SCALE, pres, n_iters=0),
        "pose_inertial": lambda: iba.pose_inertial_optimization(
            Kt, T_cb, t["qs"][-2], t["ps"][-2], t["vs"][-2], last, t["pose_q0"], t["pose_p0"],
            t["pose_v0"], P.zero_bias(device=device), t["pose_X"], t["pose_uv"],
            t["pose_valid"], n_iters=30),
        "visual_inertial_ba": lambda: iba.visual_inertial_ba(
            Kt, T_cb, t["q0"], t["p0"], t["v0"], z, z, pres, t["X0"], t["cam_idx"],
            t["pt_idx"], t["uv"], t["conf"], t["kf_free"], pt_free, n_iters=8),
    }


def solve_all(t, device):
    """Every solver of ``solvers`` once: {name: result}."""
    return {name: fn() for name, fn in solvers(t, device).items()}
