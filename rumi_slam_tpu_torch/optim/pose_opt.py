"""Motion-only bundle adjustment: one SE(3) pose vs fixed 3D points (port of
``rumi_slam_tpu/optim/pose_opt.py``): monocular, and stereo/RGB-D with a
third residual row.

The JAX ``lax.scan``s become Python loops over a fixed schedule.  Accept and
damping decisions stay on the device as ``torch.where`` selections, and the
6x6 solve is ``torch.linalg.solve_ex``, so the loop never waits for the
device: ``torch.linalg.solve`` would check its info and sync the host on
each of the iterations.

On the card the monocular loop is some 6,500 small kernels for 3 x 6
iterations, and queuing them costs far more host time than the device needs
to run them.  So ``pose_optimization`` captures the loop once per thread,
problem size, schedule and algorithm mode into a CUDA graph and replays it
on every later call: the same kernels in the same order on the same shapes,
so the results equal the eager loop's bit for bit.  A thread copies its
inputs in and replays on a stream of its own, ordered after and before the
caller's stream, so one graph serves the thread whatever stream is current.
On the CPU the loop runs eagerly.  The module's ``captures`` counts the
graphs captured; ``prepare`` captures a system's shapes up front.
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import torch

from ..geometry import camera, lie
from ..utils.profiling import stage
from . import robust

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


class PoseOptResult(NamedTuple):
    pose: torch.Tensor       # [7]
    inliers: torch.Tensor    # [N] bool
    n_inliers: torch.Tensor  # scalar int32
    cost: torch.Tensor       # scalar


def _normal_equations(K, pose, X, uv, w, inv_sigma2):
    r, J, _, depth = camera.reproj_residual_and_jacobians(K, pose, X, uv)
    chi2 = torch.sum(r * r, dim=-1) * inv_sigma2
    w_rob = robust.huber_weight(chi2, CHI2_MONO) * inv_sigma2
    ww = w * w_rob * (depth > 0.05)
    H = torch.einsum("nki,n,nkj->ij", J, ww, J)
    g = torch.einsum("nki,n,nk->i", J, ww, r)
    cost = torch.sum(w * robust.huber_cost(chi2, CHI2_MONO))
    return H, g, cost, chi2


def _lm_loop(K, pose0, X_w, uv, valid, inv_sigma2, n_rounds: int, n_iters: int):
    """The mathematics of :func:`pose_optimization`, for both of its paths."""
    dev = X_w.device
    w0 = valid.to(torch.float32)
    eye = torch.eye(6, dtype=torch.float32, device=dev)

    pose, w = pose0, w0
    cost = None
    for _ in range(n_rounds):
        lam = torch.full((), 1e-3, dtype=torch.float32, device=dev)
        cost = torch.full((), float("inf"), dtype=torch.float32, device=dev)
        for _ in range(n_iters):
            H, g, cost_cur, _ = _normal_equations(K, pose, X_w, uv, w, inv_sigma2)
            Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-9 * eye
            tau = -torch.linalg.solve_ex(Hd, g)[0]
            cand = lie.se3_retract(pose, tau)
            _, _, cost_new, _ = _normal_equations(K, cand, X_w, uv, w, inv_sigma2)
            accept = cost_new < cost_cur
            pose = torch.where(accept, cand, pose)
            lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-8, 1e6)
            cost = torch.where(accept, cost_new, cost_cur)
        r, _, _, depth = camera.reproj_residual_and_jacobians(K, pose, X_w, uv)
        chi2 = torch.sum(r * r, dim=-1) * inv_sigma2
        w = w0 * ((chi2 <= CHI2_MONO) & (depth > 0.05)).to(torch.float32)

    inliers = w > 0
    return PoseOptResult(
        pose=pose,
        inliers=inliers,
        n_inliers=torch.sum(inliers.to(torch.int32)),
        cost=cost,
    )


captures = 0    # graphs captured in the process

_local = threading.local()        # .graphs: key -> _Graph, .sides: device -> stream
_capture_lock = threading.Lock()  # one capture at a time in the process


def _side_stream(dev):
    """This thread's stream for the graphs of ``dev``: every capture and
    replay of the thread runs on it, whatever stream is current."""
    sides = getattr(_local, "sides", None)
    if sides is None:
        sides = _local.sides = {}
    side = sides.get(dev)
    if side is None:
        side = sides[dev] = torch.cuda.Stream(dev)
    return side


class _Graph:
    """One captured loop: static inputs (K, pose0, X_w, uv, valid,
    inv_sigma2), the graph, and the static outputs it writes."""

    def __init__(self, args, n_rounds, n_iters, side):
        global captures
        dev = args[2].device
        self.inputs = [torch.empty(a.shape, dtype=a.dtype, device=dev) for a in args[:5]]
        self.inputs.append(torch.empty((args[2].shape[0],), dtype=_weight_dtype(args[5]),
                                       device=dev))
        self.graph = torch.cuda.CUDAGraph()
        side.wait_stream(torch.cuda.current_stream(dev))
        with _capture_lock, torch.cuda.stream(side):
            self._load(args)
            # the warm-up makes the side stream's library handles and
            # workspaces before the capture
            _lm_loop(*self.inputs, n_rounds, n_iters)
            with torch.cuda.graph(self.graph, stream=side, capture_error_mode="thread_local"):
                self.out = _lm_loop(*self.inputs, n_rounds, n_iters)
            captures += 1

    def _load(self, args):
        # few calls: under a busy worker thread each one may wait for the interpreter
        if args[5] is None:
            torch._foreach_copy_(self.inputs[:5], list(args[:5]))
            self.inputs[5].fill_(1.0)
        else:
            torch._foreach_copy_(self.inputs, list(args))

    def __call__(self, args, side):
        cur = torch.cuda.current_stream(side.device)
        side.wait_stream(cur)      # the inputs, and the last call's clones
        with torch.cuda.stream(side):
            self._load(args)
            self.graph.replay()
        cur.wait_stream(side)
        # the callers keep results across calls: never hand out the static outputs
        return PoseOptResult(*(t.clone() for t in self.out))


def _weight_dtype(inv_sigma2):
    return torch.float32 if inv_sigma2 is None else inv_sigma2.dtype


def _graph(args, n_rounds, n_iters):
    """This thread's graph of the loop for the problem's size, types and
    schedule and for the algorithms in force (the deterministic ones capture
    other kernels), captured on the first call that needs it."""
    X_w = args[2]
    key = (X_w.device, X_w.shape[0],
           tuple(a.dtype for a in args[:5]) + (_weight_dtype(args[5]),), n_rounds, n_iters,
           torch.are_deterministic_algorithms_enabled())
    graphs = getattr(_local, "graphs", None)
    if graphs is None:
        graphs = _local.graphs = {}
    side = _side_stream(X_w.device)
    g = graphs.get(key)
    if g is None:
        g = graphs[key] = _Graph(args, n_rounds, n_iters, side)
    return g, side


def prepare(device, n: int, schedules):
    """Capture this thread's graphs for problems of ``n`` observations under
    each ``(n_rounds, n_iters)`` of ``schedules`` now, so that no later call
    pays for a capture (a no-op off the card)."""
    device = torch.device(device)
    if device.type != "cuda":
        return
    args = (torch.zeros(4, device=device), torch.zeros(7, device=device),
            torch.zeros(n, 3, device=device), torch.zeros(n, 2, device=device),
            torch.zeros(n, dtype=torch.bool, device=device), None)
    for n_rounds, n_iters in schedules:
        _graph(args, n_rounds, n_iters)


def pose_optimization(K, pose0, X_w, uv, valid, inv_sigma2=None, *,
                      n_rounds: int = 4, n_iters: int = 10, timer=None):
    """Optimize a single camera pose against fixed world points.

    Args:
      K: [4] intrinsics.  pose0: [7] initial T_cw.  X_w: [N, 3] fixed world
      points.  uv: [N, 2] observations.  valid: [N] bool.
      inv_sigma2: [N] per-observation information; None = 1.
      timer: an optional ``StageTimer``; a call answered by a CUDA graph is
      its ``pose_opt_graph`` stage.

    ``n_rounds`` rounds of ``n_iters`` LM iterations, with chi-square
    (5.991) outlier re-classification after each round.  Returns
    PoseOptResult; ``inliers`` is the classification at the final pose.
    Tensors on the card run a CUDA graph of the loop (module docstring);
    the results are new tensors either way.
    """
    if X_w.device.type == "cuda":
        args = (K, pose0, X_w, uv, valid, inv_sigma2)
        with stage(timer, "pose_opt_graph"):
            g, side = _graph(args, n_rounds, n_iters)
            return g(args, side)
    if inv_sigma2 is None:
        inv_sigma2 = torch.ones((X_w.shape[0],), dtype=torch.float32, device=X_w.device)
    return _lm_loop(K, pose0, X_w, uv, valid, inv_sigma2, n_rounds, n_iters)


def _normal_equations_stereo(K, bf, pose, X, uv, ur, w, inv_sigma2):
    """3-row residual variant: the u_r row is weighted 0 where ur < 0 (a mono
    observation), with the stereo chi2 gate 7.815 on rows that have it."""
    has_ur = ur >= 0
    r, J, _, depth = camera.reproj_residual_and_jacobians_stereo(
        K, bf, pose, X, uv, torch.clamp_min(ur, 0.0))
    ones = torch.ones_like(ur)
    row_w = torch.stack([ones, ones, has_ur.to(torch.float32)], dim=1)
    chi2 = torch.sum(r * r * row_w, dim=-1) * inv_sigma2
    th = torch.where(has_ur, CHI2_STEREO, CHI2_MONO)
    w_rob = robust.huber_weight(chi2, th) * inv_sigma2
    ww = w * w_rob * (depth > 0.05)
    Jw = J * row_w[:, :, None]
    H = torch.einsum("nki,n,nkj->ij", Jw, ww, J)
    g = torch.einsum("nki,n,nk->i", Jw, ww, r)
    cost = torch.sum(w * robust.huber_cost(chi2, th))
    return H, g, cost, chi2, depth


def pose_optimization_stereo(K, bf, pose0, X_w, uv, ur, valid, inv_sigma2=None, *,
                             n_rounds: int = 4, n_iters: int = 10):
    """Stereo/RGB-D motion-only BA: :func:`pose_optimization` with a third
    residual row u_r = u - bf / z on the observations where ``ur >= 0``, and
    the outlier gate per row (7.815 with it, 5.991 without)."""
    n = X_w.shape[0]
    dev = X_w.device
    if inv_sigma2 is None:
        inv_sigma2 = torch.ones((n,), dtype=torch.float32, device=dev)
    bf = torch.as_tensor(bf, dtype=torch.float32, device=dev)
    w0 = valid.to(torch.float32)
    th = torch.where(ur >= 0, CHI2_STEREO, CHI2_MONO)
    eye = torch.eye(6, dtype=torch.float32, device=dev)

    pose, w = pose0, w0
    cost = None
    for _ in range(n_rounds):
        lam = torch.full((), 1e-3, dtype=torch.float32, device=dev)
        cost = torch.full((), float("inf"), dtype=torch.float32, device=dev)
        for _ in range(n_iters):
            H, g, cost_cur, _, _ = _normal_equations_stereo(K, bf, pose, X_w, uv, ur, w,
                                                            inv_sigma2)
            Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-9 * eye
            tau = -torch.linalg.solve_ex(Hd, g)[0]
            cand = lie.se3_retract(pose, tau)
            _, _, cost_new, _, _ = _normal_equations_stereo(K, bf, cand, X_w, uv, ur, w,
                                                            inv_sigma2)
            accept = cost_new < cost_cur
            pose = torch.where(accept, cand, pose)
            lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-8, 1e6)
            cost = torch.where(accept, cost_new, cost_cur)
        _, _, _, chi2, depth = _normal_equations_stereo(K, bf, pose, X_w, uv, ur, w, inv_sigma2)
        w = w0 * ((chi2 <= th) & (depth > 0.05)).to(torch.float32)

    inliers = w > 0
    return PoseOptResult(
        pose=pose,
        inliers=inliers,
        n_inliers=torch.sum(inliers.to(torch.int32)),
        cost=cost,
    )
