"""Sim(3) pose-graph (essential-graph) optimisation (port of
``rumi_slam_tpu/optim/pose_graph.py``).

Gauss-Newton over per-keyframe Sim(3) vertices with relative-pose residuals
on sequential, covisibility and loop edges, then point correction by each
point's reference keyframe.  Edges are a fixed-capacity list (i, j, S_ij
measured [8], weight); the residual of edge (i, j) is
``log(S_ij^-1 * S_i * S_j^-1)`` in the Sim(3) tangent.

Jacobians: the JAX package takes ``jacfwd`` of the residual with respect to
the two endpoint tangents.  Here ``tangent_jacobians`` does the same with
PyTorch's forward-mode AD in ONE pass over all edges: the tangents get a
leading axis of basis directions (7 + 7 for the two endpoints), the ``lie``
functions broadcast over it, and the output tangent holds every column of
both 7x7 blocks.  The ``lie`` functions guard their small-angle branches
(``where`` on both the value and the branch input), so the derivative at an
identity rotation is finite.

The normal equations are assembled with ``index_add_`` / ``index_put(...,
accumulate=True)``: padding edges all sit on (0, 0) with weight 0 and a
covisibility edge can repeat a sequential one, so indices repeat and every
contribution must add.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from ..geometry import lie


class PoseGraphEdges(NamedTuple):
    i: torch.Tensor       # [E] int32
    j: torch.Tensor       # [E] int32
    S_ij: torch.Tensor    # [E,8] measured relative Sim3: S_i * S_j^-1
    weight: torch.Tensor  # [E] float32 (0 disables)


def relative_sim3(S_i, S_j):
    """S_ij = S_i * S_j^-1 (the measurement model)."""
    return lie.sim3_compose(S_i, lie.sim3_inverse(S_j))


def edge_residual(S_i, S_j, S_ij_meas):
    """[..., 7] tangent residual log(meas^-1 * S_i * S_j^-1)."""
    rel = relative_sim3(S_i, S_j)
    err = lie.sim3_compose(lie.sim3_inverse(S_ij_meas), rel)
    return lie.sim3_log(err)


def tangent_jacobians(residual_of, dims, batch_shape, *, dtype=torch.float32, device="cpu"):
    """Residual and its Jacobians with respect to tangents evaluated at 0.

    ``residual_of(*taus)`` takes one tangent per entry of ``dims`` (tangent
    ``n`` has shape ``[D, *batch_shape, dims[n]]`` with ``D = sum(dims)`` basis
    directions in front) and returns ``[D, *batch_shape, R]``.  Returns
    ``(r [*batch_shape, R], [J_n [*batch_shape, R, dims[n]] for n])``.
    """
    D = sum(dims)
    ones = (1,) * len(batch_shape)
    taus, off = [], 0
    with fwAD.dual_level():
        for d in dims:
            primal = torch.zeros((D,) + tuple(batch_shape) + (d,), dtype=dtype, device=device)
            basis = torch.zeros((D, d), dtype=dtype, device=device)
            basis[off:off + d] = torch.eye(d, dtype=dtype, device=device)
            tangent = basis.reshape((D,) + ones + (d,)).expand_as(primal).contiguous()
            taus.append(fwAD.make_dual(primal, tangent))
            off += d
        r, dr = fwAD.unpack_dual(residual_of(*taus))
    if dr is None:
        dr = torch.zeros_like(r)
    nb = len(batch_shape)
    J = dr.permute(tuple(range(1, nb + 2)) + (0,))      # [*batch, R, D]
    return r[0], list(torch.split(J, list(dims), dim=-1))


def build_edges_from_covisibility(kf_sim3, covis_weights, kf_valid, *,
                                  min_weight: int = 100, max_edges: int = 2048,
                                  seq_window: int = 1):
    """The essential-graph edge list: sequential edges plus strong
    covisibility edges (weight >= ``min_weight``), in slot order, cut at
    ``max_edges`` and padded to it.  The list is built on the host from one
    copy of ``covis_weights`` and ``kf_valid``; all measurements come from one
    batched ``relative_sim3``."""
    dev = kf_sim3.device
    Wc = torch.as_tensor(covis_weights).detach().cpu().numpy()
    valid = torch.as_tensor(kf_valid).detach().cpu().numpy().astype(bool)
    K = Wc.shape[0]
    edges = []
    for a in np.flatnonzero(valid):
        a = int(a)
        for step in range(1, seq_window + 1):
            b = a + step
            if b < K and valid[b]:
                edges.append((a, b, 1.0))
        row = Wc[a, a + 1:]
        for b in np.flatnonzero(valid[a + 1:] & (row >= min_weight)):
            edges.append((a, a + 1 + int(b), float(row[b]) / 100.0))
        if len(edges) >= max_edges:
            break
    edges = edges[:max_edges]
    E = max_edges
    i = np.zeros(E, np.int32)
    j = np.zeros(E, np.int32)
    w = np.zeros(E, np.float32)
    for n, (a, b, ww) in enumerate(edges):
        i[n], j[n], w[n] = a, b, ww
    i_t = torch.from_numpy(i).to(dev)
    j_t = torch.from_numpy(j).to(dev)
    w_t = torch.from_numpy(w).to(dev)
    S = relative_sim3(kf_sim3[i_t.long()], kf_sim3[j_t.long()])
    S = torch.where((w_t > 0)[:, None], S,
                    lie.sim3_identity(dtype=kf_sim3.dtype, device=dev))
    return PoseGraphEdges(i=i_t, j=j_t, S_ij=S, weight=w_t)


def _gauss_newton(x, ei, ej, w, fixed, residual_of, retract, dim, n_iters, lam0):
    """The damped Gauss-Newton loop shared by the Sim(3) and the 4-DoF graph.

    ``residual_of(tau_i, tau_j, x_i, x_j)``: residual [..., R] of the edges for
    endpoint states retracted by the tangents; ``retract(x, dx)``.
    """
    K = x.shape[0]
    dt, dev = x.dtype, x.device
    E = ei.shape[0]
    free = (~fixed).to(dt)
    eye = torch.eye(dim, dtype=dt, device=dev)
    diag = torch.arange(K, device=dev)
    z = torch.zeros((E, dim), dtype=dt, device=dev)

    def segsum(v, idx):
        return torch.zeros((K,) + v.shape[1:], dtype=dt, device=dev).index_add_(0, idx, v)

    lam = torch.full((), lam0, dtype=dt, device=dev)
    for _ in range(n_iters):
        xi, xj = x[ei], x[ej]
        r, (Ji, Jj) = tangent_jacobians(
            lambda ti, tj: residual_of(ti, tj, xi, xj), (dim, dim), (E,), dtype=dt, device=dev)

        Hii = segsum(torch.einsum("eki,e,ekj->eij", Ji, w, Ji), ei)
        Hjj = segsum(torch.einsum("eki,e,ekj->eij", Jj, w, Jj), ej)
        bi = segsum(torch.einsum("eki,e,ek->ei", Ji, w, r), ei)
        bj = segsum(torch.einsum("eki,e,ek->ei", Jj, w, r), ej)
        Hij = torch.einsum("eki,e,ekj->eij", Ji, w, Jj)

        # dense H as [K, K, dim, dim] blocks; repeated (i, j) accumulate
        H = torch.zeros((K, K, dim, dim), dtype=dt, device=dev)
        H = H.index_put((diag, diag), Hii + Hjj, accumulate=True)
        H = H.index_put((ei, ej), Hij, accumulate=True)
        H = H.index_put((ej, ei), Hij.transpose(-1, -2), accumulate=True)
        b = bi + bj

        # anchors: identity rows/cols, zero rhs
        H = H * free[:, None, None, None] * free[None, :, None, None]
        H = H.index_put((diag, diag), eye * (1.0 - free)[:, None, None] + lam * eye,
                        accumulate=True)
        b = b * free[:, None]

        Hd = H.permute(0, 2, 1, 3).reshape(K * dim, K * dim)
        Hd = Hd + 1e-8 * torch.eye(K * dim, dtype=dt, device=dev)
        dx = -torch.linalg.solve_ex(Hd, b.reshape(K * dim))[0].reshape(K, dim)
        dx = dx * free[:, None]

        x_new = retract(x, dx)
        cost0 = torch.sum(w * torch.sum(r * r, dim=-1))
        r1 = residual_of(z, z, x_new[ei], x_new[ej])
        cost1 = torch.sum(w * torch.sum(r1 * r1, dim=-1))
        accept = cost1 < cost0
        x = torch.where(accept, x_new, x)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 5.0), 1e-8, 1e2)
    return x


def optimize_pose_graph(kf_sim3, edges: PoseGraphEdges, fixed, *, n_iters: int = 10,
                        lam0: float = 1e-4):
    """Gauss-Newton over Sim(3) vertices.

    Args:
      kf_sim3: [K, 8] per-KF world->camera Sim3.
      edges: the measurement list (weight 0 pads).
      fixed: [K] bool, the anchored vertices.
    Returns the optimised [K, 8].
    """
    def residual_of(ti, tj, Si, Sj):
        return edge_residual(lie.sim3_retract(Si, ti), lie.sim3_retract(Sj, tj), edges.S_ij)

    return _gauss_newton(kf_sim3, edges.i.long(), edges.j.long(), edges.weight, fixed,
                         residual_of, lie.sim3_retract, 7, n_iters, lam0)


class PoseGraphEdgesSE3(NamedTuple):
    """SE(3) edge list for the 4-DoF pose graph."""

    i: torch.Tensor       # [E] int32
    j: torch.Tensor       # [E] int32
    T_ij: torch.Tensor    # [E,7] measured relative SE3: T_i * T_j^-1
    weight: torch.Tensor  # [E] float32 (0 disables)


def _retract4(T, tau4):
    """Yaw + translation update: tau6 = (0, 0, yaw, v) under ``se3_retract``."""
    return lie.se3_retract(T, torch.cat([torch.zeros_like(tau4[..., :2]), tau4], dim=-1))


def optimize_pose_graph_4dof(kf_se3, edges: PoseGraphEdgesSE3, fixed, *, n_iters: int = 10,
                             lam0: float = 1e-4):
    """4-DoF pose graph for gravity-aligned maps: roll and pitch are
    observable, so each vertex optimises yaw and translation only.

    Args:
      kf_se3: [K, 7] per-KF T_cw.
      fixed:  [K] bool anchors.
    Returns the optimised [K, 7].
    """
    def residual_of(ti, tj, Ti, Tj):
        rel = lie.se3_compose(_retract4(Ti, ti), lie.se3_inverse(_retract4(Tj, tj)))
        return lie.se3_log(lie.se3_compose(lie.se3_inverse(edges.T_ij), rel))

    return _gauss_newton(kf_se3, edges.i.long(), edges.j.long(), edges.weight, fixed,
                         residual_of, _retract4, 4, n_iters, lam0)


def correct_points(pt_xyz, pt_ref_kf, pt_valid, kf_sim3_old, kf_sim3_new):
    """Move points with their reference KF after the graph optimisation:
    X' = S_new_ref^-1 (S_old_ref (X))."""
    ref = pt_ref_kf.clamp_min(0).long()
    moved = lie.sim3_apply(lie.sim3_inverse(kf_sim3_new[ref]),
                           lie.sim3_apply(kf_sim3_old[ref], pt_xyz))
    return torch.where((pt_valid & (pt_ref_kf >= 0))[:, None], moved, pt_xyz)
