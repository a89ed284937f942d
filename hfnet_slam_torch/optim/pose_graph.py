"""Pose-graph optimization over Sim(3): the essential graph.

Counterpart of hfnet_slam_tpu/optim/pose_graph.py (the reference's
Optimizer::OptimizeEssentialGraph and its inertial 4-DoF variant): padded
edge arrays, per-edge 7-d residuals r = log_sim3(S_meas S_i S_j^-1) with
Jacobians from forward-mode autodiff (torch.func.jacfwd under vmap for the
reference's jax.jacfwd under vmap; evaluated in float64, because forward
mode gives a 0-dim float32 primal times a Python scalar a float64 tangent
and the mixed matmul then refuses), normal equations accumulated with
`index_add_` (the reference's segment_sum) into a dense (7K, 7K) system.
The solve is `torch.linalg.solve_ex`: no host-side error check per
iteration; a non-finite step is refused by the per-step finiteness guard,
as in the reference.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import lie


class PoseGraphProblem(NamedTuple):
    """K Sim3 vertices (world->cam), E relative edges (padded)."""

    R: torch.Tensor        # (K,3,3)
    t: torch.Tensor        # (K,3)
    s: torch.Tensor        # (K,)
    fixed: torch.Tensor    # (K,) bool
    e_i: torch.Tensor      # (E,) int64 vertex i
    e_j: torch.Tensor      # (E,) int64 vertex j
    e_R: torch.Tensor      # (E,3,3) measured S_ji = S_j S_i^-1
    e_t: torch.Tensor      # (E,3)
    e_s: torch.Tensor      # (E,)
    e_w: torch.Tensor      # (E,) information weight
    e_valid: torch.Tensor  # (E,) bool


def _edge_residual(Ri, ti, si, Rj, tj, sj, Rm, tm, sm, xi_i, xi_j, right=False):
    """r = log_sim3(S_m (S_i + xi_i) (S_j + xi_j)^-1), 7-d. right=False:
    left perturbation exp(xi) S; right=True: S exp(xi), whose tangent acts
    on world coordinates (the 4-DoF graph masks phi_x, phi_y, sigma)."""
    dRi, dti, dsi = lie.sim3_exp(xi_i)
    dRj, dtj, dsj = lie.sim3_exp(xi_j)
    if right:
        R1, t1, s1 = lie.sim3_mul(Ri, ti, si, dRi, dti, dsi)
        R2, t2, s2 = lie.sim3_mul(Rj, tj, sj, dRj, dtj, dsj)
    else:
        R1, t1, s1 = lie.sim3_mul(dRi, dti, dsi, Ri, ti, si)
        R2, t2, s2 = lie.sim3_mul(dRj, dtj, dsj, Rj, tj, sj)
    Ra, ta, sa = lie.sim3_mul(Rm, tm, sm, R1, t1, s1)
    return lie.sim3_log(*lie.sim3_mul(Ra, ta, sa, *lie.sim3_inverse(R2, t2, s2)))


def _segment_sum(vals, ids, n):
    out = torch.zeros((n,) + vals.shape[1:], dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, ids, vals)


def optimize_pose_graph(prob: PoseGraphProblem, n_iters: int = 20, fix_scale: bool = False,
                        mode: str = "sim3"):
    """Gauss-Newton on the Sim3 pose graph with identity information
    matrices. fix_scale pins every vertex's scale; mode="4dof" pins roll,
    pitch and scale in the world frame (gravity fixes the horizon). Returns
    (problem with updated R, t, s; (n_iters,) costs)."""
    K = prob.R.shape[0]
    dt, dev = prob.R.dtype, prob.R.device
    right = mode == "4dof"
    pin_dofs = (3, 4, 6) if right else ((6,) if fix_scale else ())
    free = (~prob.fixed).to(dt)
    kk = torch.arange(K, device=dev)
    wv = prob.e_w * prob.e_valid.to(dt)
    zero14 = torch.zeros(14, dtype=torch.float64, device=dev)

    def per_edge(*pose_args):
        def f(xi2):
            return _edge_residual(*pose_args, xi2[:7], xi2[7:], right=right)
        return f(zero14), torch.func.jacfwd(f)(zero14)

    R, t, s = prob.R, prob.t, prob.s
    costs = []
    for _ in range(n_iters):
        i, j = prob.e_i, prob.e_j
        r, J = torch.func.vmap(per_edge)(*(x.double() for x in (
            R[i], t[i], s[i], R[j], t[j], s[j], prob.e_R, prob.e_t, prob.e_s)))
        r, J = r.to(dt), J.to(dt)
        Ji, Jj = J[..., :7], J[..., 7:]
        JiW, JjW = Ji * wv[:, None, None], Jj * wv[:, None, None]
        Hii = _segment_sum(JiW.transpose(1, 2) @ Ji, i, K)
        Hjj = _segment_sum(JjW.transpose(1, 2) @ Jj, j, K)
        b = (_segment_sum((JiW.transpose(1, 2) @ r[..., None])[..., 0], i, K)
             + _segment_sum((JjW.transpose(1, 2) @ r[..., None])[..., 0], j, K))
        Hij = _segment_sum(JiW.transpose(1, 2) @ Jj, i * K + j, K * K).reshape(K, K, 7, 7)
        H = torch.zeros((K, 7, K, 7), dtype=dt, device=dev)
        H[kk, :, kk, :] += Hii + Hjj
        H = H + Hij.permute(0, 2, 1, 3) + Hij.permute(1, 3, 0, 2)

        # gauge and DOF masking; a unit diagonal on pinned DOFs keeps the
        # system nonsingular
        H = H * free[:, None, None, None] * free[None, None, :, None]
        b = b * free[:, None]
        for d in pin_dofs:
            H[:, d, :, :] = 0.0
            H[:, :, :, d] = 0.0
            b[:, d] = 0.0
        Hf = H.reshape(K * 7, K * 7)
        pin = (torch.diagonal(Hf) <= 1e-12).to(dt)
        Hf = Hf + torch.diag(pin + 1e-6)
        dx = -torch.linalg.solve_ex(Hf, b.reshape(K * 7))[0].reshape(K, 7) * free[:, None]
        for d in pin_dofs:
            dx[:, d] = 0.0

        dR, dtr, ds = lie.sim3_exp(dx)
        if right:
            R_n, t_n, s_n = lie.sim3_mul(R, t, s, dR, dtr, ds)
        else:
            R_n, t_n, s_n = lie.sim3_mul(dR, dtr, ds, R, t, s)
        R_n = lie.orthonormalize(R_n)
        ok = torch.all(torch.isfinite(dx))
        R = torch.where(ok, R_n, R)
        t = torch.where(ok, t_n, t)
        s = torch.where(ok, s_n, s)
        costs.append(torch.sum(r * r * wv[:, None]))
    return prob._replace(R=R, t=t, s=s), torch.stack(costs)


def make_edges_from_poses(R, t, s, pairs, weights=None):
    """Measured relative Sim3 edges S_ji = S_j S_i^-1 from vertex poses
    (numpy) for the given (i, j) pairs. Returns numpy (R, t, s, w)."""
    pairs = np.asarray(pairs, np.int64)
    if weights is None:
        weights = np.ones(len(pairs), np.float32)
    i, j = pairs[:, 0], pairs[:, 1]

    def T(x):
        return torch.as_tensor(np.asarray(x, np.float32))

    Rm, tm, sm = lie.sim3_mul(T(R[j]), T(t[j]), T(s[j]),
                              *lie.sim3_inverse(T(R[i]), T(t[i]), T(s[i])))
    return Rm.numpy(), tm.numpy(), sm.numpy(), np.asarray(weights, np.float32)
