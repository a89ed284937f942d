"""Bundle adjustment with Schur-complement landmark elimination, on torch.

Counterpart of hfnet_slam_tpu/optim/ba.py: Levenberg-Marquardt over keyframe
SE3 poses and landmark positions with reprojection factors, landmarks
marginalized per point, chi-square outlier re-classification between rounds.

Edges are fixed-capacity tensors (kf_idx, pt_idx, uv, inv_sigma2, valid).
The reference's segment sums become `index_add_`, which on CUDA accumulates
with atomics: sums land in a run-dependent order, so results agree with the
reference to a relative tolerance, not bitwise. The camera-point coupling is
a dense (M, K, 6, 3) block tensor, so the reduced camera system
S = Hcc - W Hpp^-1 W^T is two batched products, solved densely.

A stereo rig's right-camera observations (the reference's ToBody edges) ride
the same engine: `cam_sel` routes each edge through the left camera or the
right one at (rig_R, rig_t) with the params_r intrinsics
(factors.reproj_depth_residual_rig). A problem without cam_sel takes the
plain residual, which the rig residual reduces to exactly at sel = 0.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import lie
from . import factors


class BAProblem(NamedTuple):
    """Fixed-shape BA problem: K keyframes, M points, E edges (padded).
    Edges with wz > 0 carry a depth row (stereo/RGB-D)."""

    poses_R: torch.Tensor     # (K,3,3) world->cam
    poses_t: torch.Tensor     # (K,3)
    fixed: torch.Tensor       # (K,) bool
    points: torch.Tensor      # (M,3)
    kf_idx: torch.Tensor      # (E,) int64
    pt_idx: torch.Tensor      # (E,) int64
    uv: torch.Tensor          # (E,2)
    inv_sigma2: torch.Tensor  # (E,)
    valid: torch.Tensor       # (E,) bool
    z_meas: Optional[torch.Tensor] = None
    wz: Optional[torch.Tensor] = None
    # stereo rig: cam_sel (E,) 0 = left, 1 = right camera at (rig_R, rig_t),
    # x_r = rig_R x_l + rig_t, with the params_r intrinsics
    cam_sel: Optional[torch.Tensor] = None
    rig_R: Optional[torch.Tensor] = None
    rig_t: Optional[torch.Tensor] = None
    params_r: Optional[torch.Tensor] = None


def with_depth_defaults(prob: BAProblem, cam_params=None) -> BAProblem:
    """Fill absent depth fields with mono defaults and, on a rig problem
    (cam_sel set), absent rig fields with the left camera's."""
    z = torch.zeros_like(prob.inv_sigma2)
    prob = prob._replace(z_meas=z if prob.z_meas is None else prob.z_meas,
                         wz=z if prob.wz is None else prob.wz)
    if prob.cam_sel is None:
        return prob
    dt, dev = prob.poses_R.dtype, prob.poses_R.device
    return prob._replace(
        rig_R=torch.eye(3, dtype=dt, device=dev) if prob.rig_R is None else prob.rig_R,
        rig_t=torch.zeros(3, dtype=dt, device=dev) if prob.rig_t is None else prob.rig_t,
        params_r=cam_params if prob.params_r is None else prob.params_r)


def _edge_terms(cam_kind, cam_params, prob: BAProblem, poses_R, poses_t, points):
    R = poses_R[prob.kf_idx]
    t = poses_t[prob.kf_idx]
    p = points[prob.pt_idx]
    if prob.cam_sel is None:
        r, Jc, Jp, depth = factors.reproj_depth_residual(
            cam_kind, cam_params, R, t, p, prob.uv, prob.z_meas, prob.wz)
    else:
        r, Jc, Jp, depth = factors.reproj_depth_residual_rig(
            cam_kind, cam_params, prob.params_r, prob.rig_R, prob.rig_t, prob.cam_sel,
            R, t, p, prob.uv, prob.z_meas, prob.wz)
    w = prob.inv_sigma2 * prob.valid * (depth > 0)
    return r, Jc, Jp, w, depth


def _robust_cost(chi2, delta2, robust: bool):
    if not robust:
        return chi2
    return torch.where(chi2 <= delta2, chi2,
                       2.0 * torch.sqrt(delta2 * torch.clamp(chi2, min=0.0)) - delta2)


def inv3_sym(A):
    """Closed-form inverse of batched symmetric 3x3 matrices."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e = A[..., 1, 1], A[..., 1, 2]
    f = A[..., 2, 2]
    co00 = d * f - e * e
    co01 = c * e - b * f
    co02 = b * e - c * d
    co11 = a * f - c * c
    co12 = b * c - a * e
    co22 = a * d - b * b
    inv_det = 1.0 / (a * co00 + b * co01 + c * co02)
    return torch.stack([
        torch.stack([co00, co01, co02], -1),
        torch.stack([co01, co11, co12], -1),
        torch.stack([co02, co12, co22], -1),
    ], -2) * inv_det[..., None, None]


def _segment_sum(vals, ids, n):
    out = torch.zeros((n,) + vals.shape[1:], dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, ids, vals)


def ba_iterate(cam_kind, cam_params, prob: BAProblem, n_iters: int, robust: bool,
               chi2_th: float):
    """n_iters of LM with landmark marginalization. Returns (prob, costs).

    The lambda floor (1e-4) and the step trust region (0.25 scene units) are
    load-bearing in float32: without them the near-gauge directions of
    monocular BA random-walk under round-off and the map warps."""
    prob = with_depth_defaults(prob, cam_params)
    K = prob.poses_R.shape[0]
    M = prob.points.shape[0]
    dt, dev = prob.poses_R.dtype, prob.poses_R.device
    delta2 = torch.where(prob.wz > 0, factors.CHI2_STEREO, chi2_th).to(dt)
    f64 = dt == torch.float64
    lam_min = 1e-7 if f64 else 1e-4
    max_step = 1e3 if f64 else 0.25
    eye6 = torch.eye(6, dtype=dt, device=dev)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    m_edge = prob.valid.to(dt)
    free = (~prob.fixed).to(dt)
    kk = torch.arange(K, device=dev)
    wcp_ids = prob.pt_idx * K + prob.kf_idx

    poses_R, poses_t, points = prob.poses_R, prob.poses_t, prob.points
    lam = torch.tensor(1e-4, dtype=dt, device=dev)
    costs = []
    for _ in range(n_iters):
        r, Jc, Jp, w, depth = _edge_terms(cam_kind, cam_params, prob,
                                          poses_R, poses_t, points)
        chi2 = torch.sum(r * r, -1) * prob.inv_sigma2
        if robust:
            w = w * factors.huber_weight(chi2, delta2)

        # normal-equation blocks (segment sums over edges)
        JcW = Jc * w[:, None, None]
        JpW = Jp * w[:, None, None]
        Hcc = _segment_sum(JcW.transpose(1, 2) @ Jc, prob.kf_idx, K)       # (K,6,6)
        bc = _segment_sum((JcW.transpose(1, 2) @ r[..., None])[..., 0], prob.kf_idx, K)
        Hpp = _segment_sum(JpW.transpose(1, 2) @ Jp, prob.pt_idx, M)       # (M,3,3)
        bp = _segment_sum((JpW.transpose(1, 2) @ r[..., None])[..., 0], prob.pt_idx, M)
        Wcp = _segment_sum(JcW.transpose(1, 2) @ Jp, wcp_ids, M * K).reshape(M, K, 6, 3)

        # damping
        Hpp_d = Hpp + (lam * torch.diagonal(Hpp, dim1=-2, dim2=-1) + 1e-8)[..., None] * eye3
        Hcc_d = Hcc + (lam * torch.diagonal(Hcc, dim1=-2, dim2=-1) + 1e-8)[..., None] * eye6
        Hpp_inv = inv3_sym(Hpp_d)

        # Schur complement S = Hcc - W Hpp^-1 W^T
        WHinv = torch.einsum("mkac,mcd->mkad", Wcp, Hpp_inv)               # (M,K,6,3)
        S = -torch.einsum("mkad,mled->kale", WHinv, Wcp)                   # (K,6,K,6)
        S[kk, :, kk, :] += Hcc_d
        rhs = -bc + torch.einsum("mkad,md->ka", WHinv, bp)                 # (K,6)

        # freeze fixed cameras
        S = S * free[:, None, None, None] * free[None, None, :, None]
        S[kk, :, kk, :] += eye6 * prob.fixed[:, None, None]
        rhs = rhs * free[:, None]
        dc = torch.linalg.solve(S.reshape(K * 6, K * 6), rhs.reshape(K * 6)).reshape(K, 6)
        dc = dc * free[:, None]

        # trust region on the camera step, then back-substitute landmarks
        step = torch.sqrt(torch.sum(dc * dc, -1))
        dc = dc * torch.clamp(max_step / torch.clamp(torch.max(step), min=1e-12), max=1.0)
        Hpc_dc = torch.einsum("mkac,ka->mc", Wcp, dc)
        dp = (Hpp_inv @ (-bp - Hpc_dc)[..., None])[..., 0]
        pstep = torch.sqrt(torch.sum(dp * dp, -1))
        dp = dp * torch.clamp(max_step / torch.clamp(pstep, min=1e-12), max=1.0)[:, None]

        R_new, t_new = lie.se3_retract(poses_R, poses_t, dc)
        R_new = lie.orthonormalize(R_new)
        pts_new = points + dp

        costs_old = _robust_cost(chi2, delta2, robust) * (m_edge * (depth > 0))
        r2, _, _, _, depth2 = _edge_terms(cam_kind, cam_params, prob, R_new, t_new, pts_new)
        chi2_new = torch.sum(r2 * r2, -1) * prob.inv_sigma2
        costs_new = _robust_cost(chi2_new, delta2, robust) * (m_edge * (depth2 > 0))
        ok = ((torch.sum(costs_new - costs_old) < 0) & torch.all(torch.isfinite(dc))
              & torch.all(torch.isfinite(dp)))
        poses_R = torch.where(ok, R_new, poses_R)
        poses_t = torch.where(ok, t_new, poses_t)
        points = torch.where(ok, pts_new, points)
        lam = torch.where(ok, torch.clamp(lam * 0.33, min=lam_min),
                          torch.clamp(lam * 4.0, max=1e4))
        costs.append(torch.sum(costs_new))
    return prob._replace(poses_R=poses_R, poses_t=poses_t, points=points), \
        torch.stack(costs) if costs else torch.zeros(0, dtype=dt, device=dev)


def classify_edges(cam_kind, cam_params, prob: BAProblem, chi2_th: float, base_valid):
    """Re-classify edges against the base validity set (outlier recycling)."""
    prob = with_depth_defaults(prob, cam_params)
    r, _, _, _, depth = _edge_terms(cam_kind, cam_params, prob, prob.poses_R,
                                    prob.poses_t, prob.points)
    chi2 = torch.sum(r * r, -1) * prob.inv_sigma2
    th = torch.where(prob.wz > 0, factors.CHI2_STEREO, chi2_th)
    return base_valid & (chi2 <= th) & (depth > 0)


def bundle_adjust(cam_kind, cam_params, prob: BAProblem,
                  rounds=((5, True), (10, True), (8, False)),
                  chi2_th: float = factors.CHI2_MONO, should_abort=None):
    """LM rounds with outlier re-classification between them
    (LocalBundleAdjustment's probe + main solve and its final outlier
    sweep). should_abort: zero-arg callable polled between rounds."""
    prob = with_depth_defaults(prob, cam_params)
    base_valid = prob.valid
    for n_iters, robust in rounds:
        if should_abort is not None and should_abort():
            break
        prob, _ = ba_iterate(cam_kind, cam_params, prob, n_iters, robust, chi2_th)
        prob = prob._replace(valid=classify_edges(cam_kind, cam_params, prob,
                                                  chi2_th, base_valid))
    return prob
