"""Joint visual-inertial bundle adjustment (15-d states + landmarks).

Counterpart of hfnet_slam_tpu/optim/vi_ba.py (the reference's FullInertialBA
and LocalInertialBA): K keyframes with a 15-d tangent [phi dp dv dbg dba]
(R' = R Exp(phi), additive rest), M landmarks, E visual edges and L inertial
links, all padded with validity masks. Landmarks are Schur-eliminated as in
optim/ba.py; the visual coupling touches only the 6 pose rows of a 15-d
block, so the reduced system is a dense (K,15,K,15) tensor that also takes
the inertial links' 30x30 blocks. The reference's segment sums are
`index_add_` (atomics on CUDA: sums land in a run-dependent order).

Jacobians are closed form, where the reference takes jax.jacfwd per edge:
the visual edge's 3x9 from the projection Jacobian chained through T_bc, the
inertial link's 15x30 from optim/inertial.inertial_residual_jac.

The solve stays float32 with the reference's Jacobi preconditioning and one
iterative-refinement step: the inertial information (~1e9) against the
visual (~1) puts the unscaled system's condition number beyond float32.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import lie
from ..geometry import cameras, imu
from . import factors
from .ba import _segment_sum, inv3_sym
from .inertial import body_to_cam, chol, inertial_residual_jac, inv, solve


class VIBAProblem(NamedTuple):
    """Fixed-shape VI-BA problem: K keyframes, M points, E visual edges, L
    inertial links (padded)."""

    R_wb: torch.Tensor          # (K,3,3)
    p_wb: torch.Tensor          # (K,3)
    v: torch.Tensor             # (K,3)
    bg: torch.Tensor            # (K,3)
    ba: torch.Tensor            # (K,3)
    fixed: torch.Tensor         # (K,) bool: the whole 15-d state frozen
    fix_pose_only: torch.Tensor  # (K,) bool: the 6-d pose frozen (gauge anchor)
    points: torch.Tensor        # (M,3)
    Tbc_R: torch.Tensor         # (3,3)
    Tbc_t: torch.Tensor         # (3,)
    kf_idx: torch.Tensor        # (E,) int64
    pt_idx: torch.Tensor        # (E,) int64
    uv: torch.Tensor            # (E,2)
    inv_sigma2: torch.Tensor    # (E,)
    valid: torch.Tensor         # (E,) bool
    z_meas: torch.Tensor        # (E,) measured depth (0 = mono edge)
    wz: torch.Tensor            # (E,) depth-row weight (0 = mono)
    li: torch.Tensor            # (L,) int64, earlier keyframe
    lj: torch.Tensor            # (L,) int64, later keyframe
    pre: imu.Preintegrated      # batched (L,...)
    lvalid: torch.Tensor        # (L,) bool
    prior_g: torch.Tensor       # scalar: bias prior weights on KF 0
    prior_a: torch.Tensor


def _link_whiteners(prob: VIBAProblem):
    """Per-link 9-d inertial and 3-d bias-walk whiteners, zero on padding."""
    C = prob.pre.C
    dt, dev = C.dtype, C.device
    eye9 = torch.eye(9, dtype=dt, device=dev)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    C9 = 0.5 * (C[:, :9, :9] + C[:, :9, :9].transpose(1, 2)) + 1e-9 * eye9
    L9 = chol(inv(C9)).transpose(1, 2)
    Lg = chol(inv(C[:, 9:12, 9:12] + 1e-10 * eye3)).transpose(1, 2)
    La = chol(inv(C[:, 12:15, 12:15] + 1e-10 * eye3)).transpose(1, 2)
    z = prob.lvalid.to(dt)[:, None, None]
    return L9 * z, Lg * z, La * z


def _links(prob: VIBAProblem, L9, Lg, La, R, p, v, bg, ba, with_jac):
    """Whitened 15-d link residuals (L,15) at the states, and their (L,15,30)
    Jacobians over [xi_i(15), xi_j(15)] at zero."""
    i, j = prob.li, prob.lj
    r9, J = inertial_residual_jac(R[i], p[i], v[i], R[j], p[j], v[j], bg[i], ba[i], prob.pre,
                                  with_jac=with_jac)
    r = torch.cat([(L9 @ r9[..., None])[..., 0], (Lg @ (bg[j] - bg[i])[..., None])[..., 0],
                   (La @ (ba[j] - ba[i])[..., None])[..., 0]], -1)
    if not with_jac:
        return r, None
    n = r.shape[0]
    Z = torch.zeros((n, 9, 3), dtype=r.dtype, device=r.device)
    J9 = torch.cat([J["phi1"], J["p1"], J["v1"], J["bg"], J["ba"],
                    J["phi2"], J["p2"], J["v2"], Z, Z], -1)
    Jl = torch.zeros((n, 15, 30), dtype=r.dtype, device=r.device)
    Jl[:, 0:9] = L9 @ J9
    Jl[:, 9:12, 9:12] = -Lg
    Jl[:, 9:12, 24:27] = Lg
    Jl[:, 12:15, 12:15] = -La
    Jl[:, 12:15, 27:30] = La
    return r, Jl


def _vis(cam_kind, cam_params, prob: VIBAProblem, R, p, pts, with_jac):
    """Visual residuals (E,3) [du dv depth-row] and depth (E,), with the
    (E,3,6) body-pose and (E,3,3) point Jacobians."""
    Rk, pk = R[prob.kf_idx], p[prob.kf_idx]
    X = pts[prob.pt_idx]
    R_cw, t_cw = body_to_cam(Rk, pk, prob.Tbc_R, prob.Tbc_t)
    pc = (R_cw @ X[..., None])[..., 0] + t_cw
    r2 = cameras.project(cam_kind, cam_params, pc) - prob.uv
    rz = prob.wz * (pc[..., 2] - prob.z_meas)
    r = torch.cat([r2, rz[..., None]], -1)
    if not with_jac:
        return r, pc[..., 2], None, None
    Jproj = cameras.project_jac(cam_kind, cam_params, pc)
    zero = torch.zeros_like(prob.wz)
    Jpc = torch.cat([Jproj, torch.stack([zero, zero, prob.wz], -1)[..., None, :]], -2)
    q = ((X - pk)[..., None, :] @ Rk)[..., 0, :]       # R^T (X - p)
    Jb = torch.cat([Jpc @ (prob.Tbc_R.T @ lie.hat(q)), -Jpc @ R_cw], -1)
    return r, pc[..., 2], Jb, Jpc @ R_cw


def vi_ba_iterate(cam_kind, cam_params, prob: VIBAProblem, n_iters: int, robust: bool,
                  chi2_mono: float):
    """n_iters of LM on the joint VI problem. Returns (prob', costs)."""
    K = prob.R_wb.shape[0]
    M = prob.points.shape[0]
    D = 15
    dt, dev = prob.p_wb.dtype, prob.p_wb.device
    L9, Lg, La = _link_whiteners(prob)
    delta2 = torch.where(prob.wz > 0, factors.CHI2_STEREO, chi2_mono).to(dt)
    max_step = 0.5
    lam_eps = 1e-8
    eye3 = torch.eye(3, dtype=dt, device=dev)
    eyeD = torch.eye(D, dtype=dt, device=dev)
    kk = torch.arange(K, device=dev)
    wcp_ids = prob.pt_idx * K + prob.kf_idx
    li, lj = prob.li, prob.lj
    pose_rows = (torch.arange(D, device=dev) < 6)[None, :]
    free = ((~prob.fixed)[:, None] & ~(prob.fix_pose_only[:, None] & pose_rows)).to(dt)
    lvalid = prob.lvalid.to(dt)

    def vis_costs(R, p, pts):
        r, depth, _, _ = _vis(cam_kind, cam_params, prob, R, p, pts, False)
        chi2 = torch.sum(r * r, -1) * prob.inv_sigma2
        m = prob.valid * (depth > 0)
        if robust:
            chi2 = torch.where(chi2 <= delta2, chi2,
                               2.0 * torch.sqrt(delta2 * torch.clamp(chi2, min=0.0)) - delta2)
        return chi2 * m

    R, p, v, bg, ba, pts = prob.R_wb, prob.p_wb, prob.v, prob.bg, prob.ba, prob.points
    lam = torch.tensor(1e-3, dtype=dt, device=dev)
    costs = []
    for _ in range(n_iters):
        # ---- visual part ----
        r, depth, Jb, Jp = _vis(cam_kind, cam_params, prob, R, p, pts, True)
        chi2 = torch.sum(r * r, -1) * prob.inv_sigma2
        w = prob.inv_sigma2 * prob.valid * (depth > 0)
        if robust:
            w = w * factors.huber_weight(chi2, delta2)
        JbW = Jb * w[:, None, None]
        JpW = Jp * w[:, None, None]
        Hbb = _segment_sum(JbW.transpose(1, 2) @ Jb, prob.kf_idx, K)
        bb = _segment_sum((JbW.transpose(1, 2) @ r[..., None])[..., 0], prob.kf_idx, K)
        Hpp = _segment_sum(JpW.transpose(1, 2) @ Jp, prob.pt_idx, M)
        bp = _segment_sum((JpW.transpose(1, 2) @ r[..., None])[..., 0], prob.pt_idx, M)
        Wcp = _segment_sum(JbW.transpose(1, 2) @ Jp, wcp_ids, M * K).reshape(M, K, 6, 3)

        # ---- inertial part ----
        rl, Jl = _links(prob, L9, Lg, La, R, p, v, bg, ba, True)
        Hl = Jl.transpose(1, 2) @ Jl
        bl = (Jl.transpose(1, 2) @ rl[..., None])[..., 0]

        # ---- reduced camera system (K,15,K,15) ----
        Hpp_d = Hpp + (lam * torch.diagonal(Hpp, dim1=-2, dim2=-1) + lam_eps)[..., None] * eye3
        Hpp_inv = inv3_sym(Hpp_d)
        WHinv = torch.einsum("mkac,mcd->mkad", Wcp, Hpp_inv)
        S = torch.zeros((K, D, K, D), dtype=dt, device=dev)
        S[:, :6, :, :6] = -torch.einsum("mkad,mled->kale", WHinv, Wcp)
        S[kk, :6, kk, :6] += Hbb
        Sf = S.permute(0, 2, 1, 3).reshape(K * K, D, D)
        Sf.index_add_(0, li * K + li, Hl[:, :15, :15])
        Sf.index_add_(0, li * K + lj, Hl[:, :15, 15:])
        Sf.index_add_(0, lj * K + li, Hl[:, 15:, :15])
        Sf.index_add_(0, lj * K + lj, Hl[:, 15:, 15:])
        S = Sf.reshape(K, K, D, D).permute(0, 2, 1, 3).contiguous()
        S[0, 9:12, 0, 9:12] += prob.prior_g * eye3
        S[0, 12:15, 0, 12:15] += prob.prior_a * eye3
        rhs = torch.zeros((K, D), dtype=dt, device=dev)
        rhs[:, :6] += -bb + torch.einsum("mkad,md->ka", WHinv, bp)
        rhs.index_add_(0, li, -bl[:, :15])
        rhs.index_add_(0, lj, -bl[:, 15:])

        # ---- damping, gauge, preconditioned solve ----
        diag = torch.diagonal(S.reshape(K * D, K * D)).reshape(K, D)
        S[kk, :, kk, :] += torch.diag_embed(lam * diag + lam_eps)
        S = S * free[:, :, None, None] * free[None, None, :, :]
        S[kk, :, kk, :] += eyeD[None] * (1.0 - free)[:, :, None]
        rhs = rhs * free
        Sm = S.reshape(K * D, K * D)
        d = torch.sqrt(torch.clamp(torch.diagonal(Sm), min=1e-12))
        Sm = Sm / d[:, None] / d[None, :]
        b = rhs.reshape(K * D) / d
        y = solve(Sm, b)
        y = y + solve(Sm, b - Sm @ y)
        dx = (y / d).reshape(K, D) * free
        step = torch.sqrt(torch.sum(dx * dx, -1))
        dx = dx * torch.clamp(max_step / torch.clamp(torch.max(step), min=1e-12), max=1.0)

        # ---- landmarks ----
        Hpc_dc = torch.einsum("mkac,ka->mc", Wcp, dx[:, :6])
        dp_pts = (Hpp_inv @ (-bp - Hpc_dc)[..., None])[..., 0]
        pstep = torch.sqrt(torch.sum(dp_pts * dp_pts, -1))
        dp_pts = dp_pts * torch.clamp(max_step / torch.clamp(pstep, min=1e-12), max=1.0)[:, None]

        R_n = lie.orthonormalize(R @ lie.so3_exp(dx[:, :3]))
        p_n, v_n = p + dx[:, 3:6], v + dx[:, 6:9]
        bg_n, ba_n = bg + dx[:, 9:12], ba + dx[:, 12:15]
        pts_n = pts + dp_pts

        # accept on summed per-term differences; the whitened inertial chi2
        # are O(1e8), so their difference is taken as (r_n - r_o)(r_n + r_o)
        rn, _ = _links(prob, L9, Lg, La, R_n, p_n, v_n, bg_n, ba_n, False)
        c_vis_n = vis_costs(R_n, p_n, pts_n)
        dcost = torch.sum(c_vis_n - vis_costs(R, p, pts)) + \
            torch.sum(torch.sum((rn - rl) * (rn + rl), -1) * lvalid)
        c_new = torch.sum(c_vis_n) + torch.sum(torch.sum(rn * rn, -1) * lvalid)
        ok = (dcost < 0) & torch.all(torch.isfinite(dx)) & torch.all(torch.isfinite(dp_pts))
        R = torch.where(ok, R_n, R)
        p = torch.where(ok, p_n, p)
        v = torch.where(ok, v_n, v)
        bg = torch.where(ok, bg_n, bg)
        ba = torch.where(ok, ba_n, ba)
        pts = torch.where(ok, pts_n, pts)
        lam = torch.where(ok, torch.clamp(lam * 0.33, min=1e-5), torch.clamp(lam * 4.0, max=1e4))
        costs.append(c_new)
    out = prob._replace(R_wb=R, p_wb=p, v=v, bg=bg, ba=ba, points=pts)
    return out, torch.stack(costs) if costs else torch.zeros(0, dtype=dt, device=dev)


def classify_visual_edges(cam_kind, cam_params, prob: VIBAProblem, chi2_mono: float,
                          base_valid):
    """Chi-square re-classification of the visual edges."""
    r, depth, _, _ = _vis(cam_kind, cam_params, prob, prob.R_wb, prob.p_wb, prob.points, False)
    chi2 = torch.sum(r * r, -1) * prob.inv_sigma2
    th = torch.where(prob.wz > 0, factors.CHI2_STEREO, chi2_mono)
    return base_valid & (chi2 <= th) & (depth > 0)


def vi_bundle_adjust(cam_kind, cam_params, prob: VIBAProblem, rounds=((5, True), (10, True)),
                     chi2_mono: float = factors.CHI2_MONO, should_abort=None):
    """LM rounds with visual-outlier re-classification between them.
    should_abort: polled between rounds; on True the remaining rounds are
    skipped (the caller discards the result)."""
    base_valid = prob.valid
    for n_iters, robust in rounds:
        if should_abort is not None and should_abort():
            break
        prob, _ = vi_ba_iterate(cam_kind, cam_params, prob, n_iters, robust, chi2_mono)
        prob = prob._replace(valid=classify_visual_edges(cam_kind, cam_params, prob, chi2_mono,
                                                         base_valid))
    return prob
