"""Plain local bundle adjustment in float64: the robust reprojection(+depth)
cost of a BA problem and ORB-SLAM3's LocalBundleAdjustment on it (a robust
solve over every edge, the edges past their chi2 threshold dropped as
outliers, a robust solve over the rest, the outliers classified again).

Frozen copy (commit 27c9911) of the arithmetic of the port's
optim/ba.bundle_adjust at its float32 settings (Levenberg-Marquardt with
the damping floor 1e-4 and a 0.25 step bound on the keyframe and on each
point, a step kept only where it lowers the cost), written plainly: the
whole normal matrix is built densely and solved in one piece, and the
points' step is solved again from the bounded keyframe step. The edge is
the one of reference/tracking.py (pinhole, r = [du, dv, w_z (z - z_meas)],
Huber on the information-weighted chi2 with the mono / stereo
thresholds). It imports no module of the program.
"""
from __future__ import annotations

import torch

from .tracking import CHI2_MONO, CHI2_STEREO, huber_weight, residual, se3_retract

F64 = torch.float64
ROUNDS = (5, 10)          # LocalBundleAdjustment: 5 iterations, outliers out, 10 more
LAM0 = LAM_MIN = 1e-4     # the program's float32 damping start (each round) and floor
MAX_STEP = 0.25           # ... and its bound on a keyframe's and a point's step


def edges(kf_idx, pt_idx, uv, inv_sigma2, valid, z_meas, wz):
    """The valid edges of a problem, in float64."""
    v = valid.bool()
    zero = torch.zeros_like(inv_sigma2)
    z = zero if z_meas is None else z_meas
    w = zero if wz is None else wz
    return {"kf": kf_idx[v].long(), "pt": pt_idx[v].long(), "uv": uv[v].to(F64),
            "s2": inv_sigma2[v].to(F64), "z": z[v].to(F64), "wz": w[v].to(F64)}


def _terms(cam, e, R, t, P):
    r, J, depth = residual(cam, R[e["kf"]], t[e["kf"]], P[e["pt"]], e["uv"], e["z"], e["wz"])
    chi2 = torch.sum(r * r, -1) * e["s2"]
    delta2 = torch.where(e["wz"] > 0, CHI2_STEREO, CHI2_MONO).to(F64)
    return r, J, depth, chi2, delta2


def _costs(cam, e, R, t, P):
    _, _, depth, chi2, d2 = _terms(cam, e, R, t, P)
    rho = torch.where(chi2 <= d2, chi2, 2.0 * torch.sqrt(d2 * chi2) - d2)
    return rho * (depth > 0)


def cost(cam, e, R, t, P, keep=None):
    """Huber cost of the edges (those in `keep`, if given) at keyframe poses
    (R, t) and points P."""
    c = _costs(cam, e, R.to(F64), t.to(F64), P.to(F64))
    return float(torch.sum(c if keep is None else c * keep))


def inliers(cam, e, R, t, P):
    """The edges within their chi2 threshold and in front of their camera."""
    _, _, depth, chi2, d2 = _terms(cam, e, R, t, P)
    return (chi2 <= d2) & (depth > 0)


def _add_block(H, n, rows, cols, vals):
    """H[rows_i + a, cols_i + b] += vals_i[a, b] for each edge i."""
    a = torch.arange(vals.shape[1], device=H.device)
    b = torch.arange(vals.shape[2], device=H.device)
    idx = (rows[:, None, None] + a[None, :, None]) * n + cols[:, None, None] + b[None, None, :]
    H.view(-1).index_add_(0, idx.reshape(-1), vals.reshape(-1))


def bundle_adjust(cam, e, R, t, P, fixed, rounds=ROUNDS):
    """LocalBundleAdjustment from (R, t, P): returns the state it ends at and
    the edges it keeps as inliers there."""
    R, t, P = R.to(F64), t.to(F64), P.to(F64)
    dev = R.device
    kfs, pts = torch.unique(e["kf"]), torch.unique(e["pt"])
    free = kfs[~fixed[kfs].bool()]
    nf, npt = len(free), len(pts)
    n = 6 * nf + 3 * npt
    col_kf = torch.full((R.shape[0],), -1, dtype=torch.long, device=dev)
    col_kf[free] = 6 * torch.arange(nf, device=dev)
    row_pt = torch.full((P.shape[0],), -1, dtype=torch.long, device=dev)
    row_pt[pts] = torch.arange(npt, device=dev)
    ck, rp = col_kf[e["kf"]], row_pt[e["pt"]]
    cp = 6 * nf + 3 * rp
    fk = ck >= 0
    ar3, ar6 = torch.arange(3, device=dev), torch.arange(6, device=dev)
    eye3 = torch.eye(3, dtype=F64, device=dev)
    valid = torch.ones(len(ck), dtype=torch.bool, device=dev)
    for n_iters in rounds:
        lam = LAM0
        for _ in range(n_iters):
            r, J, depth, chi2, d2 = _terms(cam, e, R, t, P)
            w = (e["s2"] * valid * (depth > 0) * huber_weight(chi2, d2))[:, None, None]
            Jc, Jp = J, J[..., :3] @ R[e["kf"]]
            JcW, JpW = (Jc * w).transpose(1, 2), (Jp * w).transpose(1, 2)
            H = torch.zeros((n, n), dtype=F64, device=dev)
            Hpp = torch.zeros((npt, 3, 3), dtype=F64, device=dev).index_add_(0, rp, JpW @ Jp)
            _add_block(H, n, cp, cp, JpW @ Jp)
            _add_block(H, n, ck[fk], ck[fk], (JcW @ Jc)[fk])
            _add_block(H, n, ck[fk], cp[fk], (JcW @ Jp)[fk])
            _add_block(H, n, cp[fk], ck[fk], (JpW @ Jc)[fk])
            g_c, g_p = (JcW @ r[..., None])[..., 0], (JpW @ r[..., None])[..., 0]
            g = torch.zeros(n, dtype=F64, device=dev)
            g.index_add_(0, (cp[:, None] + ar3).reshape(-1), g_p.reshape(-1))
            g.index_add_(0, (ck[fk][:, None] + ar6).reshape(-1), g_c[fk].reshape(-1))
            Hd = H + torch.diag(lam * torch.diagonal(H) + 1e-8)
            dx = torch.linalg.solve(Hd, -g)
            dc = dx[:6 * nf].reshape(nf, 6)
            # the keyframe step bound, then the points' step from the bounded one
            big = torch.sqrt(torch.sum(dc * dc, -1)).max() if nf else torch.zeros((), dtype=F64)
            dc = dc * torch.clamp(MAX_STEP / torch.clamp(big, min=1e-12), max=1.0)
            dc_e = torch.zeros((len(ck), 6), dtype=F64, device=dev)
            dc_e[fk] = dc[ck[fk] // 6]
            rhs = torch.zeros((npt, 3), dtype=F64, device=dev).index_add_(
                0, rp, g_p + ((JpW @ Jc) @ dc_e[..., None])[..., 0])
            Hpp_d = Hpp + (lam * torch.diagonal(Hpp, dim1=-2, dim2=-1) + 1e-8)[..., None] * eye3
            dp = torch.linalg.solve(Hpp_d, -rhs)
            pstep = torch.sqrt(torch.sum(dp * dp, -1))
            dp = dp * torch.clamp(MAX_STEP / torch.clamp(pstep, min=1e-12), max=1.0)[:, None]
            R2, t2, P2 = R.clone(), t.clone(), P.clone()
            R2[free], t2[free] = se3_retract(R[free], t[free], dc)
            P2[pts] = P[pts] + dp
            old = torch.sum(_costs(cam, e, R, t, P) * valid)
            new = torch.sum(_costs(cam, e, R2, t2, P2) * valid)
            if bool(new < old) and bool(torch.isfinite(dx).all()):
                R, t, P, lam = R2, t2, P2, max(lam * 0.33, LAM_MIN)
            else:
                lam = min(lam * 4.0, 1e4)
        valid = inliers(cam, e, R, t, P)
    return (R, t, P), valid


def excess(cam, prob, R_out, t_out, P_out, floor=1e-3):
    """Share of the problem's reducible cost that the program's solution
    left: (C_out - C_ref) / (C_in - C_ref) over the edges this reference
    keeps as inliers, with C_in the cost at the problem's own state, C_out
    at the program's solution and C_ref at this reference's. 0 where the
    program did at least as well, 1 for a solve that returned its input;
    a problem with less than `floor` of its cost to reduce divides by that
    share instead, so that its rounding reads near 0."""
    e = edges(prob["kf_idx"], prob["pt_idx"], prob["uv"], prob["inv_sigma2"], prob["valid"],
              prob.get("z_meas"), prob.get("wz"))
    (R1, t1, P1), keep = bundle_adjust(cam, e, prob["poses_R"], prob["poses_t"],
                                       prob["points"], prob["fixed"])
    c_in = cost(cam, e, prob["poses_R"], prob["poses_t"], prob["points"], keep)
    c_ref = min(cost(cam, e, R1, t1, P1, keep), c_in)
    c_out = cost(cam, e, R_out, t_out, P_out, keep)
    x = max(c_out - c_ref, 0.0) / max(c_in - c_ref, floor * c_in, 1e-12)
    return x, (c_in, c_out, c_ref)
