"""Visual-inertial optimizers: IMU initialization and VI pose tracking.

Counterpart of hfnet_slam_tpu/optim/inertial.py (the reference's
InertialOptimization and PoseInertialOptimizationLast{KeyFrame,Frame}).
The reference builds every Jacobian with jax.jacfwd; here they are closed
form: the reprojection block as optim/pose_opt.py does it, chained through
the body-to-camera extrinsic, and the 9-d inertial edge with the standard
on-manifold preintegration derivatives (ORB-SLAM3's
EdgeInertial::linearizeOplus). tests/test_torch_imu.py holds each against
torch.func.jacfwd of the same residual in float64. The parametrization is
the reference's: an additive tangent x around the round's anchor,
R = R0 Exp(x_phi), so a rotation column carries J_r(x_phi).

A singular or non-positive-definite system gives NaN, as JAX's
factorizations do, and never raises: Cholesky and solve go through the
`_ex` variants, and the reference's `ok = ... & isfinite(dx)` refuses such
a step. `lstsq_min_norm` is the SVD least-squares solution JAX's lstsq
returns (minimum norm on a rank-deficient system, the same cutoff), which
torch.linalg.lstsq's CUDA driver (gels, full rank only) does not give.

State convention: body pose (R_wb, p_wb), world velocity v, biases (bg, ba);
the camera pose follows through T_bc (camera-in-body).
"""
from __future__ import annotations

import torch

from .. import lie
from ..geometry import cameras
from ..geometry import imu

CHI2_MONO = 5.991


# ---------------------------------------------------------------------------
# dense linear algebra that returns NaN where JAX does
# ---------------------------------------------------------------------------

def chol(A):
    """Lower Cholesky factor; NaN where A is not positive definite."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info == 0)[..., None, None], L, torch.nan)


def inv(A):
    Ai, info = torch.linalg.inv_ex(A)
    return torch.where((info == 0)[..., None, None], Ai, torch.inf)


def solve(A, b):
    """A x = b for a vector b; NaN where A is singular."""
    x, info = torch.linalg.solve_ex(A, b)
    return torch.where((info == 0)[..., None], x, torch.nan)


def lstsq_min_norm(A, b):
    """Minimum-norm least squares by SVD, with jnp.linalg.lstsq's default
    cutoff (singular values below eps * max(M, N) * s_max count as zero)."""
    U, S, Vh = torch.linalg.svd(A, full_matrices=False)
    cut = torch.finfo(A.dtype).eps * max(A.shape[-2:]) * S[..., :1]
    keep = (S > 0) & (S >= cut)
    Sinv = torch.where(keep, 1.0 / torch.where(keep, S, torch.ones_like(S)), 0.0)
    return Vh.transpose(-1, -2) @ (Sinv[..., None] * (U.transpose(-1, -2) @ b))


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def body_to_cam(R_wb, p_wb, Tbc_R, Tbc_t):
    """World->camera (R_cw, t_cw) from a body state and T_bc (camera-in-body)."""
    R_cb = Tbc_R.transpose(-1, -2)
    R_cw = R_cb @ R_wb.transpose(-1, -2)
    t_cw = -_mv(R_cw, p_wb) - _mv(R_cb, Tbc_t)
    return R_cw, t_cw


# ---------------------------------------------------------------------------
# residuals with closed-form Jacobians
# ---------------------------------------------------------------------------

def inertial_residual_jac(R1, p1, v1, R2, p2, v2, bg, ba, pre: imu.Preintegrated, g=None,
                          with_jac=True):
    """The 9-d inertial residual [eR eV eP] of imu.inertial_residual (bias
    (bg, ba) corrects the preintegration; world gravity g, GRAVITY_VEC by
    default) and its Jacobians, each (...,9,3), with respect to the right
    rotation perturbations phi1, phi2 (R -> R Exp(d)) and the additive p1,
    v1, p2, v2, bg, ba. With `with_jac` False the Jacobians are None."""
    t = pre.dT[..., None]
    g = imu.gravity_vec(p1) if g is None else g
    phib = _mv(pre.JRg, bg - pre.bg0)
    dR = pre.dR @ lie.so3_exp(phib)
    dV = imu.delta_velocity(pre, bg, ba)
    dP = imu.delta_position(pre, bg, ba)
    R1t = R1.transpose(-1, -2)
    E = dR.transpose(-1, -2) @ R1t @ R2
    eR = lie.so3_log(E)
    u = v2 - v1 - g * t
    w = p2 - p1 - v1 * t - 0.5 * g * t * t
    R1tu, R1tw = _mv(R1t, u), _mv(R1t, w)
    r = torch.cat([eR, R1tu - dV, R1tw - dP], -1)
    if not with_jac:
        return r, None
    Jri = lie.so3_right_jacobian_inv(eR)
    Z = torch.zeros_like(R1)
    tt = t[..., None]

    def col(a, b, c):
        return torch.cat([a, b, c], -2)

    J = {
        "phi1": col(-Jri @ R2.transpose(-1, -2) @ R1, lie.hat(R1tu), lie.hat(R1tw)),
        "p1": col(Z, Z, -R1t),
        "v1": col(Z, -R1t, -R1t * tt),
        "phi2": col(Jri, Z, Z),
        "p2": col(Z, Z, R1t),
        "v2": col(Z, R1t, Z),
        "bg": col(-Jri @ E.transpose(-1, -2) @ lie.so3_right_jacobian(phib) @ pre.JRg,
                  -pre.JVg, -pre.JPg),
        "ba": col(Z, -pre.JVa, -pre.JPa),
    }
    return r, J


def visual_residual_jac(cam_kind, cam_params, R, p, Tbc_R, Tbc_t, points_w, uv,
                        with_jac=True):
    """Reprojection residual (N,2), depth (N,) and the (N,2,6) Jacobian with
    respect to [right body-rotation perturbation, additive body position]
    (None without `with_jac`)."""
    R_cw, t_cw = body_to_cam(R, p, Tbc_R, Tbc_t)
    pc = points_w @ R_cw.T + t_cw
    e = cameras.project(cam_kind, cam_params, pc) - uv
    if not with_jac:
        return e, pc[:, 2], None
    Jproj = cameras.project_jac(cam_kind, cam_params, pc)       # (N,2,3)
    R_cb = Tbc_R.T
    q = (points_w - p) @ R                                       # R^T (X - p)
    J = torch.cat([Jproj @ (R_cb @ lie.hat(q)), -Jproj @ R_cw], -1)
    return e, pc[:, 2], J


# ---------------------------------------------------------------------------
# IMU initialization (InertialOptimization)
# ---------------------------------------------------------------------------

def _init_residuals(R_wb, p_wb, pre, x, prior_g, prior_a, fix_scale, with_jac):
    """inertial_init's whitened residual stack at x = [theta_g(2), log s,
    bg, ba, v(3K)] and, with `with_jac`, its closed-form Jacobian."""
    K = R_wb.shape[0]
    dev, dt = p_wb.device, p_wb.dtype
    nP = 9 + 3 * K
    eye9 = torch.eye(9, dtype=dt, device=dev)
    Lt = chol(imu.information_9(pre) + 1e-9 * eye9).transpose(-1, -2)   # (K-1,9,9)
    G = imu.gravity_vec(p_wb)
    R1, R2 = R_wb[:-1], R_wb[1:]
    pa, pb = p_wb[:-1], p_wb[1:]
    t = pre.dT[:, None]
    sg, sa = float(prior_g) ** 0.5, float(prior_a) ** 0.5
    theta = torch.cat([x[:2], torch.zeros(1, dtype=dt, device=dev)])
    s = torch.ones((), dtype=dt, device=dev) if fix_scale else torch.exp(x[2])
    bg, ba, v = x[3:6], x[6:9], x[9:].reshape(K, 3)
    Rwg = lie.so3_exp(theta)
    g = _mv(Rwg, G)
    r, J = inertial_residual_jac(R1, s * pa, v[:-1], R2, s * pb, v[1:],
                                 bg.expand(K - 1, 3), ba.expand(K - 1, 3), pre, g=g,
                                 with_jac=with_jac)
    res = torch.cat([(Lt @ r[..., None])[..., 0].reshape(-1), sg * bg, sa * ba])
    if not with_jac:
        return res, None
    R1t = R1.transpose(1, 2)
    ar = torch.arange(K - 1, device=dev)
    c3 = torch.arange(3, device=dev)
    Jf = torch.zeros((K - 1, 9, nP), dtype=dt, device=dev)
    dgdth = -(Rwg @ lie.hat(G) @ lie.so3_right_jacobian(theta))[:, :2]   # (3,2)
    Jf[:, 3:6, 0:2] = -(R1t @ dgdth) * t[..., None]
    Jf[:, 6:9, 0:2] = -(R1t @ dgdth) * (0.5 * t * t)[..., None]
    if not fix_scale:
        Jf[:, 6:9, 2] = _mv(R1t, s * pb - s * pa)
    Jf[:, :, 3:6] = J["bg"]
    Jf[:, :, 6:9] = J["ba"]
    Jf[ar[:, None], :, 9 + 3 * ar[:, None] + c3] = J["v1"].permute(0, 2, 1)
    Jf[ar[:, None], :, 12 + 3 * ar[:, None] + c3] = J["v2"].permute(0, 2, 1)
    Jp = torch.zeros((6, nP), dtype=dt, device=dev)
    Jp[0:3, 3:6] = sg * torch.eye(3, dtype=dt, device=dev)
    Jp[3:6, 6:9] = sa * torch.eye(3, dtype=dt, device=dev)
    return res, torch.cat([(Lt @ Jf).reshape(-1, nP), Jp], 0)


def inertial_init(R_wb, p_wb, pre: imu.Preintegrated, prior_g: float = 1e2,
                  prior_a: float = 1e10, n_iters: int = 40, fix_scale: bool = False):
    """Gravity direction, scale, shared biases and per-keyframe velocities
    with the poses fixed. R_wb (K,3,3), p_wb (K,3) (up to scale), `pre` a
    batch of K-1 consecutive-pair preintegrations. x = [theta_g(2), log s,
    bg, ba, v(3K)]; a closed-form linear alignment (zero bias) seeds the
    Gauss-Newton. Returns dict(Rwg, scale, bg, ba, v, cost)."""
    K = R_wb.shape[0]
    dev, dt = p_wb.device, p_wb.dtype
    nP = 9 + 3 * K
    G = imu.gravity_vec(p_wb)
    R1 = R_wb[:-1]
    pa, pb = p_wb[:-1], p_wb[1:]
    t = pre.dT[:, None]
    ar = torch.arange(K - 1, device=dev)

    def residuals(x, with_jac):
        return _init_residuals(R_wb, p_wb, pre, x, prior_g, prior_a, fix_scale, with_jac)

    def unpack(x):
        theta = torch.cat([x[:2], torch.zeros(1, dtype=dt, device=dev)])
        s = torch.ones((), dtype=dt, device=dev) if fix_scale else torch.exp(x[2])
        return theta, s, x[3:6], x[6:9], x[9:].reshape(K, 3)

    # closed-form linear alignment seed (zero bias): eV, eP are linear in
    # u = [s, g(3), v(3K)]
    R1t = R1.transpose(1, 2)
    z3 = torch.zeros(3, dtype=dt, device=dev)
    dV0 = imu.delta_velocity(pre, z3, z3)
    dP0 = imu.delta_position(pre, z3, z3)
    A = torch.zeros((K - 1, 6, 4 + 3 * K), dtype=dt, device=dev)
    cols = 4 + 3 * ar[:, None] + torch.arange(3, device=dev)
    A[:, :3, 1:4] = -t[..., None] * R1t
    A[ar[:, None], :3, cols] = -R1t.permute(0, 2, 1)
    A[ar[:, None], :3, cols + 3] = R1t.permute(0, 2, 1)
    A[:, 3:, 0] = _mv(R1t, pb - pa)
    A[:, 3:, 1:4] = -0.5 * (t * t)[..., None] * R1t
    A[ar[:, None], 3:, cols] = (-t[..., None] * R1t).permute(0, 2, 1)
    A = A.reshape(-1, 4 + 3 * K)
    bvec = torch.cat([dV0, dP0], -1).reshape(-1)
    if fix_scale:
        u = lstsq_min_norm(A[:, 1:], (bvec - A[:, 0])[:, None])[:, 0]
        log_s = torch.zeros((), dtype=dt, device=dev)
        g_lin, v_lin = u[0:3], u[3:]
    else:
        u = lstsq_min_norm(A, bvec[:, None])[:, 0]
        log_s = torch.log(torch.clamp(torch.abs(u[0]), 1e-3, 1e4))
        g_lin, v_lin = u[1:4], u[4:]
    g_hat = g_lin / torch.clamp(torch.linalg.norm(g_lin), min=1e-9)
    e_z = G / imu.GRAVITY
    axis = torch.linalg.cross(e_z, g_hat)
    sin_a = torch.linalg.norm(axis)
    cos_a = torch.dot(e_z, g_hat)
    theta = axis / torch.clamp(sin_a, min=1e-9) * torch.atan2(sin_a, cos_a)
    x = torch.cat([theta[:2], log_s[None], torch.zeros(6, dtype=dt, device=dev), v_lin])

    lam = torch.tensor(1e-2, dtype=dt, device=dev)
    eyeP = torch.eye(nP, dtype=dt, device=dev)
    costs = []
    for _ in range(n_iters):
        r, J = residuals(x, True)
        H = J.T @ J
        b = J.T @ r
        H = H + lam * torch.diag(torch.diagonal(H)) + 1e-9 * eyeP
        dx = -solve(H, b)
        x_new = x + dx
        r_new, _ = residuals(x_new, False)
        ok = (torch.sum(r_new ** 2) < torch.sum(r ** 2)) & torch.all(torch.isfinite(dx))
        x = torch.where(ok, x_new, x)
        lam = torch.where(ok, lam * 0.5, lam * 4.0)
        costs.append(torch.sum(r ** 2))
    theta, s, bg, ba, v = unpack(x)
    return {"Rwg": lie.so3_exp(theta), "scale": s, "bg": bg, "ba": ba, "v": v,
            "cost": torch.stack(costs)}


# ---------------------------------------------------------------------------
# VI pose tracking (PoseInertialOptimizationLast{KeyFrame,Frame})
# ---------------------------------------------------------------------------

def _whiteners(pre: imu.Preintegrated):
    dev, dt = pre.C.device, pre.C.dtype
    eye9 = torch.eye(9, dtype=dt, device=dev)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    L9 = chol(imu.information_9(pre) + 1e-9 * eye9).T
    Lg = chol(inv(pre.C[9:12, 9:12] + 1e-12 * eye3)).T
    La = chol(inv(pre.C[12:15, 12:15] + 1e-12 * eye3)).T
    return L9, Lg, La


def _state_of(x, R0, p0, v0, bg0, ba0):
    return (R0 @ lie.so3_exp(x[:3]), p0 + x[3:6], v0 + x[6:9], bg0 + x[9:12],
            ba0 + x[12:15])


def _robust_cost(c, chi2):
    return torch.minimum(c, chi2 + torch.sqrt(chi2 * torch.clamp(c - chi2, min=0.0)))


def _vis_normal(e, J, w):
    """Jv^T W Jv (6,6) and Jv^T W e (6,) of the visual block."""
    JW = J * w[:, None, None]
    return (torch.einsum("nri,nrj->ij", JW, J), torch.einsum("nri,nr->i", JW, e))


def pose_inertial_optimize(cam_kind, cam_params, Tbc_R, Tbc_t, R1, p1, v1, bg1, ba1,
                           pre: imu.Preintegrated, R2, p2, v2, points_w, uv, inv_sigma2,
                           valid, chi2_mono: float = CHI2_MONO, prior_info=None,
                           prior_state=None, n_rounds: int = 4, n_iters: int = 10):
    """The current frame's 15-d state [R_wb p_wb v bg ba] against monocular
    reprojections, one inertial edge from the fixed anchor (R1 .. ba1) and
    the bias random walks; 4 rounds of chi2 re-classification (robust in
    the first two). Returns dict(R, p, v, bg, ba, inlier, n_inliers, H):
    H is the 15x15 posterior information at the optimum (visual, inertial
    and random-walk terms), the seed of the marginal-prior chain."""
    dev, dt = p2.device, p2.dtype
    L9, Lg, La = _whiteners(pre)
    eye15 = torch.eye(15, dtype=dt, device=dev)
    Lp = None
    if prior_info is not None:
        Lp = chol(prior_info + 1e-9 * eye15).T

    def other(x, st, with_jac):
        R, p, v, bg, ba = _state_of(x, *st)
        r9, J9 = inertial_residual_jac(R1, p1, v1, R, p, v, bg, ba, pre, with_jac=with_jac)
        parts = [L9 @ r9, Lg @ (bg - bg1), La @ (ba - ba1)]
        if Lp is not None:
            Rp, pp, vp, bgp, bap = prior_state
            dpr = torch.cat([lie.so3_log(Rp.T @ R), p - pp, v - vp, bg - bgp, ba - bap])
            parts.append(Lp @ dpr)
        r = torch.cat(parts)
        if not with_jac:
            return r, None
        Jr = lie.so3_right_jacobian(x[:3])
        Ji = torch.cat([J9["phi2"] @ Jr, J9["p2"], J9["v2"], J9["bg"], J9["ba"]], 1)
        Jo = torch.zeros((r.shape[0], 15), dtype=dt, device=dev)
        Jo[0:9] = L9 @ Ji
        Jo[9:12, 9:12] = Lg
        Jo[12:15, 12:15] = La
        if Lp is not None:
            Jp = eye15.clone()
            Jp[:3, :3] = lie.so3_right_jacobian_inv(dpr[:3]) @ Jr
            Jo[15:30] = Lp @ Jp
        return r, Jo

    def vis(x, st, with_jac=True):
        R, p = _state_of(x, *st)[:2]
        e, depth, J = visual_residual_jac(cam_kind, cam_params, R, p, Tbc_R, Tbc_t,
                                          points_w, uv, with_jac)
        if with_jac:
            J = torch.cat([J[..., :3] @ lie.so3_right_jacobian(x[:3]), J[..., 3:]], -1)
        return e, depth, J

    def cost(e, depth, ro, inlier):
        c = torch.sum(e * e, -1) * inv_sigma2
        return torch.sum(_robust_cost(c, chi2_mono) * inlier * (depth > 0)) + torch.sum(ro ** 2)

    st = (R2, p2, v2, bg1, ba1)
    inlier = valid.to(dt)
    for rnd in range(n_rounds):
        robust = rnd < 2
        x = torch.zeros(15, dtype=dt, device=dev)
        lam = torch.tensor(1e-4, dtype=dt, device=dev)
        for _ in range(n_iters):
            e, depth, Jv = vis(x, st)
            chi2 = torch.sum(e * e, -1) * inv_sigma2
            w_h = torch.where(chi2 <= chi2_mono, 1.0, torch.sqrt(
                chi2_mono / torch.clamp(chi2, min=1e-12))) if robust else torch.ones_like(chi2)
            w = w_h * inv_sigma2 * inlier * (depth > 0)
            ro, Jo = other(x, st, True)
            Hv, bv = _vis_normal(e, Jv, w)
            H = Jo.T @ Jo
            H[:6, :6] += Hv
            b = Jo.T @ ro
            b[:6] += bv
            H = H + lam * torch.diag(torch.diagonal(H)) + 1e-9 * eye15
            dx = -solve(H, b)
            x_new = x + dx
            e_n, d_n, _ = vis(x_new, st, False)
            ro_n, _ = other(x_new, st, False)
            ok = (cost(e_n, d_n, ro_n, inlier) < cost(e, depth, ro, inlier)) & \
                torch.all(torch.isfinite(dx))
            x = torch.where(ok, x_new, x)
            lam = torch.where(ok, lam * 0.5, lam * 4.0)
        st = _state_of(x, *st)
        e, depth, _ = visual_residual_jac(cam_kind, cam_params, st[0], st[1], Tbc_R, Tbc_t,
                                          points_w, uv, with_jac=False)
        chi2 = torch.sum(e * e, -1) * inv_sigma2
        inlier = (valid & (chi2 <= chi2_mono) & (depth > 0)).to(dt)
    R, p, v, bg, ba = st
    R = lie.orthonormalize(R)

    # posterior information at the optimum (no prior term)
    Lp = None
    z15 = torch.zeros(15, dtype=dt, device=dev)
    st = (R, p, v, bg, ba)
    e, depth, Jv = vis(z15, st)
    ro, Jo = other(z15, st, True)
    Hv, _ = _vis_normal(e, Jv, inv_sigma2 * inlier * (depth > 0))
    H = Jo.T @ Jo
    H[:6, :6] += Hv
    H = 0.5 * (H + H.T)
    inl = inlier > 0
    return {"R": R, "p": p, "v": v, "bg": bg, "ba": ba, "inlier": inl,
            "n_inliers": torch.sum(inl), "H": H}


def pose_inertial_optimize_marg(cam_kind, cam_params, Tbc_R, Tbc_t, R1, p1, v1, bg1, ba1,
                                prior_info, pre: imu.Preintegrated, R2, p2, v2, points_w,
                                uv, inv_sigma2, valid, chi2_mono: float = CHI2_MONO,
                                n_rounds: int = 4, n_iters: int = 8):
    """PoseInertialOptimizationLastFrame with the marginalized prior: the
    previous and current frame states optimize jointly (30 dof), the
    previous one held by its 15x15 information from its own solve, which is
    then marginalized out of the joint Hessian into the next frame's prior.
    Returns dict(R, p, v, bg, ba, inlier, n_inliers, prior_info_out)."""
    dev, dt = p2.device, p2.dtype
    L9, Lg, La = _whiteners(pre)
    eye15 = torch.eye(15, dtype=dt, device=dev)
    eye30 = torch.eye(30, dtype=dt, device=dev)
    Lp = chol(prior_info + 1e-6 * eye15).T
    s1 = (R1, p1, v1, bg1, ba1)
    s2 = (R2, p2, v2, bg1, ba1)

    def other(x, with_jac):
        Ra, pa, va, bga, baa = _state_of(x[:15], *s1)
        Rb, pb, vb, bgb, bab = _state_of(x[15:], *s2)
        r9, J9 = inertial_residual_jac(Ra, pa, va, Rb, pb, vb, bgb, bab, pre, with_jac=with_jac)
        r = torch.cat([L9 @ r9, Lg @ (bgb - bga), La @ (bab - baa), Lp @ x[:15]])
        if not with_jac:
            return r, None
        Jra, Jrb = lie.so3_right_jacobian(x[:3]), lie.so3_right_jacobian(x[15:18])
        Z = torch.zeros((9, 3), dtype=dt, device=dev)
        Ji = torch.cat([J9["phi1"] @ Jra, J9["p1"], J9["v1"], Z, Z,
                        J9["phi2"] @ Jrb, J9["p2"], J9["v2"], J9["bg"], J9["ba"]], 1)
        Jo = torch.zeros((30, 30), dtype=dt, device=dev)
        Jo[0:9] = L9 @ Ji
        Jo[9:12, 9:12] = -Lg
        Jo[9:12, 24:27] = Lg
        Jo[12:15, 12:15] = -La
        Jo[12:15, 27:30] = La
        Jo[15:30, :15] = Lp
        return r, Jo

    def vis(x, with_jac=True):
        Rb, pb = _state_of(x[15:], *s2)[:2]
        e, depth, J = visual_residual_jac(cam_kind, cam_params, Rb, pb, Tbc_R, Tbc_t,
                                          points_w, uv, with_jac)
        if with_jac:
            J = torch.cat([J[..., :3] @ lie.so3_right_jacobian(x[15:18]), J[..., 3:]], -1)
        return e, depth, J

    def normal(x, w):
        e, depth, Jv = vis(x)
        ro, Jo = other(x, True)
        Hv, bv = _vis_normal(e, Jv, w(e, depth))
        H = Jo.T @ Jo
        H[15:21, 15:21] += Hv
        b = Jo.T @ ro
        b[15:21] += bv
        return H, b, e, depth, ro

    def cost(e, depth, ro, inlier):
        c = torch.sum(e * e, -1) * inv_sigma2
        return torch.sum(_robust_cost(c, chi2_mono) * inlier * (depth > 0)) + torch.sum(ro ** 2)

    x = torch.zeros(30, dtype=dt, device=dev)
    inlier = valid.to(dt)
    for rnd in range(n_rounds):
        robust = rnd < 2

        def weights(e, depth):
            chi2 = torch.sum(e * e, -1) * inv_sigma2
            w_h = torch.where(chi2 <= chi2_mono, 1.0, torch.sqrt(
                chi2_mono / torch.clamp(chi2, min=1e-12))) if robust else torch.ones_like(chi2)
            return w_h * inv_sigma2 * inlier * (depth > 0)

        lam = torch.tensor(1e-4, dtype=dt, device=dev)
        for _ in range(n_iters):
            H, b, e, depth, ro = normal(x, weights)
            H = H + lam * torch.diag(torch.diagonal(H)) + 1e-9 * eye30
            dx = -solve(H, b)
            x_new = x + dx
            e_n, d_n, _ = vis(x_new, False)
            ro_n, _ = other(x_new, False)
            ok = (cost(e_n, d_n, ro_n, inlier) < cost(e, depth, ro, inlier)) & \
                torch.all(torch.isfinite(dx))
            x = torch.where(ok, x_new, x)
            lam = torch.where(ok, lam * 0.5, lam * 4.0)
        e, depth, _ = vis(x, False)
        chi2 = torch.sum(e * e, -1) * inv_sigma2
        inlier = (valid & (chi2 <= chi2_mono) & (depth > 0)).to(dt)
    R, p, v, bg, ba = _state_of(x[15:], *s2)
    R = lie.orthonormalize(R)

    # joint Hessian at the optimum; marginalize the previous state
    H, _, _, _, _ = normal(x, lambda e, depth: inv_sigma2 * inlier * (depth > 0))
    H = 0.5 * (H + H.T)
    H11 = H[:15, :15] + 1e-6 * eye15
    H12 = H[:15, 15:]
    X, info = torch.linalg.solve_ex(H11, H12)
    X = torch.where((info == 0)[..., None, None], X, torch.nan)
    prior_out = H[15:, 15:] - H12.T @ X
    prior_out = 0.5 * (prior_out + prior_out.T)
    inl = inlier > 0
    return {"R": R, "p": p, "v": v, "bg": bg, "ba": ba, "inlier": inl,
            "n_inliers": torch.sum(inl), "prior_info_out": prior_out}
