"""Sim(3) estimation: closed-form Horn alignment, batched RANSAC, and
bidirectional-reprojection Sim3 refinement.

Counterpart of hfnet_slam_tpu/optim/sim3.py (the reference's Sim3Solver and
Optimizer::OptimizeSim3): every RANSAC hypothesis is a 3-point Horn solve,
all hypotheses scored in one batched projection; the refinement is
Gauss-Newton on the 7-d tangent with Jacobians from forward-mode autodiff
(torch.func.jacfwd for the reference's jax.jacfwd, evaluated in float64; see
optim/pose_graph.py).

The reference draws the 3-point samples inside the jitted function (Gumbel
top-3 over the valid pairs). Here `sim3_ransac` takes the (n_hyps, 3)
indices `picks` as an argument (optim.pnp.draw_picks makes them from a
torch.Generator), so a parity test can pass the reference's own draws.
"""
from __future__ import annotations

import torch

from .. import lie
from ..geometry import cameras


def horn_sim3(p1, p2, w=None, fix_scale: bool = False):
    """Closed-form Sim3 (R, t, s) minimizing |p2 - s R p1 - t|^2, batched
    over leading dims: p1, p2 (...,N,3), w (...,N) optional weights. The
    rotation is the SVD solution with the reference's determinant sign fix,
    so the columns' signs from torch.linalg.svd do not matter."""
    if w is None:
        w = torch.ones(p1.shape[:-1], dtype=p1.dtype, device=p1.device)
    wsum = torch.clamp(torch.sum(w, -1), min=1e-9)
    c1 = torch.sum(p1 * w[..., None], -2) / wsum[..., None]
    c2 = torch.sum(p2 * w[..., None], -2) / wsum[..., None]
    q1 = p1 - c1[..., None, :]
    q2 = p2 - c2[..., None, :]
    M = torch.einsum("...n,...ni,...nj->...ij", w, q2, q1)
    U, _, Vh = torch.linalg.svd(M)
    d = torch.sign(torch.linalg.det(U @ Vh))
    D = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1))
    R = U @ D @ Vh
    # s = <q2, R q1> / |q1|^2, the asymmetric form of Sim3Solver
    Rq1 = q1 @ R.transpose(-1, -2)
    num = torch.sum(w[..., None] * q2 * Rq1, (-2, -1))
    den = torch.clamp(torch.sum(w[..., None] * q1 * q1, (-2, -1)), min=1e-12)
    s = torch.ones_like(num) if fix_scale else num / den
    t = c2 - s[..., None] * (R @ c1[..., None])[..., 0]
    return R, t, s


def _inliers(cam_kind, cam_params, R12, t12, s12, p1_c, p2_c, uv1, uv2, is1, is2,
             valid, chi2_th):
    """Bidirectional reprojection inliers of S12 (Sim3Solver::CheckInliers),
    batched over leading dims of (R12, t12, s12)."""
    p2_in1 = s12[..., None, None] * (p2_c @ R12.transpose(-1, -2)) + t12[..., None, :]
    p1_in2 = (p1_c - t12[..., None, :]) @ R12 / torch.clamp(s12, min=1e-9)[..., None, None]
    e1 = cameras.project(cam_kind, cam_params, p2_in1) - uv1
    e2 = cameras.project(cam_kind, cam_params, p1_in2) - uv2
    return (valid & (torch.sum(e1 * e1, -1) * is1 < chi2_th)
            & (torch.sum(e2 * e2, -1) * is2 < chi2_th)
            & (p2_in1[..., 2] > 0) & (p1_in2[..., 2] > 0))


def sim3_ransac(cam_kind, cam_params, p1_c, p2_c, uv1, uv2, inv_sigma2_1, inv_sigma2_2,
                valid, picks, chi2_th: float = 9.21, fix_scale: bool = False):
    """S12 = (R12, t12, s12), frame-2 coordinates into frame 1, from matched
    points with the hypotheses `picks` (H, 3) evaluated as one batch. The
    best hypothesis is the lowest index among those with the most inliers
    (equal counts are common); it is refit on its inliers and the refit kept
    when it has no fewer inliers. Returns dict(R12, t12, s12, inliers (N,),
    n_inliers, n_valid)."""
    def count(R, t, s):
        return _inliers(cam_kind, cam_params, R, t, s, p1_c, p2_c, uv1, uv2,
                        inv_sigma2_1, inv_sigma2_2, valid, chi2_th)

    R_h, t_h, s_h = horn_sim3(p2_c[picks], p1_c[picks], fix_scale=fix_scale)
    inl_h = count(R_h, t_h, s_h)                                      # (H,N)
    counts = torch.where((s_h > 0.1) & (s_h < 10.0), torch.sum(inl_h, 1), -1)
    best = torch.argmax(counts)
    inliers = inl_h[best]
    R12, t12, s12 = horn_sim3(p2_c, p1_c, w=inliers.to(p1_c.dtype), fix_scale=fix_scale)
    inliers2 = count(R12, t12, s12)
    use_refit = ((torch.sum(inliers2) >= torch.sum(inliers))
                 & torch.all(torch.isfinite(t12)) & torch.isfinite(s12)
                 & (s12 > 0.1) & (s12 < 10.0))
    inliers = torch.where(use_refit, inliers2, inliers)
    return {"R12": torch.where(use_refit, R12, R_h[best]),
            "t12": torch.where(use_refit, t12, t_h[best]),
            "s12": torch.where(use_refit, s12, s_h[best]),
            "inliers": inliers, "n_inliers": torch.sum(inliers),
            "n_valid": torch.sum(valid)}


def optimize_sim3(cam_kind, cam_params, R12, t12, s12, p1_c, p2_c, uv1, uv2,
                  inv_sigma2_1, inv_sigma2_2, valid, chi2_th: float = 10.0,
                  n_iters: int = 20, fix_scale: bool = False):
    """Gauss-Newton refinement of S12 over bidirectional reprojection
    residuals, Huber-weighted, accepted on robust-cost decrease, then a chi2
    inlier sweep (Optimizer::OptimizeSim3, th2 = 10). Right-multiplicative
    retraction on [rho, phi, sigma]. Returns dict(R12, t12, s12, inliers,
    n_inliers)."""
    dt, dev = p1_c.dtype, p1_c.device
    zero = torch.zeros(7, dtype=dt, device=dev)
    eye7 = torch.eye(7, dtype=dt, device=dev)

    def residuals(xi, R0, t0, s0, p1=p1_c, p2=p2_c, u1=uv1, u2=uv2, params=cam_params):
        R, t, s = lie.sim3_mul(R0, t0, s0, *lie.sim3_exp(xi))
        p2_in1 = s * (p2 @ R.T) + t
        Ri, ti, si = lie.sim3_inverse(R, t, s)
        p1_in2 = si * (p1 @ Ri.T) + ti
        e1 = cameras.project(cam_kind, params, p2_in1) - u1
        e2 = cameras.project(cam_kind, params, p1_in2) - u2
        return e1, e2, p2_in1[:, 2], p1_in2[:, 2]

    data64 = [x.double() for x in (p1_c, p2_c, uv1, uv2, cam_params)]

    def chi2_of(e1, e2):
        return torch.sum(e1 * e1, -1) * inv_sigma2_1, torch.sum(e2 * e2, -1) * inv_sigma2_2

    def huber_w(c):
        return torch.where(c <= chi2_th, 1.0, torch.sqrt(chi2_th / torch.clamp(c, min=1e-12)))

    def rob(c):
        return torch.minimum(c, chi2_th + torch.sqrt(chi2_th * torch.clamp(c - chi2_th, min=0.0)))

    R = torch.as_tensor(R12, dtype=dt, device=dev)
    t = torch.as_tensor(t12, dtype=dt, device=dev)
    s = torch.as_tensor(s12, dtype=dt, device=dev).reshape(())
    inlier = valid.to(dt)
    for _ in range(n_iters):
        def res_flat(xi, pose64=(R.double(), t.double(), s.double())):
            e1, e2, _, _ = residuals(xi, *pose64, *data64)
            return torch.cat([e1.reshape(-1), e2.reshape(-1)])

        J = torch.func.jacfwd(res_flat)(zero.double()).to(dt)          # (4N,7)
        e1, e2, z1, z2 = residuals(zero, R, t, s)
        c1, c2 = chi2_of(e1, e2)
        w1 = inlier * inv_sigma2_1 * huber_w(c1) * (z1 > 0)
        w2 = inlier * inv_sigma2_2 * huber_w(c2) * (z2 > 0)
        w = torch.cat([torch.repeat_interleave(w1, 2), torch.repeat_interleave(w2, 2)])
        r = torch.cat([e1.reshape(-1), e2.reshape(-1)])
        H = torch.einsum("ni,n,nj->ij", J, w, J)
        b = torch.einsum("ni,n->i", J, w * r)
        if fix_scale:
            H = H.clone()
            H[6, :] = 0.0
            H[:, 6] = 0.0
            H[6, 6] = 1.0
            b = torch.cat([b[:6], b.new_zeros(1)])
        dx = -torch.linalg.solve_ex(H + 1e-6 * eye7, b)[0]
        R_n, t_n, s_n = lie.sim3_mul(R, t, s, *lie.sim3_exp(dx))
        c1n, c2n = chi2_of(*residuals(zero, R_n, t_n, s_n)[:2])
        dcost = torch.sum((rob(c1n) - rob(c1)) * inlier) + torch.sum((rob(c2n) - rob(c2)) * inlier)
        ok = (dcost < 0) & torch.all(torch.isfinite(dx))
        R = torch.where(ok, lie.orthonormalize(R_n), R)
        t = torch.where(ok, t_n, t)
        s = torch.where(ok, s_n, s)
    e1, e2, z1, z2 = residuals(zero, R, t, s)
    c1, c2 = chi2_of(e1, e2)
    inliers = valid & (c1 <= chi2_th) & (c2 <= chi2_th) & (z1 > 0) & (z2 > 0)
    return {"R12": R, "t12": t, "s12": s, "inliers": inliers, "n_inliers": torch.sum(inliers)}
