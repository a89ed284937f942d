"""Motion-only pose optimization (the per-frame tracking optimizer).

Counterpart of hfnet_slam_tpu/optim/pose_opt.py: Levenberg-Marquardt over
one SE3 pose with reprojection edges, 4 rounds x 5 iterations, chi-square
inlier/outlier re-classification between rounds (outliers are recycled) and
the Huber kernel dropped from round 3 on (Optimizer::PoseOptimization).

The reference's lax.scan is a fixed-count Python loop here. The accept test
(summed per-edge cost differences) stays on the device as torch.where:
nothing in the loop reads a value back to the host, so the loop can be
captured in a CUDA graph (slam/fused.track_step replays it). The damping is
made on the device, and the 6x6 solve is `solve_ex` without its error check
(the same LU as `solve`): a singular system gives a non-finite step, which
the accept test rejects, as with the reference's jnp.linalg.solve, which
never raises.
"""
from __future__ import annotations

import torch

from .. import lie
from . import factors

N_ROUNDS = 4
N_ITERS = 5


def pose_optimize(cam_kind, cam_params, R0, t0, points_w, uv, inv_sigma2, valid,
                  chi2_th: float = factors.CHI2_MONO, z_meas=None, wz=None):
    """Optimize Tcw given fixed 3-D points and their observations.
    Returns dict(R, t, inlier (N,) bool, n_inliers)."""
    return pose_optimize_core(cam_kind, cam_params, R0, t0, points_w, uv,
                              inv_sigma2, valid, chi2_th, z_meas, wz)


def _robust(chi2, delta2, inlier):
    return torch.minimum(chi2, delta2 + torch.sqrt(
        delta2 * torch.clamp(chi2 - delta2, min=0.0))) * inlier


def pose_optimize_core(cam_kind, cam_params, R0, t0, points_w, uv, inv_sigma2,
                       valid, chi2_th=factors.CHI2_MONO, z_meas=None, wz=None):
    """Body of pose_optimize; also called per frame by slam/fused.track_step."""
    N = points_w.shape[0]
    dev, dt = points_w.device, points_w.dtype
    if z_meas is None:
        z_meas = torch.zeros(N, dtype=dt, device=dev)
    if wz is None:
        wz = torch.zeros(N, dtype=dt, device=dev)
    delta2 = torch.where(wz > 0, factors.CHI2_STEREO, chi2_th).to(dt)
    eye6 = torch.eye(6, dtype=dt, device=dev)

    def residuals(R, t):
        r, Jp, _, depth = factors.reproj_depth_residual(
            cam_kind, cam_params, R, t, points_w, uv, z_meas, wz)
        return r, Jp, depth

    def chi2_of(r):
        return torch.sum(r * r, -1) * inv_sigma2

    R, t = R0, t0
    inlier = valid.to(dt)
    for rnd in range(N_ROUNDS):
        robust = rnd < 2  # rounds 1-2 Huber, 3-4 plain least squares
        lam = torch.full((), 1e-4, dtype=dt, device=dev)
        for _ in range(N_ITERS):
            r, J, depth = residuals(R, t)
            chi2 = chi2_of(r)
            w = factors.huber_weight(chi2, delta2) if robust else torch.ones_like(chi2)
            w = w * inv_sigma2 * inlier * (depth > 0)
            JW = J * w[:, None, None]
            H = torch.einsum("nri,nrj->ij", JW, J)
            b = torch.einsum("nri,nr->i", JW, r)
            H = H + lam * torch.diag(torch.diagonal(H))
            dx = -torch.linalg.solve_ex(H + 1e-9 * eye6, b, check_errors=False)[0]
            R_new, t_new = lie.se3_retract(R, t, dx)
            # accept on the SUM OF PER-EDGE cost differences: the difference
            # of two large f32 sums loses a small step's signal
            r2, _, _ = residuals(R_new, t_new)
            diff = _robust(chi2_of(r2), delta2, inlier) - _robust(chi2, delta2, inlier)
            accept = torch.sum(diff) < 0
            R = torch.where(accept, R_new, R)
            t = torch.where(accept, t_new, t)
            lam = torch.where(accept, lam * 0.5, lam * 4.0)
        R = lie.orthonormalize(R)
        r, _, depth = residuals(R, t)
        inlier = (valid & (chi2_of(r) <= delta2) & (depth > 0)).to(dt)
    inl = inlier > 0
    return {"R": R, "t": t, "inlier": inl, "n_inliers": torch.sum(inl)}
