"""PnP RANSAC: camera pose from 3D-2D correspondences, all hypotheses batched.

Counterpart of hfnet_slam_tpu/optim/pnp.py (the reference's MLPnPsolver in
Tracking::Relocalization becomes a batch of 6-point DLT hypotheses, each a
12x12 SVD, scored against every correspondence in one batched projection).

The reference draws its samples inside the jitted function (Gumbel top-k over
the valid set). Here the core takes the (n_hyps, 6) sample indices `picks`
as an argument: `draw_picks` makes them from a torch.Generator at run time,
and a parity test can pass the reference's own draws.
"""
from __future__ import annotations

import torch

from ..geometry import cameras


def draw_picks(valid, n_hyps: int, k: int, generator: torch.Generator):
    """(n_hyps, k) indices, each row k distinct valid entries: Gumbel top-k
    over the valid mask, the reference's sampler. Drawn on the host from
    `generator`, returned on valid's device."""
    u = torch.rand((n_hyps, valid.shape[0]), generator=generator, dtype=torch.float32)
    g = -torch.log(-torch.log(torch.clamp(u, min=1e-20)))
    g = torch.where(valid.cpu()[None, :], g, -torch.inf)
    return torch.topk(g, k, dim=1).indices.to(valid.device)


def _dlt_pose(X, xn):
    """Batched 6+ point DLT for P = [R|t]: X (H,S,3) world points, xn (H,S,2)
    normalized image points. Returns (R (H,3,3), t (H,3), ok (H,))."""
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], -1)             # (H,S,4)
    z = torch.zeros_like(Xh)
    u, v = xn[..., 0:1], xn[..., 1:2]
    A = torch.cat([torch.cat([Xh, z, -u * Xh], -1),
                   torch.cat([z, Xh, -v * Xh], -1)], -2)               # (H,2S,12)
    _, _, Vh = torch.linalg.svd(A, full_matrices=True)
    P = Vh[..., -1, :].reshape(A.shape[:-2] + (3, 4))
    # sign: the majority of the sample must lie in front of the camera
    depths = (Xh @ P[..., 2, :, None])[..., 0]
    sgn = torch.where(torch.sum(depths > 0, -1) >= torch.sum(depths < 0, -1), 1.0, -1.0)
    P = P * sgn[..., None, None]
    U, S, Vh2 = torch.linalg.svd(P[..., :3])
    d = torch.sign(torch.linalg.det(U @ Vh2))
    D = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1))
    R = U @ D @ Vh2
    scale = torch.mean(S, -1) * d
    t = P[..., 3] / torch.where(torch.abs(scale) < 1e-12, 1e-12, scale)[..., None]
    ok = torch.isfinite(scale) & (torch.abs(scale) > 1e-9)
    return R, t, ok


def pnp_ransac(cam_kind, cam_params, points_w, uv, inv_sigma2, valid, picks,
               chi2_th: float = 5.991):
    """Batched-RANSAC PnP over the hypotheses `picks` (H, 6). Returns
    dict(R, t, inliers (N,), n_inliers); the best hypothesis is the lowest
    index among those with the most inliers."""
    xn = cameras.unproject(cam_kind, cam_params, uv)[:, :2]
    R_h, t_h, ok_h = _dlt_pose(points_w[picks], xn[picks])
    pc = torch.einsum("hij,nj->hni", R_h, points_w) + t_h[:, None, :]
    e = cameras.project(cam_kind, cam_params, pc) - uv
    chi2 = torch.sum(e * e, -1) * inv_sigma2
    inl_h = valid & (chi2 < chi2_th) & (pc[..., 2] > 0)
    counts = torch.where(ok_h, torch.sum(inl_h, 1), -1)
    best = torch.argmax(counts)
    return {"R": R_h[best], "t": t_h[best], "inliers": inl_h[best],
            "n_inliers": torch.clamp(counts[best], min=0)}
