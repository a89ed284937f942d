"""Batched two-view point triangulation on torch tensors.

Counterpart of hfnet_slam_tpu/geometry/triangulation.py: the inhomogeneous
DLT solved through its 3x3 normal equations with a closed-form adjugate
inverse (no SVD, so there is no sign ambiguity to reconcile with the
reference), then Gauss-Newton steps on the two-view reprojection residual.
"""
from __future__ import annotations

import torch


def _inv3(m):
    """Closed-form (adjugate) inverse of batched 3x3 matrices."""
    c00 = m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1]
    c01 = m[..., 0, 2] * m[..., 2, 1] - m[..., 0, 1] * m[..., 2, 2]
    c02 = m[..., 0, 1] * m[..., 1, 2] - m[..., 0, 2] * m[..., 1, 1]
    c10 = m[..., 1, 2] * m[..., 2, 0] - m[..., 1, 0] * m[..., 2, 2]
    c11 = m[..., 0, 0] * m[..., 2, 2] - m[..., 0, 2] * m[..., 2, 0]
    c12 = m[..., 0, 2] * m[..., 1, 0] - m[..., 0, 0] * m[..., 1, 2]
    c20 = m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]
    c21 = m[..., 0, 1] * m[..., 2, 0] - m[..., 0, 0] * m[..., 2, 1]
    c22 = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
    det = m[..., 0, 0] * c00 + m[..., 0, 1] * c10 + m[..., 0, 2] * c20
    tiny = torch.where(det < 0, -1e-18, 1e-18)
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-18, tiny, det)
    adj = torch.stack([
        torch.stack([c00, c01, c02], -1),
        torch.stack([c10, c11, c12], -1),
        torch.stack([c20, c21, c22], -1),
    ], -2)
    return adj * inv_det[..., None, None]


def _apply(R, X):
    """R (...,3,3) or (3,3) applied to X (...,3)."""
    return (R @ X[..., None])[..., 0] if R.dim() > 2 else X @ R.transpose(-1, -2)


def _gn_refine_step(X, xn1, xn2, R21, t21):
    """One Gauss-Newton step on the two-view reprojection residual."""
    z1 = X[..., 2]
    p2 = _apply(R21, X) + t21
    z2 = p2[..., 2]
    ok = (z1 > 1e-6) & (z2 > 1e-6)
    iz1 = 1.0 / torch.clamp(z1, min=1e-6)
    iz2 = 1.0 / torch.clamp(z2, min=1e-6)
    r1 = X[..., :2] * iz1[..., None] - xn1
    r2 = p2[..., :2] * iz2[..., None] - xn2
    zero = torch.zeros_like(iz1)
    J1 = torch.stack([
        torch.stack([iz1, zero, -X[..., 0] * iz1 * iz1], -1),
        torch.stack([zero, iz1, -X[..., 1] * iz1 * iz1], -1),
    ], -2)
    A2 = torch.stack([
        torch.stack([iz2, zero, -p2[..., 0] * iz2 * iz2], -1),
        torch.stack([zero, iz2, -p2[..., 1] * iz2 * iz2], -1),
    ], -2)
    J2 = A2 @ R21
    H = J1.transpose(-1, -2) @ J1 + J2.transpose(-1, -2) @ J2
    b = (J1.transpose(-1, -2) @ r1[..., None] + J2.transpose(-1, -2) @ r2[..., None])[..., 0]
    H = H + 1e-9 * torch.eye(3, dtype=H.dtype, device=H.device)
    dX = -(_inv3(H) @ b[..., None])[..., 0]
    Xn = X + dX
    fine = ok & torch.all(torch.isfinite(Xn), -1)
    return torch.where(fine[..., None], Xn, X)


def triangulate_dlt(xn1, xn2, R21, t21, refine: int = 1):
    """Triangulate in the camera-1 frame.

    xn1, xn2: (...,2) normalized coords; R21 (3,3) or (...,3,3), t21 (3,) or
    (...,3) with x2 = R21 x1 + t21 (broadcast over the point dims).
    Returns (...,3) points; the caller gates them with cheirality checks.
    """
    eye = torch.eye(3, dtype=xn1.dtype, device=xn1.device)
    zero = torch.zeros(3, 1, dtype=xn1.dtype, device=xn1.device)
    P1 = torch.cat([eye, zero], 1)
    P2 = torch.cat([R21, t21[..., None]], -1)  # (...,3,4)
    if P2.dim() > 2:  # per-batch poses: broadcast over the point axis
        P2 = P2[..., None, :, :]

    def rows(xn, P):
        return (xn[..., 0:1] * P[..., 2, :] - P[..., 0, :],
                xn[..., 1:2] * P[..., 2, :] - P[..., 1, :])

    a0, a1 = rows(xn1, P1)
    a2, a3 = rows(xn2, P2)
    A = torch.stack(torch.broadcast_tensors(a0, a1, a2, a3), -2)  # (...,4,4)
    A3 = A[..., :3]
    a4 = A[..., 3]
    AtA = A3.transpose(-1, -2) @ A3
    Atb = -(A3.transpose(-1, -2) @ a4[..., None])[..., 0]
    m = AtA + 1e-12 * eye
    X = (_inv3(m) @ Atb[..., None])[..., 0]
    Rb = R21[..., None, :, :] if R21.dim() > 2 else R21
    tb = t21[..., None, :] if t21.dim() > 1 else t21
    for _ in range(refine):
        X = _gn_refine_step(X, xn1, xn2, Rb, tb)
    return X


def cheirality_and_error(p1, xn1, xn2, R21, t21, th2, min_parallax_cos=0.99998):
    """Quality gates after triangulation (TwoViewReconstruction::CheckRT).
    Returns (good mask, parallax cosine)."""
    p2 = p1 @ R21.T + t21
    finite = torch.all(torch.isfinite(p1), -1)
    O2_in_1 = -(R21.T @ t21)
    ray2 = p1 - O2_in_1
    n1 = torch.linalg.norm(p1, dim=-1)
    n2 = torch.linalg.norm(ray2, dim=-1)
    cosp = torch.sum(p1 * ray2, -1) / torch.clamp(n1 * n2, min=1e-12)
    e1 = p1[..., :2] / torch.clamp(p1[..., 2:3], min=1e-12) - xn1
    e2 = p2[..., :2] / torch.clamp(p2[..., 2:3], min=1e-12) - xn2
    good = (finite & (p1[..., 2] > 0) & (p2[..., 2] > 0)
            & (torch.sum(e1 * e1, -1) < th2) & (torch.sum(e2 * e2, -1) < th2)
            & (cosp < min_parallax_cos))
    return good, cosp
