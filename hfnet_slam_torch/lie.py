"""Lie groups SO(3) / SE(3) / Sim(3) on torch tensors.

Counterpart of hfnet_slam_tpu/lie.py. Same conventions:
  * rotations are (...,3,3) matrices, every function broadcasts over leading
    dims (the reference's vmap becomes plain broadcasting);
  * SE3 is a pair (R, t); tangent ordering se3 = [rho(3), phi(3)];
  * Sim3 is a triple (R, t, s); tangent ordering sim3 = [rho, phi, sigma]
    with s = exp(sigma);
  * small-angle branches are `torch.where` over Taylor expansions with the
    generic branch's inputs guarded, so neither branch produces NaN.
"""
from __future__ import annotations

import torch

_EPS = 1e-8


def hat(v):
    """so3 hat: (...,3) -> (...,3,3) skew-symmetric."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    o = torch.zeros_like(x)
    return torch.stack([
        torch.stack([o, -z, y], -1),
        torch.stack([z, o, -x], -1),
        torch.stack([-y, x, o], -1),
    ], -2)


def _eye_like(K):
    return torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)


def _sinc_coeffs(theta2):
    """(A, B, C) = (sin t/t, (1-cos t)/t^2, (t - sin t)/t^3), Taylor below 1e-8."""
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    small = theta2 < 1e-8
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - A) / theta2)
    return A, B, C


def so3_exp(phi):
    """Rodrigues: (...,3) -> (...,3,3)."""
    theta2 = torch.sum(phi * phi, -1)
    A, B, _ = _sinc_coeffs(theta2)
    K = hat(phi)
    return _eye_like(K) + A[..., None, None] * K + B[..., None, None] * (K @ K)


def so3_log(R):
    """(...,3,3) -> (...,3), |phi| <= pi, via the quaternion (largest pivot)."""
    q = rot_to_quat(R)
    q = q * torch.where(q[..., 0:1] < 0, -1.0, 1.0)  # w >= 0: angle in [0, pi]
    w, v = q[..., 0], q[..., 1:]
    nv2 = torch.sum(v * v, -1)
    small = nv2 < 1e-12
    nv_safe = torch.sqrt(torch.where(small, torch.ones_like(nv2), nv2))
    w_safe = torch.clamp(w, min=_EPS)
    scale = torch.where(
        small,
        2.0 / w_safe * (1.0 - nv2 / (3.0 * w_safe * w_safe)),
        2.0 * torch.atan2(nv_safe, w) / nv_safe,
    )
    return scale[..., None] * v


def so3_left_jacobian(phi):
    """Left Jacobian J_l of SO(3): (...,3) -> (...,3,3)."""
    theta2 = torch.sum(phi * phi, -1)
    _, B, C = _sinc_coeffs(theta2)
    K = hat(phi)
    return _eye_like(K) + B[..., None, None] * K + C[..., None, None] * (K @ K)


def so3_right_jacobian(phi):
    """Right Jacobian J_r(phi) = J_l(-phi) (IMU::RightJacobianSO3)."""
    return so3_left_jacobian(-phi)


def so3_right_jacobian_inv(phi):
    return so3_left_jacobian_inv(-phi)


def so3_left_jacobian_inv(phi):
    theta2 = torch.sum(phi * phi, -1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    half = 0.5 * theta
    small = theta2 < 1e-8
    s_half = torch.sin(half)
    s_half = torch.where(torch.abs(s_half) < _EPS, torch.ones_like(s_half), s_half)
    cot_coef = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        1.0 / theta2 - torch.cos(half) / (2.0 * theta * s_half),
    )
    K = hat(phi)
    return _eye_like(K) - 0.5 * K + cot_coef[..., None, None] * (K @ K)


def se3_exp(xi):
    """xi = [rho, phi] (...,6) -> (R (...,3,3), t (...,3))."""
    rho, phi = xi[..., :3], xi[..., 3:6]
    R = so3_exp(phi)
    V = so3_left_jacobian(phi)
    return R, (V @ rho[..., None])[..., 0]


def se3_log(R, t):
    phi = so3_log(R)
    Vinv = so3_left_jacobian_inv(phi)
    rho = (Vinv @ t[..., None])[..., 0]
    return torch.cat([rho, phi], -1)


def se3_inverse(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -(Rt @ t[..., None])[..., 0]


def se3_mul(R1, t1, R2, t2):
    return R1 @ R2, (R1 @ t2[..., None])[..., 0] + t1


def se3_retract(R, t, xi):
    """Left-multiplicative retraction T' = Exp(xi) * T (g2o/ORB-SLAM style)."""
    dR, dt = se3_exp(xi)
    return se3_mul(dR, dt, R, t)


def _sim3_W(phi, sigma):
    """W of the Sim(3) exp (t = W rho): C*I + A*hat(phi) + B*hat(phi)^2,
    with Taylor branches for small theta and/or sigma (Sophus calcW)."""
    theta2 = torch.sum(phi * phi, -1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    s = torch.exp(sigma)
    small_sig = torch.abs(sigma) < 1e-5
    small_th = theta2 < 1e-8
    sig_safe = torch.where(small_sig, torch.ones_like(sigma), sigma)
    th_safe = torch.where(small_th, torch.ones_like(theta), theta)
    th2_safe = torch.where(small_th, torch.ones_like(theta2), theta2)

    C = torch.where(small_sig, 1.0 + sigma / 2.0 + sigma * sigma / 6.0, (s - 1.0) / sig_safe)
    a = s * torch.sin(theta)
    b = s * torch.cos(theta)
    c = theta2 + sigma * sigma
    c_safe = torch.where(small_th & small_sig, torch.ones_like(c), c)
    A = torch.where(
        small_th,
        torch.where(small_sig, 0.5 + sigma / 3.0,
                    ((sigma - 1.0) * s + 1.0) / (sig_safe * sig_safe)),
        (a * sigma + (1.0 - b) * theta) / (th_safe * c_safe))
    B = torch.where(
        small_th,
        torch.where(small_sig, 1.0 / 6.0 + sigma / 8.0,
                    (s * (sigma * sigma / 2.0 - sigma + 1.0) - 1.0) / sig_safe ** 3),
        (C - ((b - 1.0) * sigma + a * theta) / c_safe) / th2_safe)
    K = hat(phi)
    return C[..., None, None] * _eye_like(K) + A[..., None, None] * K + B[..., None, None] * (K @ K)


def sim3_exp(xi):
    """xi = [rho, phi, sigma] (...,7) -> (R, t, s) with s = exp(sigma)."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    return so3_exp(phi), (_sim3_W(phi, sigma) @ rho[..., None])[..., 0], torch.exp(sigma)


def sim3_log(R, t, s):
    """rho = W^-1 t by the 3x3 adjugate (columns of W^-1 are cross products
    of W's rows): torch.linalg.solve returns NaN tangents under
    torch.func.vmap(jacfwd), which the pose graph uses."""
    phi = so3_log(R)
    sigma = torch.log(s)
    W = _sim3_W(phi, sigma)
    a0, a1, a2 = W[..., 0, :], W[..., 1, :], W[..., 2, :]
    c0, c1, c2 = (torch.linalg.cross(a1, a2), torch.linalg.cross(a2, a0),
                  torch.linalg.cross(a0, a1))
    det = torch.sum(a0 * c0, -1, keepdim=True)
    rho = (c0 * t[..., 0:1] + c1 * t[..., 1:2] + c2 * t[..., 2:3]) / det
    return torch.cat([rho, phi, sigma[..., None]], -1)


def sim3_inverse(R, t, s):
    Rt = R.transpose(-1, -2)
    s_inv = 1.0 / s
    return Rt, -s_inv[..., None] * (Rt @ t[..., None])[..., 0], s_inv


def sim3_mul(R1, t1, s1, R2, t2, s2):
    return R1 @ R2, s1[..., None] * (R1 @ t2[..., None])[..., 0] + t1, s1 * s2


def sim3_apply(R, t, s, p):
    return s[..., None] * (R @ p[..., None])[..., 0] + t


def rot_to_quat(R):
    """(...,3,3) -> (...,4) wxyz, Shepperd's method (branch-safe)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=0.0))

    def den(q):
        return 4.0 * torch.clamp(q, min=_EPS)

    qw0 = safe_sqrt(1.0 + tr) / 2.0
    q0 = torch.stack([qw0, (m21 - m12) / den(qw0), (m02 - m20) / den(qw0),
                      (m10 - m01) / den(qw0)], -1)
    qx1 = safe_sqrt(1.0 + m00 - m11 - m22) / 2.0
    q1 = torch.stack([(m21 - m12) / den(qx1), qx1, (m01 + m10) / den(qx1),
                      (m02 + m20) / den(qx1)], -1)
    qy2 = safe_sqrt(1.0 - m00 + m11 - m22) / 2.0
    q2 = torch.stack([(m02 - m20) / den(qy2), (m01 + m10) / den(qy2), qy2,
                      (m12 + m21) / den(qy2)], -1)
    qz3 = safe_sqrt(1.0 - m00 - m11 + m22) / 2.0
    q3 = torch.stack([(m10 - m01) / den(qz3), (m02 + m20) / den(qz3),
                      (m12 + m21) / den(qz3), qz3], -1)

    # branch by largest pivot; torch.argmax returns the first maximum, as
    # jnp.argmax does, so exact pivot ties pick the same branch
    pivots = torch.stack([tr, m00 - m11 - m22, -m00 + m11 - m22,
                          -m00 - m11 + m22], -1)
    k = torch.argmax(pivots, -1)
    qs = torch.stack([q0, q1, q2, q3], -2)  # (...,4,4)
    q = torch.gather(qs, -2, k[..., None, None].expand(k.shape + (1, 4)))[..., 0, :]
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_to_rot(q):
    """(...,4) wxyz -> (...,3,3)."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def normalize_rotation(R):
    """Nearest rotation by SVD, the reference's determinant-sign fix kept
    (IMU::NormalizeRotation)."""
    U, _, Vh = torch.linalg.svd(R)
    det = torch.linalg.det(U @ Vh)
    U = torch.cat([U[..., :, :2], U[..., :, 2:] * torch.sign(det)[..., None, None]], -1)
    return U @ Vh


def orthonormalize(R):
    """SO(3) re-projection via a quaternion round trip. Load-bearing for f32
    matrix-form poses: every composition leaks ~1e-7 of non-orthonormality
    and the constant-velocity model re-injects it each frame (see the
    reference's lie.orthonormalize)."""
    return quat_to_rot(rot_to_quat(R))
