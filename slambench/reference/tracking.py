"""Plain per-frame tracking step: motion-model projection search, pose-only
Levenberg-Marquardt, local-map projection search, pose-only LM again.

Frozen copy (commit 27c9911) of the arithmetic of the port's
slam/fused.track_step, optim/pose_opt.pose_optimize_core,
optim/factors.reproj_depth_residual, the pinhole model of
geometry/cameras and the SE(3) functions of lie.py, with the pinhole
camera only. It imports no module of the program. The benchmark hands it
the inputs the program's step received in the measured window (the
program's own map state at that frame) and compares the two outputs.
"""
from __future__ import annotations

import torch

NEG = -1e9
CHI2_MONO = 5.991
CHI2_STEREO = 7.815
Z_MIN = 1e-6
EPS = 1e-8


# ---- SO(3) / SE(3) ---------------------------------------------------------

def hat(v):
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    o = torch.zeros_like(x)
    return torch.stack([torch.stack([o, -z, y], -1), torch.stack([z, o, -x], -1),
                        torch.stack([-y, x, o], -1)], -2)


def _sinc(theta2):
    theta = torch.sqrt(torch.clamp(theta2, min=EPS * EPS))
    small = theta2 < 1e-8
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - A) / theta2)
    return A, B, C


def se3_retract(R, t, xi):
    """Exp(xi) * (R, t), xi = [rho, phi]."""
    rho, phi = xi[..., :3], xi[..., 3:6]
    A, B, C = _sinc(torch.sum(phi * phi, -1))
    K = hat(phi)
    eye = torch.eye(3, dtype=K.dtype, device=K.device)
    dR = eye + A[..., None, None] * K + B[..., None, None] * (K @ K)
    V = eye + B[..., None, None] * K + C[..., None, None] * (K @ K)
    dt = (V @ rho[..., None])[..., 0]
    return dR @ R, (dR @ t[..., None])[..., 0] + dt


def rot_to_quat(R):
    m00, m01, m02 = R[0, 0], R[0, 1], R[0, 2]
    m10, m11, m12 = R[1, 0], R[1, 1], R[1, 2]
    m20, m21, m22 = R[2, 0], R[2, 1], R[2, 2]
    tr = m00 + m11 + m22

    def sq(x):
        return torch.sqrt(torch.clamp(x, min=0.0))

    def den(q):
        return 4.0 * torch.clamp(q, min=EPS)

    w0 = sq(1.0 + tr) / 2.0
    x1 = sq(1.0 + m00 - m11 - m22) / 2.0
    y2 = sq(1.0 - m00 + m11 - m22) / 2.0
    z3 = sq(1.0 - m00 - m11 + m22) / 2.0
    qs = torch.stack([
        torch.stack([w0, (m21 - m12) / den(w0), (m02 - m20) / den(w0), (m10 - m01) / den(w0)]),
        torch.stack([(m21 - m12) / den(x1), x1, (m01 + m10) / den(x1), (m02 + m20) / den(x1)]),
        torch.stack([(m02 - m20) / den(y2), (m01 + m10) / den(y2), y2, (m12 + m21) / den(y2)]),
        torch.stack([(m10 - m01) / den(z3), (m02 + m20) / den(z3), (m12 + m21) / den(z3), z3]),
    ])
    k = torch.argmax(torch.stack([tr, m00 - m11 - m22, -m00 + m11 - m22, -m00 - m11 + m22]))
    q = qs[k]
    return q / torch.linalg.norm(q)


def quat_to_rot(q):
    q = q / torch.linalg.norm(q)
    w, x, y, z = q[0], q[1], q[2], q[3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)]),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)]),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]),
    ])


# ---- pinhole camera and the reprojection(+depth) edge -----------------------

def project(cam, pc):
    fx, fy, cx, cy = cam[0], cam[1], cam[2], cam[3]
    z = torch.clamp(pc[..., 2], min=Z_MIN)
    return torch.stack([fx * pc[..., 0] / z + cx, fy * pc[..., 1] / z + cy], -1)


def project_jac(cam, pc):
    fx, fy = cam[0], cam[1]
    x, y = pc[..., 0], pc[..., 1]
    zinv = 1.0 / torch.clamp(pc[..., 2], min=Z_MIN)
    zinv2 = zinv * zinv
    zero = torch.zeros_like(x)
    return torch.stack([torch.stack([fx * zinv, zero, -fx * x * zinv2], -1),
                        torch.stack([zero, fy * zinv, -fy * y * zinv2], -1)], -2)


def residual(cam, R, t, p_w, uv, z_meas, w_z):
    """r = [du, dv, w_z (z - z_meas)] (N,3), d r / d pose (N,3,6), depth."""
    pc = (R @ p_w[..., None])[..., 0] + t
    r = torch.cat([project(cam, pc) - uv, (w_z * (pc[:, 2] - z_meas))[:, None]], -1)
    zero = torch.zeros_like(w_z)
    Jpc = torch.cat([project_jac(cam, pc), torch.stack([zero, zero, w_z], -1)[:, None, :]], -2)
    return r, torch.cat([Jpc, -Jpc @ hat(pc)], -1), pc[:, 2]


def huber_weight(chi2, delta2):
    return torch.where(chi2 <= delta2, 1.0, torch.sqrt(delta2 / torch.clamp(chi2, min=1e-12)))


def robust_cost(chi2, delta2, inlier):
    return torch.minimum(chi2, delta2 + torch.sqrt(
        delta2 * torch.clamp(chi2 - delta2, min=0.0))) * inlier


def pose_lm(cam, R, t, p_w, uv, inv_sigma2, valid, z_meas, wz, rounds=4, iters=5):
    """Motion-only LM: 4 rounds of 5 iterations, chi-square re-classification
    between rounds, Huber in rounds 1-2. Returns (R, t, inlier)."""
    dt = p_w.dtype
    delta2 = torch.where(wz > 0, CHI2_STEREO, CHI2_MONO).to(dt)
    eye6 = torch.eye(6, dtype=dt, device=p_w.device)
    inlier = valid.to(dt)
    for rnd in range(rounds):
        lam = torch.tensor(1e-4, dtype=dt, device=p_w.device)
        for _ in range(iters):
            r, J, depth = residual(cam, R, t, p_w, uv, z_meas, wz)
            chi2 = torch.sum(r * r, -1) * inv_sigma2
            w = huber_weight(chi2, delta2) if rnd < 2 else torch.ones_like(chi2)
            w = w * inv_sigma2 * inlier * (depth > 0)
            JW = J * w[:, None, None]
            H = torch.einsum("nri,nrj->ij", JW, J)
            b = torch.einsum("nri,nr->i", JW, r)
            H = H + lam * torch.diag(torch.diagonal(H))
            dx = -torch.linalg.solve(H + 1e-9 * eye6, b)
            R2, t2 = se3_retract(R, t, dx)
            r2, _, _ = residual(cam, R2, t2, p_w, uv, z_meas, wz)
            diff = (robust_cost(torch.sum(r2 * r2, -1) * inv_sigma2, delta2, inlier)
                    - robust_cost(chi2, delta2, inlier))
            accept = torch.sum(diff) < 0
            R = torch.where(accept, R2, R)
            t = torch.where(accept, t2, t)
            lam = torch.where(accept, lam * 0.5, lam * 4.0)
        R = quat_to_rot(rot_to_quat(R))
        r, _, depth = residual(cam, R, t, p_w, uv, z_meas, wz)
        inlier = (valid & (torch.sum(r * r, -1) * inv_sigma2 <= delta2) & (depth > 0)).to(dt)
    return R, t, inlier > 0


# ---- guided matching ---------------------------------------------------------

def mutual_argmax(S, feat_mask, gate):
    """Row argmax with the cross-check over (B,N,C) similarities, first
    maximum on ties; -1 where none passes."""
    idx = torch.argmax(S, -1)
    best = torch.gather(S, -1, idx[..., None])[..., 0]
    hit = (best > gate) & (best > NEG / 2)
    rows = torch.arange(S.shape[1], device=S.device)
    hit &= torch.gather(torch.argmax(S, -2), 1, idx) == rows
    return torch.where(hit & feat_mask, idx, -1)


def match_projected(cam, W, H, R, t, pos, dsc, ok, xy, desc, radii, feat_mask, th_high,
                    normal=None, dmin=None, dmax=None):
    """SearchByProjection for a batch of B poses: R (B,3,3), t (B,3), pos
    (B,C,3), dsc (B,C,D), ok (B,C), xy (B,N,2), desc (B,N,D), radii and
    feat_mask (B,N). Projects the candidates, gates them by window (and by
    the viewing cosine and scale band when normals are given), keeps mutual
    best descriptor similarities. Returns (idx (B,N) or -1, frustum mask)."""
    pc = pos @ R.transpose(-1, -2) + t[:, None, :]
    uv = project(cam, pc)
    mp_ok = ok & (pc[..., 2] > 0.1) & (uv[..., 0] >= 0) & (uv[..., 0] < W) \
        & (uv[..., 1] >= 0) & (uv[..., 1] < H)
    d2 = (torch.sum(xy * xy, -1)[..., :, None] + torch.sum(uv * uv, -1)[..., None, :]
          - 2.0 * (xy @ uv.transpose(-1, -2)))
    if normal is not None:
        center = -(R.transpose(-1, -2) @ t[..., None])[..., 0]
        ray = pos - center[:, None, :]
        dist = torch.clamp(torch.linalg.norm(ray, dim=-1), min=1e-9)
        view_cos = torch.sum(ray / dist[..., None] * normal, -1)
        has = dmax > 0
        mp_ok = mp_ok & (~has | ((dist >= 0.8 * dmin) & (dist <= 1.2 * dmax) & (view_cos > 0.5)))
        rad_mp = torch.where(has & (view_cos > 0.998), 2.5 / 4.0, 1.0)
        allowed = d2 <= (radii[..., :, None] * rad_mp[..., None, :]) ** 2
    else:
        allowed = d2 < radii[..., :, None] ** 2
    S = desc @ dsc.transpose(-1, -2)
    S = torch.where(feat_mask[..., :, None] & mp_ok[..., None, :] & allowed, S, NEG)
    return mutual_argmax(S, feat_mask, 1.0 - th_high * th_high / 2.0), mp_ok


def track_step(cam, W, H, R0, t0, m_pos, m_desc, m_normal, m_dmin, m_dmax, m_valid,
               motion_ids, local_ids, xy, desc, octave, mask, z_meas, wz, cfg):
    """One tracked frame. `cfg` holds motion_window, motion_window_retry,
    local_window, th_high, min_motion_matches. Returns R, t, obs (final
    map-point id per slot or -1) and stats [motion matches, inliers after
    the first LM, final inliers]."""
    octave_f = octave.to(torch.float32)
    radii_base = 1.2 ** octave_f
    inv_sigma2 = 1.0 / (1.2 ** (2.0 * octave_f))
    M = m_pos.shape[0]

    def gather(ids):
        safe = torch.clamp(ids, 0, M - 1)
        return safe, (ids >= 0) & m_valid[safe]

    ms, mok = gather(motion_ids)
    radii2 = torch.stack([cfg["motion_window"] * radii_base,
                          cfg["motion_window_retry"] * radii_base])
    tries, _ = match_projected(cam, W, H, R0.expand(2, 3, 3), t0.expand(2, 3),
                               m_pos[ms].expand(2, -1, -1), m_desc[ms].expand(2, -1, -1),
                               mok.expand(2, -1), xy.expand(2, -1, -1),
                               desc.expand(2, -1, -1), radii2, mask.expand(2, -1),
                               cfg["th_high"])
    idx1 = tries[1] if int(torch.sum(tries[0] >= 0)) < cfg["min_motion_matches"] else tries[0]
    n1 = torch.sum(idx1 >= 0)
    obs1 = torch.where(idx1 >= 0, motion_ids[torch.clamp(idx1, 0, motion_ids.shape[0] - 1)], -1)
    R1, t1, inl1 = pose_lm(cam, R0, t0, m_pos[torch.clamp(obs1, 0, M - 1)], xy, inv_sigma2,
                           obs1 >= 0, z_meas, wz)
    obs1f = torch.where(inl1, obs1, -1)

    ls, lok = gather(local_ids)
    taken = torch.zeros(M + 1, dtype=torch.bool, device=m_pos.device)
    taken[torch.where(obs1f >= 0, obs1f, M)] = True
    lok = lok & ~taken[ls]
    idx2, _ = match_projected(cam, W, H, R1[None], t1[None], m_pos[ls][None],
                              m_desc[ls][None], lok[None], xy[None], desc[None],
                              (cfg["local_window"] * radii_base)[None], mask[None],
                              cfg["th_high"], normal=m_normal[ls][None],
                              dmin=m_dmin[ls][None], dmax=m_dmax[ls][None])
    idx2 = idx2[0]
    new = (idx2 >= 0) & (obs1f < 0)
    obs2 = torch.where(new, local_ids[torch.clamp(idx2, 0, local_ids.shape[0] - 1)], obs1f)
    R2, t2, inl2 = pose_lm(cam, R1, t1, m_pos[torch.clamp(obs2, 0, M - 1)], xy, inv_sigma2,
                           obs2 >= 0, z_meas, wz)
    obs = torch.where(inl2, obs2, -1)
    return {"R": R2, "t": t2, "obs": obs,
            "stats": torch.stack([n1, torch.sum(inl1), torch.sum(inl2)])}
