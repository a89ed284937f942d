"""Residual/Jacobian builders for the Gauss-Newton engines, batched over
edges by broadcasting (the reference vmaps per-edge functions).

Counterpart of hfnet_slam_tpu/optim/factors.py. Poses are world->camera
(R, t); tangent updates are left-multiplicative, xi = [rho, phi].
"""
from __future__ import annotations

import torch

from .. import lie
from ..geometry import cameras

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


def huber_weight(chi2, delta2):
    """Huber IRLS weight on the squared, information-weighted residual."""
    return torch.where(chi2 <= delta2, 1.0,
                       torch.sqrt(delta2 / torch.clamp(chi2, min=1e-12)))


def reproj_depth_residual(cam_kind, cam_params, R, t, p_w, uv, z_meas, w_z):
    """Reprojection + depth residual r = [du, dv, w_z (z - z_meas)] for edges
    (...,): R (...,3,3) or (3,3), t (...,3), p_w (...,3), uv (...,2).
    w_z = 0 turns the depth row off (a monocular edge).
    Returns r (...,3), J_pose (...,3,6), J_point (...,3,3), depth (...)."""
    pc = (R @ p_w[..., None])[..., 0] + t
    r2 = cameras.project(cam_kind, cam_params, pc) - uv
    rz = w_z * (pc[..., 2] - z_meas)
    r = torch.cat([r2, rz[..., None]], -1)
    Jproj = cameras.project_jac(cam_kind, cam_params, pc)      # (...,2,3)
    zero = torch.zeros_like(w_z)
    Jz = torch.stack([zero, zero, w_z], -1)                    # d rz / d pc
    Jpc = torch.cat([Jproj, Jz[..., None, :]], -2)             # (...,3,3)
    J_pose = torch.cat([Jpc, -Jpc @ lie.hat(pc)], -1)          # (...,3,6)
    return r, J_pose, Jpc @ R, pc[..., 2]


def reproj_depth_residual_rig(cam_kind, cam_params_l, cam_params_r, R_rl, t_rl, sel, R, t,
                              p_w, uv, z_meas, w_z):
    """Rig-aware reprojection(+depth) residual of edges (...,): sel = 0
    observes through the LEFT (body) camera, sel = 1 through the RIGHT one at
    the extrinsic (R_rl, t_rl) (x_r = R_rl x_l + t_rl) with its own
    intrinsics: the reference's ToBody edges. Both cameras share cam_kind;
    each edge blends extrinsic and intrinsics arithmetically by sel, so one
    batched factor serves mixed edge sets without branching.
    Returns r (...,3), J_pose (...,3,6) wrt the LEFT pose tangent,
    J_point (...,3,3), depth in the OBSERVING camera (...)."""
    s = sel.to(R.dtype)
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    R_x = s[..., None, None] * R_rl + (1.0 - s[..., None, None]) * eye
    t_x = s[..., None] * t_rl
    params = s[..., None] * cam_params_r + (1.0 - s[..., None]) * cam_params_l
    pc_l = (R @ p_w[..., None])[..., 0] + t
    pc = (R_x @ pc_l[..., None])[..., 0] + t_x
    r2 = cameras.project(cam_kind, params, pc) - uv
    rz = w_z * (pc[..., 2] - z_meas)
    r = torch.cat([r2, rz[..., None]], -1)
    Jproj = cameras.project_jac(cam_kind, params, pc)         # (...,2,3)
    zero = torch.zeros_like(w_z)
    Jz = torch.stack([zero, zero, w_z], -1)
    Jpc_l = torch.cat([Jproj, Jz[..., None, :]], -2) @ R_x     # d r / d pc_l
    J_pose = torch.cat([Jpc_l, -Jpc_l @ lie.hat(pc_l)], -1)
    return r, J_pose, Jpc_l @ R, pc[..., 2]
