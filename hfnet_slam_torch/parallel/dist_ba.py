"""Distributed bundle adjustment over a mesh of landmark shards.

Counterpart of hfnet_slam_tpu/parallel/dist_ba.py: Schur-complement BA
where the landmark blocks, independent once marginalized, are split into
the mesh's shards, and the reduced camera system (small and dense) is summed
over the mesh (`Mesh.psum`) and solved replicated.

Partitioning: shard d owns the landmarks whose index is d modulo D (D
shards) and every edge that observes them (`partition_edges`, packed on the
host exactly as the reference packs them). Each process computes, for each
of its shards at once (a leading shard axis),

    Hpp, bp (per landmark), Wcp (the shard's landmarks x all K cameras),
    its part of Hcc and bc (its edges only),

then the psum gives the full (K,6,6) and (K,6) camera system and the Schur
complement S = Hcc - W Hpp^-1 W^T in every process; the (6K x 6K) solve is
replicated, and each process back-substitutes its own landmark shards. The
communication per iteration is one sum of O(K^2 * 36) floats, whatever the
number of landmarks.

A process keeps every shard's arrays (the packing is host-side), updates
only its own shards' landmarks, and gathers them all at the end of
`dist_bundle_adjust`. The f32 safeguards mirror the single solver's and the
reference's: accept on the psum of per-edge cost differences, a
Jacobi-scaled reduced solve, per-camera and per-point step caps, a lambda
floor of 1e-4.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import device as D
from .. import lie
from ..optim import factors
from ..optim.ba import _segment_sum, inv3_sym
from ..optim.inertial import solve
from .multihost import Mesh


class ShardedBA(NamedTuple):
    """Edge and landmark arrays bucketed per shard: D shards, Ml landmarks
    and El edges per shard. Landmark ids inside a shard are LOCAL (0..Ml);
    camera ids global."""

    poses_R: torch.Tensor      # (K,3,3) replicated
    poses_t: torch.Tensor      # (K,3)
    fixed: torch.Tensor        # (K,) bool
    points: torch.Tensor       # (D,Ml,3)
    kf_idx: torch.Tensor       # (D,El) int64
    pt_idx: torch.Tensor       # (D,El) int64, local landmark index
    uv: torch.Tensor           # (D,El,2)
    inv_sigma2: torch.Tensor   # (D,El)
    valid: torch.Tensor        # (D,El) bool
    # stereo / RGB-D depth rows: measured depth and the pixel-equivalent
    # weight bf / z^2; wz = 0 turns the row off (as optim/ba.BAProblem)
    z_meas: Optional[torch.Tensor] = None   # (D,El)
    wz: Optional[torch.Tensor] = None       # (D,El)


def partition_edges(n_dev, K, M_per_dev, E_per_dev, poses_R, poses_t, fixed, points, kf_idx,
                    pt_idx, uv, inv_sigma2, valid, z_meas=None, wz=None, device=None):
    """Host-side packing (numpy in, tensors on `device` out, None meaning
    CUDA): landmarks round-robin into n_dev shards, each edge into its
    landmark's shard, in the reference's bucket order. Caps must be sized to
    the problem (the mapper computes them exactly); an overflow is logged:
    a dropped edge silently weakens the solve. Returns (ShardedBA, (owner,
    local, ok)): each landmark's shard, its index there, and whether it fit."""
    dev = D.resolve(device)
    Dn, Ml, El = n_dev, M_per_dev, E_per_dev
    n_dropped = 0
    pts = np.zeros((Dn, Ml, 3), np.float32)
    kfe = np.zeros((Dn, El), np.int64)
    pte = np.zeros((Dn, El), np.int64)
    uve = np.zeros((Dn, El, 2), np.float32)
    ise = np.ones((Dn, El), np.float32)
    vae = np.zeros((Dn, El), bool)
    zme = np.zeros((Dn, El), np.float32)
    wze = np.zeros((Dn, El), np.float32)
    if z_meas is None:
        z_meas = np.zeros(len(kf_idx), np.float32)
    if wz is None:
        wz = np.zeros(len(kf_idx), np.float32)

    M = len(points)
    owner = np.arange(M) % Dn
    local = np.arange(M) // Dn
    ok = local < Ml
    for d in range(Dn):
        sel = ok & (owner == d)
        pts[d, local[sel]] = np.asarray(points)[sel]
    # stable-sort the edges by owning shard, then place them in order
    valid = np.asarray(valid, bool)
    pt_idx = np.asarray(pt_idx)
    e_sel = np.nonzero(valid & ok[pt_idx])[0]
    n_dropped += int(valid.sum() - len(e_sel))
    if len(e_sel):
        d_e = owner[pt_idx[e_sel]]
        order = np.argsort(d_e, kind="stable")
        e_sel, d_e = e_sel[order], d_e[order]
        starts = np.searchsorted(d_e, np.arange(Dn))
        pos = np.arange(len(e_sel)) - starts[d_e]
        keep = pos < El
        n_dropped += int((~keep).sum())
        e_k, d_k, p_k = e_sel[keep], d_e[keep], pos[keep]
        kfe[d_k, p_k] = np.asarray(kf_idx)[e_k]
        pte[d_k, p_k] = local[pt_idx[e_k]]
        uve[d_k, p_k] = np.asarray(uv)[e_k]
        ise[d_k, p_k] = np.asarray(inv_sigma2)[e_k]
        zme[d_k, p_k] = np.asarray(z_meas)[e_k]
        wze[d_k, p_k] = np.asarray(wz)[e_k]
        vae[d_k, p_k] = True
    if n_dropped:
        from ..utils.log import warn

        warn(f"dist_ba.partition_edges: {n_dropped} edges overflowed the per-shard caps "
             f"(Ml={Ml}, El={El}) and were DROPPED: size the caps to the problem")

    def t(x, dtype=torch.float32):
        return torch.tensor(np.asarray(x), dtype=dtype, device=dev)

    return ShardedBA(
        poses_R=t(poses_R), poses_t=t(poses_t), fixed=t(fixed, torch.bool), points=t(pts),
        kf_idx=t(kfe, torch.int64), pt_idx=t(pte, torch.int64), uv=t(uve),
        inv_sigma2=t(ise), valid=t(vae, torch.bool), z_meas=t(zme), wz=t(wze),
    ), (owner, local, ok)


def _with_depth_defaults(prob: ShardedBA) -> ShardedBA:
    """Absent depth fields as mono-edge zeros."""
    z = torch.zeros_like(prob.inv_sigma2)
    return prob._replace(z_meas=z if prob.z_meas is None else prob.z_meas,
                         wz=z if prob.wz is None else prob.wz)


class _Local(NamedTuple):
    """This process's shards of a ShardedBA's per-shard arrays."""

    points: torch.Tensor
    kf_idx: torch.Tensor
    pt_idx: torch.Tensor
    uv: torch.Tensor
    inv_sigma2: torch.Tensor
    valid: torch.Tensor
    z_meas: torch.Tensor
    wz: torch.Tensor


def _local(prob: ShardedBA, mesh: Mesh) -> _Local:
    if prob.points.shape[0] != mesh.size:
        raise ValueError(f"problem packed for {prob.points.shape[0]} shards, "
                         f"mesh has {mesh.size}")
    sl = mesh.local_shards()
    prob = _with_depth_defaults(prob)
    return _Local(*(getattr(prob, f)[sl] for f in _Local._fields))


def _shard_terms(cam_kind, cam_params, poses_R, poses_t, points, loc: _Local, robust, delta2):
    """Per-edge terms of the local shards (n, El): 3-row residuals
    (reprojection and the depth row), pose and point Jacobians, IRLS weights."""
    shard = torch.arange(points.shape[0], device=points.device)[:, None]
    r, Jc, Jp, depth = factors.reproj_depth_residual(
        cam_kind, cam_params, poses_R[loc.kf_idx], poses_t[loc.kf_idx],
        points[shard, loc.pt_idx], loc.uv, loc.z_meas, loc.wz)
    chi2 = torch.sum(r * r, -1) * loc.inv_sigma2
    w = loc.inv_sigma2 * loc.valid * (depth > 0)
    if robust:
        w = w * factors.huber_weight(chi2, delta2)
    return r, Jc, Jp, w


def _robust_cost(chi2, delta2, robust):
    if not robust:
        return chi2
    return torch.where(chi2 <= delta2, chi2,
                       2.0 * torch.sqrt(delta2 * torch.clamp(chi2, min=0.0)) - delta2)


def _edge_costs(cam_kind, cam_params, poses_R, poses_t, points, loc, delta2, robust):
    """(n, El) per-edge (robust) costs; 0 on invalid edges and behind-camera
    points."""
    r, _, _, w0 = _shard_terms(cam_kind, cam_params, poses_R, poses_t, points, loc, False,
                               delta2)
    chi2 = torch.sum(r * r, -1) * loc.inv_sigma2
    return _robust_cost(chi2, delta2, robust) * (w0 > 0)


def dist_lm_step(cam_kind, cam_params, prob: ShardedBA, mesh: Mesh, lam=1e-4,
                 robust: bool = True, chi2_th: float = factors.CHI2_MONO,
                 max_step: float = 0.25):
    """One distributed Levenberg-Marquardt iteration with its accept/reject
    on the device. Returns (poses_R, poses_t, points, lam', cost, accepted),
    the last three 0-d tensors; `points` holds this process's shards
    updated and the others as they came."""
    K = prob.poses_R.shape[0]
    loc = _local(prob, mesh)
    pts = loc.points
    n, Ml = pts.shape[:2]
    dt, dev = pts.dtype, pts.device
    lam = torch.as_tensor(lam, dtype=dt, device=dev)
    delta2 = torch.where(loc.wz > 0, factors.CHI2_STEREO, chi2_th).to(dt)
    r, Jc, Jp, w = _shard_terms(cam_kind, cam_params, prob.poses_R, prob.poses_t, pts, loc,
                                robust, delta2)

    # per-shard normal-equation blocks: segment sums with shard offsets
    shard = torch.arange(n, device=dev)[:, None]
    kf_s = (shard * K + loc.kf_idx).reshape(-1)
    pt_s = (shard * Ml + loc.pt_idx).reshape(-1)

    def seg(x, ids, m):
        return _segment_sum(x.reshape((-1,) + x.shape[2:]), ids, n * m)

    JcW = (Jc * w[..., None, None]).transpose(-1, -2)
    JpW = (Jp * w[..., None, None]).transpose(-1, -2)
    Hcc_part = seg(JcW @ Jc, kf_s, K).reshape(n, K, 6, 6)
    bc_part = seg((JcW @ r[..., None])[..., 0], kf_s, K).reshape(n, K, 6)
    Hpp = seg(JpW @ Jp, pt_s, Ml).reshape(n, Ml, 3, 3)
    bp = seg((JpW @ r[..., None])[..., 0], pt_s, Ml).reshape(n, Ml, 3)
    Wcp = seg(JcW @ Jp, pt_s * K + loc.kf_idx.reshape(-1), Ml * K).reshape(n, Ml, K, 6, 3)

    eye3 = torch.eye(3, dtype=dt, device=dev)
    Hpp_inv = inv3_sym(Hpp + (lam * torch.diagonal(Hpp, dim1=-2, dim2=-1) + 1e-8)[..., None]
                       * eye3)
    WHinv = torch.einsum("dmkac,dmce->dmkae", Wcp, Hpp_inv)
    S_part = -torch.einsum("dmkae,dmlfe->dkalf", WHinv, Wcp)
    rhs_part = -bc_part + torch.einsum("dmkae,dme->dka", WHinv, bp)

    # ---- the one collective: the camera system summed over the mesh ----
    Hcc = mesh.psum(Hcc_part)
    S = mesh.psum(S_part)
    rhs = mesh.psum(rhs_part)

    kk = torch.arange(K, device=dev)
    eye6 = torch.eye(6, dtype=dt, device=dev)
    S[kk, :, kk, :] += Hcc + (lam * torch.diagonal(Hcc, dim1=-2, dim2=-1) + 1e-8)[..., None] \
        * eye6
    free = (~prob.fixed).to(dt)
    S = S * free[:, None, None, None] * free[None, None, :, None]
    S[kk, :, kk, :] += eye6 * prob.fixed[:, None, None]
    rhs = rhs * free[:, None]
    # Jacobi-scaled solve: the reduced system's conditioning grows with K
    S2 = S.reshape(K * 6, K * 6)
    dsc = torch.sqrt(torch.clamp(torch.abs(torch.diagonal(S2)), min=1e-12))
    y = solve(S2 / dsc[:, None] / dsc[None, :], rhs.reshape(K * 6) / dsc)
    dc = (y / dsc).reshape(K, 6) * free[:, None]
    cstep = torch.sqrt(torch.sum(dc * dc, -1))
    dc = dc * torch.clamp(max_step / torch.clamp(torch.max(cstep), min=1e-12), max=1.0)

    # back-substitution of the local landmark shards, with a per-point cap
    Hpc_dc = torch.einsum("dmkac,ka->dmc", Wcp, dc)
    dp = (Hpp_inv @ (-bp - Hpc_dc)[..., None])[..., 0]
    pstep = torch.sqrt(torch.sum(dp * dp, -1))
    dp = dp * torch.clamp(max_step / torch.clamp(pstep, min=1e-12), max=1.0)[..., None]

    R_new, t_new = lie.se3_retract(prob.poses_R, prob.poses_t, dc)
    R_new = lie.orthonormalize(R_new)
    pts_new = pts + dp

    # ---- accept / reject on the psum of per-edge cost differences ----
    c_old = _edge_costs(cam_kind, cam_params, prob.poses_R, prob.poses_t, pts, loc, delta2,
                        robust)
    c_new = _edge_costs(cam_kind, cam_params, R_new, t_new, pts_new, loc, delta2, robust)
    dcost = mesh.psum(torch.sum(c_new - c_old, -1))
    # ok must be the same in every process: dc and dcost are, and the
    # shards' finiteness is summed over the mesh
    bad = ~(torch.isfinite(dp).flatten(1).all(1) & torch.isfinite(pts_new).flatten(1).all(1))
    ok = (dcost < 0) & torch.all(torch.isfinite(dc)) & (mesh.psum(bad.to(torch.int32)) == 0)
    points = prob.points.clone()
    points[mesh.local_shards()] = torch.where(ok, pts_new, pts)
    lam_new = torch.where(ok, torch.clamp(lam * 0.33, min=1e-4), torch.clamp(lam * 4.0, max=1e4))
    cost = mesh.psum(torch.sum(torch.where(ok, c_new, c_old), -1))
    return (torch.where(ok, R_new, prob.poses_R), torch.where(ok, t_new, prob.poses_t), points,
            lam_new, cost, ok)


def dist_cost(cam_kind, cam_params, prob: ShardedBA, mesh: Mesh, robust: bool = True) -> float:
    """Total IRLS-weighted chi2 over the mesh (one psum), Huber-weighted by
    default so gross outliers do not mask the inliers' convergence."""
    loc = _local(prob, mesh)
    delta2 = torch.where(loc.wz > 0, factors.CHI2_STEREO, factors.CHI2_MONO)
    r, _, _, w = _shard_terms(cam_kind, cam_params, prob.poses_R, prob.poses_t, loc.points,
                              loc, robust, delta2)
    return float(mesh.psum(torch.sum(r * r * w[..., None], (-1, -2))))


def _dist_classify(cam_kind, cam_params, prob: ShardedBA, mesh: Mesh, chi2_th: float):
    """Per-edge chi2 gate (D, El) over the mesh, in every process."""
    loc = _local(prob, mesh)
    delta2 = torch.where(loc.wz > 0, factors.CHI2_STEREO, chi2_th)
    r, _, _, _ = _shard_terms(cam_kind, cam_params, prob.poses_R, prob.poses_t, loc.points,
                              loc, False, delta2)
    chi2 = torch.sum(r * r, -1) * loc.inv_sigma2
    return mesh.all_gather(loc.valid & (chi2 < delta2))


def dist_bundle_adjust(cam_kind, cam_params, prob: ShardedBA, mesh: Mesh,
                       rounds=((5, True), (10, True)), lam: float = 1e-4,
                       chi2_th: float = factors.CHI2_MONO, should_abort=None):
    """Distributed BA: the single solver's schedule (robust stages, then a
    cleanup stage) around dist_lm_step, with the edges re-classified against
    their base validity between stages (outlier recycling) and a final
    per-edge classification. This is the route of the mapper's big global
    solves (LocalMapper.run_global_ba).

    should_abort: zero-arg callable polled between LM iterations (the
    detached global BA's stop flag, mbStopGBA).

    Returns (prob', edge_valid (D,El) numpy bool, costs list); prob' holds
    every shard's landmarks in every process."""
    base_valid = prob.valid
    costs = [dist_cost(cam_kind, cam_params, prob, mesh)]
    lam = torch.as_tensor(lam, dtype=prob.points.dtype, device=prob.points.device)
    for iters, robust in rounds:
        for _ in range(iters):
            if should_abort is not None and should_abort():
                break
            R, t, pts, lam, c, _ = dist_lm_step(cam_kind, cam_params, prob, mesh, lam=lam,
                                                robust=robust, chi2_th=chi2_th)
            prob = prob._replace(poses_R=R, poses_t=t, points=pts)
            costs.append(float(c))
        prob = prob._replace(valid=base_valid & _dist_classify(
            cam_kind, cam_params, prob._replace(valid=base_valid), mesh, chi2_th))
    edge_valid = _dist_classify(cam_kind, cam_params, prob, mesh, chi2_th) & prob.valid
    prob = prob._replace(points=mesh.all_gather(prob.points[mesh.local_shards()]))
    return prob, edge_valid.cpu().numpy(), costs
