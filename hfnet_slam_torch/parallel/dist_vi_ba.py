"""Distributed joint visual-inertial bundle adjustment over a mesh.

Counterpart of hfnet_slam_tpu/parallel/dist_vi_ba.py. The reference's
FullInertialBA optimizes every keyframe in one problem whatever the map's
size; the single joint solve (optim/vi_ba.py) is sized to the map up to
`fiba_max_joint` keyframes, and past it the mapper routes the same joint
problem here:
  * landmarks and their visual edges are split into the mesh's shards as in
    the visual distributed BA (dist_ba.partition_edges, reused for the
    bucketing);
  * the 15-d keyframe chain (poses, velocities, biases) and the O(K)
    inertial links are replicated: every process computes the same
    inertial blocks;
  * per LM iteration the visual contributions to the reduced camera system
    (Hbb, the Schur block S_vis, rhs) are summed over the mesh, the
    (K,15,K,15) system is assembled and solved replicated exactly as
    optim/vi_ba.vi_ba_iterate does (its Jacobians and its `_state_step`),
    and each process back-substitutes its own landmark shards;
  * accept / reject on the psum of the per-edge visual cost differences
    plus the replicated inertial difference in the (r_new - r_old)(r_new +
    r_old) form.
`dist_vi_bundle_adjust` takes and returns the VIBAProblem the mapper builds
(local_mapping._build_inertial_problem).
"""
from __future__ import annotations

import numpy as np
import torch

from ..optim import factors, vi_ba
from ..optim.ba import _segment_sum, inv3_sym
from .dist_ba import partition_edges
from .multihost import Mesh


def _shard_caps(n_dev, n_mp, n_edges):
    """Per-shard landmark and edge caps (powers of two, exact coverage)."""
    ml = int(np.ceil(max(n_mp, 1) / n_dev))
    el = int(np.ceil(max(n_edges, 1) / n_dev))
    Ml = 1 << max(4, (ml - 1).bit_length())
    El = 1 << max(5, (el - 1).bit_length())
    return Ml, El


def shard_vi_problem(prob: vi_ba.VIBAProblem, n_dev: int):
    """Pack the visual part of a VIBAProblem into per-shard buckets
    (landmarks round-robin, each edge with its landmark) on the problem's
    device. Returns (vis: ShardedBA, maps); the ShardedBA's pose fields are
    placeholders this solver ignores."""
    M = prob.points.shape[0]
    E = prob.uv.shape[0]
    Ml, El = _shard_caps(n_dev, M, E)
    K = prob.R_wb.shape[0]

    def h(x):
        return x.detach().cpu().numpy()

    return partition_edges(
        n_dev, K, Ml, El, np.tile(np.eye(3, dtype=np.float32), (K, 1, 1)),
        np.zeros((K, 3), np.float32), h(prob.fixed), h(prob.points), h(prob.kf_idx),
        h(prob.pt_idx), h(prob.uv), h(prob.inv_sigma2), h(prob.valid),
        z_meas=h(prob.z_meas), wz=h(prob.wz), device=prob.points.device)


def _local_view(prob: vi_ba.VIBAProblem, vis, valid, sl):
    """The local shards' edges as one flat edge set of `prob` (landmark ids
    offset by shard), for optim/vi_ba's batched Jacobians."""
    kf, pt = vis.kf_idx[sl], vis.pt_idx[sl]
    n, Ml = kf.shape[0], vis.points.shape[1]
    shard = torch.arange(n, device=kf.device)[:, None]
    return prob._replace(
        kf_idx=kf.reshape(-1), pt_idx=(shard * Ml + pt).reshape(-1),
        uv=vis.uv[sl].reshape(-1, 2), inv_sigma2=vis.inv_sigma2[sl].reshape(-1),
        valid=valid[sl].reshape(-1), z_meas=vis.z_meas[sl].reshape(-1),
        wz=vis.wz[sl].reshape(-1))


def _dist_vi_lm_step(cam_kind, cam_params, prob: vi_ba.VIBAProblem, pts_sh, vis, valid,
                     L9, Lg, La, mesh: Mesh, lam, robust: bool, chi2_mono: float):
    """One distributed LM iteration on the joint VI problem: `pts_sh`
    (D,Ml,3) the landmark shards, `vis` the packed edges, `valid` (D,El)
    their current validity. Returns (R, p, v, bg, ba, pts_sh', lam', cost,
    ok), with this process's shards of pts_sh' updated."""
    K = prob.R_wb.shape[0]
    dt, dev = prob.p_wb.dtype, prob.p_wb.device
    sl = mesh.local_shards()
    pts = pts_sh[sl]
    n, Ml = pts.shape[:2]
    lam = torch.as_tensor(lam, dtype=dt, device=dev)
    max_step = 0.5
    view = _local_view(prob, vis, valid, sl)
    pts_f = pts.reshape(-1, 3)
    delta2 = torch.where(view.wz > 0, factors.CHI2_STEREO, chi2_mono).to(dt)
    R, p, v, bg, ba = prob.R_wb, prob.p_wb, prob.v, prob.bg, prob.ba

    # ---- visual terms of the local edges ----
    r, depth, Jb, Jp = vi_ba._vis(cam_kind, cam_params, view, R, p, pts_f, True)
    chi2 = torch.sum(r * r, -1) * view.inv_sigma2
    w = view.inv_sigma2 * view.valid * (depth > 0)
    if robust:
        w = w * factors.huber_weight(chi2, delta2)
    JbW = (Jb * w[:, None, None]).transpose(1, 2)
    JpW = (Jp * w[:, None, None]).transpose(1, 2)
    shard_of = view.pt_idx // Ml
    kf_s = shard_of * K + view.kf_idx
    Hbb_p = _segment_sum(JbW @ Jb, kf_s, n * K).reshape(n, K, 6, 6)
    bb_p = _segment_sum((JbW @ r[..., None])[..., 0], kf_s, n * K).reshape(n, K, 6)
    Hpp = _segment_sum(JpW @ Jp, view.pt_idx, n * Ml)
    bp = _segment_sum((JpW @ r[..., None])[..., 0], view.pt_idx, n * Ml)
    Wcp = _segment_sum(JbW @ Jp, view.pt_idx * K + view.kf_idx, n * Ml * K).reshape(
        n, Ml, K, 6, 3)
    Hpp_inv = inv3_sym(Hpp + (lam * torch.diagonal(Hpp, dim1=-2, dim2=-1) + 1e-8)[..., None]
                       * torch.eye(3, dtype=dt, device=dev)).reshape(n, Ml, 3, 3)
    bp = bp.reshape(n, Ml, 3)
    WHinv = torch.einsum("dmkac,dmce->dmkae", Wcp, Hpp_inv)
    S_vis_p = -torch.einsum("dmkae,dmlfe->dkalf", WHinv, Wcp)
    rhs_vis_p = -bb_p + torch.einsum("dmkae,dme->dka", WHinv, bp)

    # ---- the one collective: the visual camera system over the mesh ----
    Hbb = mesh.psum(Hbb_p)
    S_vis = mesh.psum(S_vis_p)
    rhs_vis = mesh.psum(rhs_vis_p)

    # ---- inertial terms (replicated) and the replicated state solve ----
    rl, Jl = vi_ba._links(prob, L9, Lg, La, R, p, v, bg, ba, True)
    dx = vi_ba._state_step(prob, S_vis, Hbb, rhs_vis, rl, Jl, lam, vi_ba._state_free(prob),
                           max_step)

    # ---- back-substitution of the local landmark shards ----
    Hpc_dc = torch.einsum("dmkac,ka->dmc", Wcp, dx[:, :6])
    dp = (Hpp_inv @ (-bp - Hpc_dc)[..., None])[..., 0]
    pstep = torch.sqrt(torch.sum(dp * dp, -1))
    dp = dp * torch.clamp(max_step / torch.clamp(pstep, min=1e-12), max=1.0)[..., None]
    R_n, p_n, v_n, bg_n, ba_n = vi_ba._retract(R, p, v, bg, ba, dx)
    pts_n = pts + dp

    # ---- accept / reject: the psum of per-edge visual differences plus
    # the replicated inertial difference in the precision-keeping form ----
    def vis_costs(Rw, pw, points):
        c = vi_ba._vis_costs(cam_kind, cam_params, view, Rw, pw, points.reshape(-1, 3),
                             delta2, robust)
        return c.reshape(n, -1).sum(-1)

    cv_old, cv_new = vis_costs(R, p, pts), vis_costs(R_n, p_n, pts_n)
    rn, _ = vi_ba._links(prob, L9, Lg, La, R_n, p_n, v_n, bg_n, ba_n, False)
    lvalid = prob.lvalid.to(dt)
    dcost = mesh.psum(cv_new - cv_old) + torch.sum(torch.sum((rn - rl) * (rn + rl), -1) * lvalid)
    bad = ~torch.isfinite(dp).flatten(1).all(1)
    ok = (dcost < 0) & torch.all(torch.isfinite(dx)) & (mesh.psum(bad.to(torch.int32)) == 0)
    cost = mesh.psum(torch.where(ok, cv_new, cv_old)) + \
        torch.sum(torch.sum(torch.where(ok, rn, rl) ** 2, -1) * lvalid)
    lam_new = torch.where(ok, torch.clamp(lam * 0.33, min=1e-5), torch.clamp(lam * 4.0, max=1e4))
    pts_out = pts_sh.clone()
    pts_out[sl] = torch.where(ok, pts_n, pts)
    pick = [torch.where(ok, a, b) for a, b in ((R_n, R), (p_n, p), (v_n, v), (bg_n, bg),
                                               (ba_n, ba))]
    return (*pick, pts_out, lam_new, cost, ok)


def _dist_vi_classify(cam_kind, cam_params, prob: vi_ba.VIBAProblem, pts_sh, vis, valid,
                      mesh: Mesh, chi2_mono: float):
    """Per-edge visual chi2 gate (D, El) over the mesh (outlier recycling)."""
    sl = mesh.local_shards()
    view = _local_view(prob, vis, valid, sl)
    r, depth, _, _ = vi_ba._vis(cam_kind, cam_params, view, prob.R_wb, prob.p_wb,
                                pts_sh[sl].reshape(-1, 3), False)
    chi2 = torch.sum(r * r, -1) * view.inv_sigma2
    th = torch.where(view.wz > 0, factors.CHI2_STEREO, chi2_mono)
    ok = view.valid & (chi2 <= th) & (depth > 0)
    return mesh.all_gather(ok.reshape(valid[sl].shape))


def dist_vi_bundle_adjust(cam_kind, cam_params, prob: vi_ba.VIBAProblem, mesh: Mesh,
                          rounds=((5, True), (10, True)), chi2_mono: float = factors.CHI2_MONO,
                          should_abort=None) -> vi_ba.VIBAProblem:
    """Distributed counterpart of optim/vi_ba.vi_bundle_adjust: the same
    problem in and out, the same LM schedule with visual-outlier recycling
    between rounds, landmarks split over `mesh`. The returned problem has
    the landmarks back in the dense layout and the final edge
    classification in `valid`. should_abort: polled between iterations."""
    n_dev = mesh.size
    vis, (owner, local, okm) = shard_vi_problem(prob, n_dev)
    L9, Lg, La = vi_ba._link_whiteners(prob)
    pts_sh = vis.points
    base_valid = vis.valid
    val_sh = vis.valid
    lam = torch.tensor(1e-3, dtype=prob.p_wb.dtype, device=prob.p_wb.device)
    for n_iters, robust in rounds:
        for _ in range(n_iters):
            if should_abort is not None and should_abort():
                break
            R, p, v, bg, ba, pts_sh, lam, _c, _ok = _dist_vi_lm_step(
                cam_kind, cam_params, prob, pts_sh, vis, val_sh, L9, Lg, La, mesh, lam,
                robust, chi2_mono)
            prob = prob._replace(R_wb=R, p_wb=p, v=v, bg=bg, ba=ba)
        new_valid = _dist_vi_classify(cam_kind, cam_params, prob, pts_sh, vis, base_valid, mesh,
                                      chi2_mono)
        val_sh = base_valid & new_valid

    # landmarks back into the dense (M,3) layout
    pts_np = mesh.all_gather(pts_sh[mesh.local_shards()]).cpu().numpy()
    points = prob.points.cpu().numpy().copy()
    points[okm] = pts_np[owner[okm], local[okm]]
    # edge validity back to the dense (E,) layout, through the packing order
    valid_out = prob.valid.cpu().numpy().copy()
    vis_valid = val_sh.cpu().numpy()
    pt_idx = prob.pt_idx.cpu().numpy()
    e_sel = np.nonzero(valid_out & okm[pt_idx])[0]
    if len(e_sel):
        d_e = owner[pt_idx[e_sel]]
        order = np.argsort(d_e, kind="stable")
        e_sel, d_e = e_sel[order], d_e[order]
        starts = np.searchsorted(d_e, np.arange(n_dev))
        pos = np.arange(len(e_sel)) - starts[d_e]
        keep = pos < vis_valid.shape[1]
        valid_out[e_sel[keep]] = vis_valid[d_e[keep], pos[keep]]
    dev = prob.points.device
    return prob._replace(points=torch.as_tensor(points, device=dev),
                         valid=torch.as_tensor(valid_out, device=dev))
