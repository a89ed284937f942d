"""Fused per-frame tracking and the banked mapping kernels, on torch.

Counterpart of hfnet_slam_tpu/slam/fused.py:
  * `DeviceMap` keeps the matching-relevant map-point tables resident on the
    device, updated from the MapStore's dirty-row marks;
  * `DeviceKFBank` does the same for the keyframe feature and observation
    tables, so the mapping kernels gather neighbor rows by id on the device;
  * `track_step` runs motion-model projection search -> pose LM ->
    local-map projection search -> pose LM for one frame with no host
    round trip inside; the host passes two -1-padded id vectors and reads
    one small dict back;
  * `triangulate_banked` and `fuse_neighbors_banked` are LocalMapping's
    per-keyframe blocks over a neighbor batch; `fuse_targets_banked` is loop
    closing's fuse of the loop landmarks into the corrected window.
The reference vmaps per-pair functions over neighbor batches; here every
building block takes the batch dimension explicitly.

Mirror updates are functional (`index_copy`, never in place), like the
reference's non-donated scatters: a handle tuple taken by snapshot() stays
internally consistent while a later sync() builds new tensors. The async
pipeline depends on it: a worker syncs and snapshots under the map lock and
runs its kernel on the snapshot without it, while the tracker syncs again.
So no write here is in place, no upload is non_blocking, and no pinned
staging buffer is filled from the store's arrays (it would be rewritten
while a copy from it is in flight). The
out-of-range pad rows the reference scatters with mode="drop" do not exist
here: eager scatters take exactly the dirty ids.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import lie
from ..geometry import cameras
from ..optim import factors
from ..optim.pose_opt import pose_optimize_core

_NEG = -1e9


class FusedConfig(NamedTuple):
    motion_window: float = 15.0
    motion_window_retry: float = 30.0
    local_window: float = 4.0
    th_high: float = 0.75
    min_motion_matches: int = 20


# ---------------------------------------------------------------------------
# device-resident map mirror
# ---------------------------------------------------------------------------

class DeviceMap:
    """Device mirror of the MapStore's matching-relevant point tables."""

    def __init__(self, store, device):
        self.store = store
        self.device = torch.device(device)
        self._upload_all()

    def _put(self, x):
        return torch.from_numpy(np.array(x, copy=True)).to(self.device)

    def _upload_all(self):
        s = self.store
        self.pos = self._put(s.mp_pos)
        self.desc = self._put(s.mp_desc)
        self.normal = self._put(s.mp_normal)
        self.dmin = self._put(s.mp_dmin)
        self.dmax = self._put(s.mp_dmax)
        self.valid = self._put(s.mp_valid)

    def sync(self):
        """Bring the mirror up to date (under the map lock)."""
        d = self.store.consume_dirty_points()
        if d is None:
            return
        if isinstance(d, str):  # 'all'
            self._upload_all()
            return
        s = self.store
        ids = torch.from_numpy(d.astype(np.int64)).to(self.device)
        self.pos = self.pos.index_copy(0, ids, self._put(s.mp_pos[d]))
        self.desc = self.desc.index_copy(0, ids, self._put(s.mp_desc[d]))
        self.normal = self.normal.index_copy(0, ids, self._put(s.mp_normal[d]))
        self.dmin = self.dmin.index_copy(0, ids, self._put(s.mp_dmin[d]))
        self.dmax = self.dmax.index_copy(0, ids, self._put(s.mp_dmax[d]))
        self.valid = self.valid.index_copy(0, ids, self._put(s.mp_valid[d]))

    def snapshot(self):
        """Consistent (pos, desc, normal, dmin, dmax, valid) handle tuple."""
        return (self.pos, self.desc, self.normal, self.dmin, self.dmax, self.valid)


def get_device_map(store, device) -> DeviceMap:
    """Cached DeviceMap attached to a MapStore (created on first use)."""
    dm = getattr(store, "_device_map", None)
    if dm is None:
        dm = DeviceMap(store, device)
        store._device_map = dm
    return dm


# ---------------------------------------------------------------------------
# building blocks (explicit batch dimension B)
# ---------------------------------------------------------------------------

def _gather_candidates(ids, m_valid):
    """-1-padded id tensor -> (safe row indices, validity)."""
    safe = torch.clamp(ids, 0, m_valid.shape[0] - 1)
    return safe, (ids >= 0) & m_valid[safe]


def _mutual_argmax(S, feat_mask, sim_gate):
    """Row argmax of gated similarities S (B,N,C) with the cross-check
    (BFMatcher crossCheck semantics); first maximal index on ties."""
    idxB = torch.argmax(S, -1)
    best = torch.gather(S, -1, idxB[..., None])[..., 0]
    hit = (best > sim_gate) & (best > _NEG / 2)
    idxA_of_B = torch.argmax(S, -2)                                   # (B,C)
    rows = torch.arange(S.shape[1], device=S.device)
    hit &= torch.gather(idxA_of_B, 1, idxB) == rows
    return torch.where(hit & feat_mask, idxB, -1).to(torch.int32)


def _match_projected(cam_kind, cam_params, W, H, R, t, pos, dsc, ok, xy, desc,
                     radii, feat_mask, th_max, normal=None, dmin=None, dmax=None):
    """Guided projection matching (SearchByProjection semantics) for a batch
    of B pose/candidate-set pairs: R (B,3,3), t (B,3), pos (B,C,3),
    dsc (B,C,D), ok (B,C); keypoints xy (B,N,2), desc (B,N,D), radii (B,N),
    feat_mask (B,N). Returns (idx (B,N) int32 into the candidates or -1,
    candidate frustum mask (B,C))."""
    pc = pos @ R.transpose(-1, -2) + t[:, None, :]
    uv = cameras.project(cam_kind, cam_params, pc)
    in_img = (uv[..., 0] >= 0) & (uv[..., 0] < W) & (uv[..., 1] >= 0) & (uv[..., 1] < H)
    mp_ok = ok & (pc[..., 2] > 0.1) & in_img
    # |a-b|^2 = |a|^2 + |b|^2 - 2ab^T: one rank-2 product, no (B,N,C,2) grid
    d2 = (torch.sum(xy * xy, -1)[..., :, None] + torch.sum(uv * uv, -1)[..., None, :]
          - 2.0 * (xy @ uv.transpose(-1, -2)))
    if normal is not None:
        center = -(R.transpose(-1, -2) @ t[..., None])[..., 0]
        ray = pos - center[:, None, :]
        dist = torch.clamp(torch.linalg.norm(ray, dim=-1), min=1e-9)
        view_cos = torch.sum(ray / dist[..., None] * normal, -1)
        has_stats = dmax > 0
        dist_ok = (dist >= 0.8 * dmin) & (dist <= 1.2 * dmax)
        mp_ok = mp_ok & (~has_stats | (dist_ok & (view_cos > 0.5)))
        radii_mp = torch.where(has_stats & (view_cos > 0.998), 2.5 / 4.0, 1.0)
        allowed = d2 <= (radii[..., :, None] * radii_mp[..., None, :]) ** 2
    else:
        allowed = d2 < radii[..., :, None] ** 2
    S = desc @ dsc.transpose(-1, -2)
    gate = feat_mask[..., :, None] & mp_ok[..., None, :] & allowed
    S = torch.where(gate, S, _NEG)
    return _mutual_argmax(S, feat_mask, 1.0 - th_max * th_max / 2.0), mp_ok


def track_step(cam_kind, cam_params, W, H, R0, t0, m_pos, m_desc, m_normal,
               m_dmin, m_dmax, m_valid, motion_ids, local_ids, xy, desc, octave,
               mask, z_meas, wz, cfg: FusedConfig):
    """One tracked frame on the device (Tracking.cc:2165-2388):
      1. motion-model projection search vs the previous frame's points
         (window 15 px, 30 px retry);
      2. pose-only LM over those matches;
      3. local-map projection search with the refined pose (viewing-cos and
         scale-band gates);
      4. final pose-only LM over the merged observations.
    Returns dict(R, t, obs, obs1, vis_local, stats=[n_motion_matches,
    n_inliers_stage2, n_inliers_final]); nothing is read back to the host.
    """
    dev = m_pos.device
    octave_f = octave.to(torch.float32)
    radii_base = 1.2 ** octave_f
    inv_sigma2 = 1.0 / (1.2 ** (2.0 * octave_f))
    M = m_pos.shape[0]

    # ---- stage 1: the reference's lax.cond retry, without a host sync: both
    # windows run as one batch of two and torch.where keeps the retry's
    # matches when the 15 px window found too few
    ms, mok = _gather_candidates(motion_ids, m_valid)
    pos_m, desc_m = m_pos[ms], m_desc[ms]
    radii2 = torch.stack([cfg.motion_window * radii_base,
                          cfg.motion_window_retry * radii_base])
    idx12, _ = _match_projected(
        cam_kind, cam_params, W, H, R0.expand(2, 3, 3), t0.expand(2, 3),
        pos_m.expand(2, -1, -1), desc_m.expand(2, -1, -1), mok.expand(2, -1),
        xy.expand(2, -1, -1), desc.expand(2, -1, -1), radii2, mask.expand(2, -1),
        cfg.th_high)
    retry = torch.sum(idx12[0] >= 0) < cfg.min_motion_matches
    idx1 = torch.where(retry, idx12[1], idx12[0]).long()
    n1 = torch.sum(idx1 >= 0)
    obs1 = torch.where(idx1 >= 0, motion_ids[torch.clamp(idx1, 0, motion_ids.shape[0] - 1)], -1)

    # ---- stage 2: pose optimization over the motion matches
    res1 = pose_optimize_core(cam_kind, cam_params, R0, t0,
                              m_pos[torch.clamp(obs1, 0, M - 1)], xy, inv_sigma2,
                              obs1 >= 0, z_meas=z_meas, wz=wz)
    R1, t1 = res1["R"], res1["t"]
    obs1f = torch.where(res1["inlier"], obs1, -1)

    # ---- stage 3: local-map search, excluding points matched in stage 1
    # (a membership table with one spare row for the -1 entries)
    ls, lok = _gather_candidates(local_ids, m_valid)
    tbl = torch.zeros(M + 1, dtype=torch.bool, device=dev).index_fill_(
        0, torch.where(obs1f >= 0, obs1f, M), True)
    lok = lok & ~tbl[ls]
    idx2, l_vis = _match_projected(
        cam_kind, cam_params, W, H, R1[None], t1[None], m_pos[ls][None],
        m_desc[ls][None], lok[None], xy[None], desc[None],
        (cfg.local_window * radii_base)[None], mask[None], cfg.th_high,
        normal=m_normal[ls][None], dmin=m_dmin[ls][None], dmax=m_dmax[ls][None])
    idx2 = idx2[0].long()
    new = (idx2 >= 0) & (obs1f < 0)
    obs2 = torch.where(new, local_ids[torch.clamp(idx2, 0, local_ids.shape[0] - 1)], obs1f)

    # ---- stage 4: final pose optimization
    res2 = pose_optimize_core(cam_kind, cam_params, R1, t1,
                              m_pos[torch.clamp(obs2, 0, M - 1)], xy, inv_sigma2,
                              obs2 >= 0, z_meas=z_meas, wz=wz)
    obs_final = torch.where(res2["inlier"], obs2, -1).to(torch.int32)
    stats = torch.stack([n1, res1["n_inliers"], res2["n_inliers"]]).to(torch.int32)
    return {"R": res2["R"], "t": res2["t"], "obs": obs_final,
            "obs1": obs1f.to(torch.int32), "vis_local": l_vis[0], "stats": stats}


# ---------------------------------------------------------------------------
# batched mapping kernels (LocalMapping's per-keyframe blocks)
# ---------------------------------------------------------------------------

def _epipolar_match(xn1, desc1, sig2_1, mask1, xn2, desc2, sig2_2, mask2,
                    R21, t21, f_px, max_dist, chi2_epi):
    """Epipolar-gated mutual matching of one anchor keyframe (N rows) against
    B neighbors (SearchForTriangulation): xn2 (B,N,2), desc2 (B,N,D),
    sig2_2 (B,N), mask2 (B,N), R21 (B,3,3), t21 (B,3). Returns (B,N)."""
    E = lie.hat(t21) @ R21
    h1 = torch.cat([xn1, torch.ones_like(xn1[:, :1])], 1)
    h2 = torch.cat([xn2, torch.ones_like(xn2[..., :1])], -1)
    l2 = h1 @ E.transpose(-1, -2)                                     # (B,N,3)
    num = (l2 @ h2.transpose(-1, -2)) ** 2
    den = torch.clamp(l2[..., 0:1] ** 2 + l2[..., 1:2] ** 2, min=1e-12)
    epi_ok = num / den < chi2_epi * (sig2_2[:, None, :] / (f_px * f_px))
    tz = t21[:, 2:3]
    epi = t21[:, :2] / torch.where(torch.abs(tz) < 1e-9, 1e-9, tz)
    d_ep2 = torch.sum((xn2 - epi[:, None, :]) ** 2, -1) * (f_px * f_px)
    allowed = epi_ok & (d_ep2 > 100.0 * sig2_2)[:, None, :]
    S = desc1 @ desc2.transpose(-1, -2)                               # (B,N,N)
    gate = mask1[None, :, None] & mask2[:, None, :] & allowed
    S = torch.where(gate, S, _NEG)
    # the reference gates best > 1 - max_dist^2/2 (masked rows sit at -1e9)
    return _mutual_argmax(S, mask1[None, :], 1.0 - max_dist * max_dist / 2.0)


def _triangulate_core(xn_k, desc_k, sig2_k, free_k, xn_j, desc_j, sig2_j, free_j,
                      R21, t21, f_px, max_dist, chi2_epi, min_parallax_cos):
    from ..geometry import triangulation

    idx = _epipolar_match(xn_k, desc_k, sig2_k, free_k, xn_j, desc_j, sig2_j,
                          free_j, R21, t21, f_px, max_dist, chi2_epi)
    safe = torch.clamp(idx.long(), 0, xn_j.shape[1] - 1)
    xn2_m = torch.gather(xn_j, 1, safe[..., None].expand(-1, -1, 2))
    p1 = triangulation.triangulate_dlt(xn_k, xn2_m, R21, t21)         # (B,N,3)
    th2 = factors.CHI2_MONO * torch.maximum(sig2_k[None, :], torch.gather(sig2_j, 1, safe)) \
        / (f_px * f_px)
    p2 = p1 @ R21.transpose(-1, -2) + t21[:, None, :]
    finite = torch.all(torch.isfinite(p1), -1)
    z_ok = (p1[..., 2] > 0) & (p2[..., 2] > 0)
    O2 = -(R21.transpose(-1, -2) @ t21[..., None])[..., 0]
    ray2 = p1 - O2[:, None, :]
    cosp = torch.sum(p1 * ray2, -1) / torch.clamp(
        torch.linalg.norm(p1, dim=-1) * torch.linalg.norm(ray2, dim=-1), min=1e-12)
    e1 = p1[..., :2] / torch.clamp(p1[..., 2:3], min=1e-12) - xn_k
    e2 = p2[..., :2] / torch.clamp(p2[..., 2:3], min=1e-12) - xn2_m
    r_ok = (torch.sum(e1 * e1, -1) < th2) & (torch.sum(e2 * e2, -1) < th2)
    good = (idx >= 0) & finite & z_ok & r_ok & (cosp < min_parallax_cos)
    return idx, good, p1


def triangulate_pairs_batch(xn_k, desc_k, sig2_k, free_k, xn_j, desc_j, sig2_j, free_j,
                            R21, t21, f_px, max_dist: float = 0.6, chi2_epi: float = 16.0,
                            min_parallax_cos: float = 0.9998):
    """CreateNewMapPoints over a padded neighbor batch, on host-packed
    inputs (the banked path gathers them on the device): anchor keyframe
    xn_k (N,2), desc_k (N,D), sig2_k (N,), free_k (N,); neighbors (B,N,...)
    with padding rows all not free; R21 (B,3,3), t21 (B,3) anchor -> neighbor.
    Returns idx (B,N) into the neighbor slots or -1, good (B,N), and p1
    (B,N,3) in the anchor camera frame."""
    return _triangulate_core(xn_k, desc_k, sig2_k, free_k, xn_j, desc_j, sig2_j, free_j,
                             R21, t21, f_px, max_dist, chi2_epi, min_parallax_cos)


def fuse_pairs_batch(cam_kind, cam_params, W, H, R_t, t_t, xy_t, desc_t, oct_t, free_t,
                     cand_ids, m_pos, m_desc, m_valid, radius: float = 3.0,
                     max_dist: float = 0.6):
    """Matcher::Fuse over (target keyframe, source point set) pairs, on
    host-packed inputs: target poses R_t (P,3,3), t_t (P,3) and keypoints
    (P,N,...), candidate point ids cand_ids (P,C) (-1 padded) gathered from
    m_pos / m_desc / m_valid. Returns idx (P,N) into the candidates or -1."""
    return _fuse_core(cam_kind, cam_params, W, H, R_t, t_t, xy_t, desc_t, oct_t, free_t,
                      cand_ids, m_pos, m_desc, m_valid, radius, max_dist)


# ---------------------------------------------------------------------------
# device-resident keyframe bank
# ---------------------------------------------------------------------------

class DeviceKFBank:
    """Device mirror of the keyframe feature + observation tables, with the
    unprojected (normalized) keypoints computed on the device at upload.
    Feature rows are dirty only on keyframe add / slot reuse; obs rows
    change with every association pass."""

    def __init__(self, store, cam_kind, cam_params, device):
        self.store = store
        self.cam_kind = cam_kind
        self.device = torch.device(device)
        self.cam_params = cam_params.to(self.device)
        self._upload_all()

    def _put(self, x):
        return torch.from_numpy(np.array(x, copy=True)).to(self.device)

    def _xn(self, xy):
        return cameras.unproject(self.cam_kind, self.cam_params, xy)[..., :2]

    def _upload_all(self):
        s = self.store
        self.xy = self._put(s.kf_xy)
        self.desc = self._put(s.kf_desc)
        self.octave = self._put(s.kf_octave)
        self.mask = self._put(s.kf_mask)
        self.obs = self._put(s.kf_obs)
        self.xn = self._xn(self.xy)

    def sync(self):
        """Bring the bank up to date (under the map lock)."""
        s = self.store
        feat, obs = s.consume_dirty_kfs()
        if isinstance(feat, str):  # 'all'
            self._upload_all()
            return
        if feat is not None:
            ids = torch.from_numpy(feat.astype(np.int64)).to(self.device)
            r_xy = self._put(s.kf_xy[feat])
            self.xy = self.xy.index_copy(0, ids, r_xy)
            self.desc = self.desc.index_copy(0, ids, self._put(s.kf_desc[feat]))
            self.octave = self.octave.index_copy(0, ids, self._put(s.kf_octave[feat]))
            self.mask = self.mask.index_copy(0, ids, self._put(s.kf_mask[feat]))
            self.xn = self.xn.index_copy(0, ids, self._xn(r_xy))
        if obs is not None:
            ids = torch.from_numpy(obs.astype(np.int64)).to(self.device)
            self.obs = self.obs.index_copy(0, ids, self._put(s.kf_obs[obs]))

    def snapshot(self):
        """(xy, desc, octave, mask, xn, obs) handle tuple."""
        return (self.xy, self.desc, self.octave, self.mask, self.xn, self.obs)


def get_kf_bank(store, cam, device) -> DeviceKFBank:
    """Cached DeviceKFBank attached to a MapStore (created on first use)."""
    bank = getattr(store, "_kf_bank", None)
    if bank is None:
        bank = DeviceKFBank(store, cam.kind, cam.params, device)
        store._kf_bank = bank
    return bank


def triangulate_banked(anchor, nbr_ids, R21, t21, b_desc, b_oct, b_mask, b_xn,
                       b_obs, f_px, max_dist: float = 0.6, chi2_epi: float = 16.0,
                       min_parallax_cos: float = 0.9998):
    """CreateNewMapPoints over a padded neighbor batch against the device
    keyframe bank: epipolar-gated matching, DLT + GN triangulation and
    cheirality/reprojection/parallax gates. nbr_ids (B,) -1 padded; R21/t21
    (B,3,3)/(B,3) anchor -> neighbor. Returns idx (B,N), good (B,N),
    p1 (B,N,3) in the anchor camera frame."""
    K = b_desc.shape[0]
    oct_k = b_oct[anchor].to(torch.float32)
    free_k = b_mask[anchor] & (b_obs[anchor] < 0)
    safe = torch.clamp(nbr_ids, 0, K - 1)
    free_j = b_mask[safe] & (b_obs[safe] < 0) & (nbr_ids >= 0)[:, None]
    sig2_j = 1.2 ** (2.0 * b_oct[safe].to(torch.float32))
    return _triangulate_core(b_xn[anchor], b_desc[anchor], 1.2 ** (2.0 * oct_k), free_k,
                             b_xn[safe], b_desc[safe], sig2_j, free_j, R21, t21,
                             f_px, max_dist, chi2_epi, min_parallax_cos)


def fuse_neighbors_banked(cam_kind, cam_params, W, H, tgt_ids, src_ids, R_t, t_t,
                          b_xy, b_desc, b_oct, b_mask, b_obs, m_pos, m_desc, m_valid,
                          radius: float = 3.0, max_dist: float = 0.6):
    """SearchInNeighbors' two-way Fuse for P (target, source) keyframe pairs,
    both gathered from the device bank: the source's points are projected
    into the target and matched against its unclaimed slots. tgt_ids/src_ids
    (P,) -1 padded. Returns idx (P,N) into the source slot axis."""
    K = b_desc.shape[0]
    ts = torch.clamp(tgt_ids, 0, K - 1)
    ss = torch.clamp(src_ids, 0, K - 1)
    free_t = b_mask[ts] & (b_obs[ts] < 0) & (tgt_ids >= 0)[:, None]
    cand = torch.where((src_ids >= 0)[:, None], b_obs[ss], -1)
    return _fuse_core(cam_kind, cam_params, W, H, R_t, t_t, b_xy[ts], b_desc[ts], b_oct[ts],
                      free_t, cand, m_pos, m_desc, m_valid, radius, max_dist)


def fuse_targets_banked(cam_kind, cam_params, W, H, tgt_ids, cand_ids, R_t, t_t,
                        b_xy, b_desc, b_oct, b_mask, m_pos, m_desc, m_valid,
                        radius: float = 3.0, max_dist: float = 0.75):
    """Loop-correction fuse (SearchAndFuse): target keypoint rows gathered
    from the bank, the candidate points (the loop landmarks) passed as
    explicit (P,C) ids, -1 padded. Every masked slot is fusable: a
    conflicting observation is replaced by the loop point
    (LoopClosing.cc:1260-1273). Returns idx (P,N) into the candidate axis."""
    K = b_desc.shape[0]
    ts = torch.clamp(tgt_ids, 0, K - 1)
    free_t = b_mask[ts] & (tgt_ids >= 0)[:, None]
    return _fuse_core(cam_kind, cam_params, W, H, R_t, t_t, b_xy[ts], b_desc[ts], b_oct[ts],
                      free_t, cand_ids, m_pos, m_desc, m_valid, radius, max_dist)


def _fuse_core(cam_kind, cam_params, W, H, R_t, t_t, xy_t, desc_t, oct_t, free_t,
               cand_ids, m_pos, m_desc, m_valid, radius, max_dist):
    """Project each pair's candidate points (ids gathered from the device
    map) into its target keyframe and match them to the free slots."""
    safe, ok = _gather_candidates(cand_ids.long(), m_valid)
    radii = radius * (1.2 ** oct_t.to(torch.float32))
    idx, _ = _match_projected(cam_kind, cam_params, W, H, R_t, t_t, m_pos[safe],
                              m_desc[safe], ok, xy_t, desc_t, radii, free_t, max_dist)
    return idx
