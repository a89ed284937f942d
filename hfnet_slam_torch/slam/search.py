"""SLAM-level data-association searches on torch tensors.

Counterpart of hfnet_slam_tpu/slam/search.py: geometric gating (projection
windows, epipolar constraint) combined with the descriptor matcher, the
equivalents of the reference Matcher's SearchByProjection, SearchByBoW
(mutual brute force), SearchForInitialization and SearchForTriangulation.
All functions take fixed-capacity padded tensors plus masks.
"""
from __future__ import annotations

import torch

from ..geometry import cameras
from ..ops import bf_match
from ..ops import matching as M


def search_by_projection(cam_kind, cam_params, img_wh, R, t, mp_pos, mp_desc,
                         mp_valid, feat_xy, feat_desc, feat_octave, feat_mask,
                         radius: float, max_dist: float = M.TH_HIGH,
                         ratio: float = 1.0, mp_normal=None, mp_dmin=None,
                         mp_dmax=None):
    """Match frame features against projected map points. The window scales
    with the keypoint's octave (radius * 1.2^octave); with viewing stats the
    frustum gates apply (distance band, view cos > 0.5, tight 2.5/4 window
    for head-on views). Returns (idx (N_feat,) int32 or -1, proj_uv, mp_ok)."""
    pc = mp_pos @ R.T + t
    uv = cameras.project(cam_kind, cam_params, pc)
    W, H = img_wh
    in_img = (uv[:, 0] >= 0) & (uv[:, 0] < W) & (uv[:, 1] >= 0) & (uv[:, 1] < H)
    mp_ok = mp_valid & (pc[:, 2] > 0.1) & in_img
    radii = radius * (1.2 ** feat_octave.to(torch.float32))
    if mp_normal is not None:
        center = -R.T @ t
        ray = mp_pos - center[None, :]
        dist = torch.clamp(torch.linalg.norm(ray, dim=1), min=1e-9)
        view_cos = torch.sum(ray / dist[:, None] * mp_normal, 1)
        has_stats = mp_dmax > 0
        dist_ok = (dist >= 0.8 * mp_dmin) & (dist <= 1.2 * mp_dmax)
        mp_ok = mp_ok & (~has_stats | (dist_ok & (view_cos > 0.5)))
        radii_mp = torch.where(has_stats & (view_cos > 0.998), 2.5 / 4.0, 1.0)
        d2 = torch.sum((feat_xy[:, None, :] - uv[None, :, :]) ** 2, -1)
        allowed = d2 <= (radii[:, None] * radii_mp[None, :]) ** 2
    else:
        allowed = M.radius_allowed(feat_xy, uv, radii)
    idx, _ = M.match_descriptors(feat_desc, feat_mask, mp_desc, mp_ok,
                                 max_dist=max_dist, ratio=ratio, mutual=True,
                                 allowed=allowed)
    return idx, uv, mp_ok


def search_brute_force(descA, maskA, descB, maskB, max_dist: float = M.TH_LOW,
                       ratio: float = 1.0):
    """Mutual brute-force matching (SearchByBoW: cv::BFMatcher with
    crossCheck). CUDA tensors run the hand-written row_top2 kernel at any
    shape (the TPU's multiple-of-128 rule does not carry over); CPU tensors
    run its plain version."""
    return bf_match.match_descriptors_fused(descA, maskA, descB, maskB,
                                            max_dist=max_dist, ratio=ratio)


def search_for_initialization(xyA, descA, maskA, xyB, descB, maskB,
                              window: float = 100.0, max_dist: float = M.TH_LOW,
                              ratio: float = 0.9):
    """Windowed search between the two init frames (SearchForInitialization)."""
    allowed = M.window_allowed(xyA, xyB, window)
    return M.match_descriptors(descA, maskA, descB, maskB, max_dist=max_dist,
                               ratio=ratio, mutual=True, allowed=allowed)


def search_for_triangulation(xn1, desc1, sigma2_1, mask1, xn2, desc2, sigma2_2,
                             mask2, R21, t21, f_px: float,
                             max_dist: float = M.TH_LOW, chi2_epi: float = 3.84):
    """Epipolar-gated mutual matching between two keyframes in normalized
    coordinates (SearchForTriangulation). R21/t21: x2 = R21 x1 + t21."""
    z = torch.zeros((), dtype=t21.dtype, device=t21.device)
    tx = torch.stack([torch.stack([z, -t21[2], t21[1]]),
                      torch.stack([t21[2], z, -t21[0]]),
                      torch.stack([-t21[1], t21[0], z])])
    E = tx @ R21
    h1 = torch.cat([xn1, torch.ones_like(xn1[:, :1])], 1)
    h2 = torch.cat([xn2, torch.ones_like(xn2[:, :1])], 1)
    l2 = h1 @ E.T
    d2 = (l2 @ h2.T) ** 2 / torch.clamp(l2[:, 0:1] ** 2 + l2[:, 1:2] ** 2, min=1e-12)
    epi_ok = d2 < chi2_epi * (sigma2_2[None, :] / (f_px * f_px))
    tz = torch.where(torch.abs(t21[2]) < 1e-9, 1e-9, t21[2])
    epi = t21[:2] / tz
    d_ep2 = torch.sum((xn2 - epi[None, :]) ** 2, 1) * (f_px * f_px)
    allowed = epi_ok & (d_ep2 > 100.0 * sigma2_2)[None, :]
    return M.match_descriptors(desc1, mask1, desc2, mask2, max_dist=max_dist,
                               mutual=True, allowed=allowed)
