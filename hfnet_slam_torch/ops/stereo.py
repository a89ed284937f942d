"""Stereo depth association, on torch tensors.

Counterpart of hfnet_slam_tpu/ops/stereo.py (Frame::ComputeStereoMatches,
Frame::ComputeStereoFishEyeMatches + KannalaBrandt8::TriangulateMatches and
Frame::ComputeStereoFromRGBD). Rectified matching is one masked similarity
matmul: the row table becomes a |vL - vR| band, the disparity range a mask,
and the mutual matcher is ops/matching.match_descriptors with an `allowed`
window (not the row_top2 kernel, which takes no such mask).
"""
from __future__ import annotations

import torch

from ..geometry import cameras, triangulation
from . import matching as M


def match_stereo(xyL, descL, octL, maskL, xyR, descR, octR, maskR, fx: float,
                 baseline: float, min_z: float = 0.1, row_tol: float = 2.0,
                 max_dist: float = (M.TH_HIGH + M.TH_LOW) / 2):
    """Associate rectified left/right features. Gates: same row within
    row_tol * 1.2^octave(L); disparity in (0, bf/min_z), both strict; octaves
    within 1; mutual best descriptor match under max_dist.
    Returns depth (NL,) float32, 0 where unmatched, and the matched right
    x-coordinate u_right (NL,), -1 where unmatched."""
    bf = fx * baseline
    max_d = bf / min_z
    row_w = row_tol * 1.2 ** octL.to(torch.float32)
    row_ok = torch.abs(xyL[:, 1:2] - xyR[None, :, 1]) <= row_w[:, None]
    disp = xyL[:, 0:1] - xyR[None, :, 0]
    disp_ok = (disp > 0.0) & (disp < max_d)
    oct_ok = torch.abs(octL[:, None] - octR[None, :]) <= 1
    idx, _ = M.match_descriptors(descL, maskL, descR, maskR, max_dist=max_dist, mutual=True,
                                 allowed=row_ok & disp_ok & oct_ok)
    safe = torch.clamp(idx.long(), 0, xyR.shape[0] - 1)
    uR = torch.where(idx >= 0, xyR[safe, 0], -1.0)
    d = xyL[:, 0] - uR
    # a true division: torch computes `scalar / tensor` as a reciprocal times
    # the scalar, which can differ from it in the last bit
    bf_t = torch.tensor(bf, dtype=d.dtype, device=d.device)
    depth = torch.where((idx >= 0) & (d > 1e-3), bf_t / torch.clamp(d, min=1e-3), 0.0)
    return depth, uR


def match_stereo_fisheye(kind_l, params_l, kind_r, params_r, xyL, descL, octL, maskL,
                         xyR, descR, octR, maskR, R_lr, t_lr, max_dist: float = 0.8,
                         ratio: float = 0.7, min_parallax_cos: float = 0.9998,
                         chi2: float = 5.991):
    """Unrectified (fisheye) stereo association: ratio-gated mutual
    descriptor matching, both keypoints unprojected through their own
    camera, the parallax gate, DLT in the LEFT frame, cheirality in both
    cameras and chi2 <= 5.991 sigma^2 in each. R_lr, t_lr: the right camera
    in the left frame (x_l = R_lr x_r + t_lr).
    Returns depth (NL,) (z in the left camera, 0 where rejected), idx (NL,)
    int32 (right slot or -1) and p3d (NL,3) in the left camera frame."""
    idx, _ = M.match_descriptors(descL, maskL, descR, maskR, max_dist=max_dist, ratio=ratio,
                                 mutual=True)
    safe = torch.clamp(idx.long(), 0, xyR.shape[0] - 1)
    r1 = cameras.unproject(kind_l, params_l, xyL)
    r2 = cameras.unproject(kind_r, params_r, xyR)[safe]
    r21 = r2 @ R_lr.T
    cosp = torch.sum(r1 * r21, -1) / torch.clamp(
        torch.linalg.norm(r1, dim=-1) * torch.linalg.norm(r21, dim=-1), min=1e-12)
    R_rl = R_lr.T
    t_rl = -R_lr.T @ t_lr
    p1 = triangulation.triangulate_dlt(r1[:, :2], r2[:, :2], R_rl, t_rl)
    p2 = p1 @ R_rl.T + t_rl
    uv1 = cameras.project(kind_l, params_l, p1)
    uv2 = cameras.project(kind_r, params_r, p2)
    s2_1 = 1.2 ** (2.0 * octL.to(torch.float32))
    s2_2 = (1.2 ** (2.0 * octR.to(torch.float32)))[safe]
    e1 = torch.sum((uv1 - xyL) ** 2, -1)
    e2 = torch.sum((uv2 - xyR[safe]) ** 2, -1)
    ok = ((idx >= 0) & (cosp < min_parallax_cos) & (p1[..., 2] > 0) & (p2[..., 2] > 0)
          & (e1 <= chi2 * s2_1) & (e2 <= chi2 * s2_2) & torch.all(torch.isfinite(p1), -1))
    depth = torch.where(ok, p1[..., 2], 0.0)
    return depth, torch.where(ok, idx, -1).to(torch.int32), p1


def depth_at_keypoints(depth_image, xy, depth_factor: float = 1.0):
    """RGB-D: the registered depth map at the keypoints' nearest pixels
    (rounding half to even, clipped to the image), times depth_factor; 0
    where the value is not finite or not positive."""
    H, W = depth_image.shape
    u = torch.clamp(torch.round(xy[:, 0]).to(torch.int64), 0, W - 1)
    v = torch.clamp(torch.round(xy[:, 1]).to(torch.int64), 0, H - 1)
    d = depth_image[v, u] * depth_factor
    return torch.where(torch.isfinite(d) & (d > 0), d, 0.0)
