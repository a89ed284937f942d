"""Keypoint extraction post-processing on the device.

Counterpart of hfnet_slam_tpu/ops/extract.py (the reference's simple_nms,
top-K selection, subpixel refinement and bilinear descriptor sampling), in
plain PyTorch: the reference computes them as plain XLA, outside any Pallas
kernel. Where PyTorch's defaults differ from the reference's semantics:
  * NMS max-pools with F.max_pool2d, which pads with -inf as reduce_window
    does; suppression keeps the reference's float equality test;
  * selection is a stable descending sort, so equal scores keep the lower
    flat index first, as jax.lax.top_k does (torch.topk promises no order
    for ties, and after NMS most of the map ties at 0);
  * descriptors are sampled with align-corners coordinates, zero outside
    the map, by four explicit corner gathers (not grid_sample's defaults).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def simple_nms(scores, radius: int = 4, iterations: int = 2):
    """Max-pool NMS on the dense score map, (B,H,W) -> (B,H,W)."""
    size = 2 * radius + 1

    def max_pool(x):
        return F.max_pool2d(x, size, stride=1, padding=radius)

    zeros = torch.zeros_like(scores)
    max_mask = scores == max_pool(scores)
    for _ in range(iterations - 1):
        supp_mask = max_pool(max_mask.to(scores.dtype)) > 0
        supp_scores = torch.where(supp_mask, zeros, scores)
        new_max_mask = supp_scores == max_pool(supp_scores)
        max_mask = max_mask | (new_max_mask & ~supp_mask)
    return torch.where(max_mask, scores, zeros)


def select_keypoints(scores, valid_mask, threshold: float, k: int):
    """Top-K keypoints above threshold from a (H,W) score map.

    Returns (xy (k,2) float32 [x,y], score (k,), mask (k,)). Invalid slots
    have score 0 and mask False. valid_mask may be None (whole map valid).
    Ties are broken by flat index, lowest first."""
    H, W = scores.shape
    s = scores if valid_mask is None else torch.where(valid_mask, scores, 0.0)
    vals, idx = torch.sort(s.reshape(-1), descending=True, stable=True)
    vals, idx = vals[:k], idx[:k]
    xy = torch.stack([idx % W, idx // W], dim=-1).to(torch.float32)
    mask = vals >= threshold
    return xy, torch.where(mask, vals, 0.0), mask


def refine_subpixel(scores, xy):
    """3-tap quadratic subpixel refinement of integer keypoint peaks on the
    RAW (pre-NMS) score map: per axis the vertex offset
    0.5*(s_minus - s_plus) / (s_minus - 2 s_0 + s_plus), clamped to +-0.5
    px; keypoints on the map's border stay where they are."""
    H, W = scores.shape
    xi = xy[:, 0].to(torch.int64)
    yi = xy[:, 1].to(torch.int64)

    def at(yy, xx):
        return scores[yy.clamp(0, H - 1), xx.clamp(0, W - 1)]

    s0 = at(yi, xi)
    sxm, sxp = at(yi, xi - 1), at(yi, xi + 1)
    sym, syp = at(yi - 1, xi), at(yi + 1, xi)
    denx = sxm - 2.0 * s0 + sxp
    deny = sym - 2.0 * s0 + syp
    dx = torch.where(denx.abs() > 1e-9, 0.5 * (sxm - sxp) / denx, 0.0).clamp(-0.5, 0.5)
    dy = torch.where(deny.abs() > 1e-9, 0.5 * (sym - syp) / deny, 0.0).clamp(-0.5, 0.5)
    edge = (xi <= 0) | (xi >= W - 1) | (yi <= 0) | (yi >= H - 1)
    off = torch.where(edge[:, None], 0.0, torch.stack([dx, dy], -1))
    return xy + off


def sample_descriptors(desc_map, xy, img_hw):
    """Bilinear-resample descriptors at keypoint locations, row-L2-normalized.

    desc_map: (h, w, C) coarse map (stride 8 of the image); xy: (k, 2)
    pixel coords [x, y] in the image, of size img_hw = (H, W). Coordinates
    map as x_map = (w-1)/(W-1) * x, y_map = (h-1)/(H-1) * y (align
    corners), with zero padding outside the map."""
    h, w, C = desc_map.shape
    H, W = img_hw
    x = xy[:, 0] * ((w - 1.0) / (W - 1.0))
    y = xy[:, 1] * ((h - 1.0) / (H - 1.0))
    fx, fy = torch.floor(x), torch.floor(y)
    cx, cy = fx + 1, fy + 1
    dx, dy = cx - x, cy - y  # weights of the floor corners

    def gather(ix, iy):
        inb = (ix >= 0) & (ix <= w - 1) & (iy >= 0) & (iy <= h - 1)
        vals = desc_map[iy.clamp(0, h - 1).to(torch.int64), ix.clamp(0, w - 1).to(torch.int64)]
        return vals * inb[:, None]

    out = ((dx * dy)[:, None] * gather(fx, fy)
           + ((1 - dx) * (1 - dy))[:, None] * gather(cx, cy)
           + (dx * (1 - dy))[:, None] * gather(fx, cy)
           + ((1 - dx) * dy)[:, None] * gather(cx, fy))
    return out / torch.clamp(torch.linalg.vector_norm(out, dim=-1, keepdim=True), min=1e-12)


def level_budgets(n_features: int, scale_factor: float, n_levels: int):
    """Geometric per-level keypoint budget split (HFextractor.cc:108-119)."""
    inv = 1.0 / scale_factor
    n_desired = n_features * (1 - inv) / (1 - inv ** n_levels)
    budgets = []
    acc = 0
    for _ in range(n_levels - 1):
        b = int(round(n_desired))
        budgets.append(b)
        acc += b
        n_desired *= inv
    budgets.append(max(n_features - acc, 0))
    return budgets
