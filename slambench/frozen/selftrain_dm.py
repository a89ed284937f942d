"""HF-Net weights at any backbone width for a run: He-initialized on the card
from the seed, then fine-tuned on a CylinderWorld's exact correspondences
and, where asked, on its exact keypoints.

frozen/selftrain.py (itself a frozen copy of the port's models/selftrain.py)
with the width as a parameter: the same single randn draw over the
parameters in creation order, the same symmetric InfoNCE of the descriptors
at ground-truth correspondences, Adam on the local branch, a cache of
rendered views, pairs drawn with numpy, and deterministic algorithms; the
network is reference/hfnet_dm.py's at `depth_multiplier`, and the views
follow the traffic's own camera path (`pose`).

The detector term (`det`): HF-Net's detector head is SuperPoint's, trained on
keypoints that repeat. A fine-tune of the descriptor alone leaves it at its
random initialization, whose peaks land 3-4 px from where the previous
frame's peaks project, and a monocular map made from such keypoints does not
hold. The world's own keypoints stand in for the labels: the well-curved
extrema of the wall's texture (`texture_points`), fixed on the wall, each
projected exactly into every view (`view_targets`). The loss is SuperPoint's
65-way cross-entropy per stride-8 cell, with a soft target: the pixels
around a keypoint take its strength (its texture curvature's rank, in
[floor, 1], spread as a Gaussian of `spread` px) and the dustbin the rest,
so that a keypoint's score, and with it the top-K that the extractor keeps,
follows the same order in every view. Each step
runs at one of the extractor's pyramid levels, drawn with the pairs.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..reference import hfnet_dm as RD
from .selftrain import LOCAL_PREFIXES, deterministic, info_nce


def init_params(seed, device, depth_multiplier):
    """{name: float32 tensor} of the whole network at the width: He-normal
    weights (the NetVLAD clusters 0.1-normal) from one randn draw, zero
    biases."""
    shapes = RD.param_shapes(depth_multiplier)
    sizes = {k: int(np.prod(s)) for k, (s, fan) in shapes.items()
             if fan is not None or k == "vlad_clusters"}
    g = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    flat = torch.randn(sum(sizes.values()), generator=g, device=device)
    out, at = {}, 0
    for k, (shape, fan) in shapes.items():
        if k in sizes:
            std = 0.1 if fan is None else RD.R.he_std(fan)
            out[k] = (flat[at:at + sizes[k]].view(shape) * std).contiguous()
            at += sizes[k]
        else:
            out[k] = torch.zeros(shape, device=device)
    return out


def texture_points(world, sigma, window, min_curvature, floor):
    """The wall's keypoints: every extremum of the texture (smoothed by a
    Gaussian of `sigma` tile pixels) that is the largest or smallest value in
    its `window` x `window` neighbourhood and whose Hessian's eigenvalues
    share a sign, the smaller at least `min_curvature` (grey levels a pixel
    squared), refined to the vertex of its quadratic. Returns the world
    points (K,3) float64 and their strengths (K,) float32, the curvature's
    rank spread over [floor, 1]."""
    TW, TH = world.tile_wh
    t = torch.as_tensor(np.asarray(world.tex, np.float32))[None, None]
    r = int(3 * sigma)
    x = torch.arange(-r, r + 1, dtype=torch.float32)
    g = torch.exp(-x ** 2 / (2 * sigma ** 2))
    g = g / g.sum()
    # the tile wraps around the wall horizontally; its rows end at the wall's
    # top and bottom
    t = F.conv2d(F.pad(t, (r, r, 0, 0), mode="circular"), g.view(1, 1, 1, -1))
    t = F.conv2d(F.pad(t, (0, 0, r, r), mode="replicate"), g.view(1, 1, -1, 1))
    tp = F.pad(F.pad(t, (1, 1, 0, 0), mode="circular"), (0, 0, 1, 1), mode="replicate")[0, 0]
    c = tp[1:-1, 1:-1]
    dx = 0.5 * (tp[1:-1, 2:] - tp[1:-1, :-2])
    dy = 0.5 * (tp[2:, 1:-1] - tp[:-2, 1:-1])
    dxx = tp[1:-1, 2:] - 2 * c + tp[1:-1, :-2]
    dyy = tp[2:, 1:-1] - 2 * c + tp[:-2, 1:-1]
    dxy = 0.25 * (tp[2:, 2:] - tp[2:, :-2] - tp[:-2, 2:] + tp[:-2, :-2])
    tr, det = dxx + dyy, dxx * dyy - dxy ** 2
    disc = torch.sqrt(torch.clamp(tr * tr / 4 - det, min=0))
    curv = torch.where(det > 0, torch.minimum((tr / 2 - disc).abs(), (tr / 2 + disc).abs()), 0.0)
    h = window // 2
    tw = F.pad(F.pad(t, (h, h, 0, 0), mode="circular"), (0, 0, h, h), mode="replicate")
    mx = F.max_pool2d(tw, window, 1)[0, 0]
    mn = -F.max_pool2d(-tw, window, 1)[0, 0]
    t = t[0, 0]
    keep = ((t == mx) | (t == mn)) & (curv > min_curvature)
    keep[:2] = False
    keep[-2:] = False
    ys, xs = torch.nonzero(keep, as_tuple=True)
    a, b, d = dxx[ys, xs], dxy[ys, xs], dyy[ys, xs]
    gx, gy = dx[ys, xs], dy[ys, xs]
    den = a * d - b * b
    u = (xs + (-(d * gx - b * gy) / den).clamp(-0.5, 0.5)).double().numpy()
    v = (ys + (-(a * gy - b * gx) / den).clamp(-0.5, 0.5)).double().numpy()
    rank = np.argsort(np.argsort(curv[ys, xs].numpy(), kind="stable"), kind="stable")
    strength = (floor + (1 - floor) * rank / max(len(rank) - 1, 1)).astype(np.float32)
    # frozen/synth.CylinderWorld.render_rgbd's texture lookup, inverted
    th = (u / (TW - 1) - 0.5) * 2 * np.pi
    y = v / (TH - 1) * world.y_span - world.y_span / 2
    C, RW = world.center, world.wall_radius
    P = np.stack([C[0] + RW * np.sin(th), y, C[2] - RW * np.cos(th)], 1)
    return P, strength


def view_targets(world, P, strength, pose, level_hw, spread, grid=RD.DETECTOR_GRID):
    """The detector's soft target of one view at one pyramid level: (65,
    h/grid, w/grid) float32 and the cells that hold a keypoint (h/grid,
    w/grid) bool. Each world point is projected exactly and mapped onto the
    level as its half-pixel-centre resize maps pixels; a cell keeps its
    strongest keypoint, whose strength goes to the cell's pixels as a
    Gaussian of `spread` px around it, and the rest to the dustbin."""
    R_cw, t_cw = pose
    c = world.cam
    H, W = c["height"], c["width"]
    h, w = level_hw
    pc = P @ np.asarray(R_cw, np.float64).T + np.asarray(t_cw, np.float64)
    z = np.maximum(pc[:, 2], 1e-6)
    u = (c["fx"] * pc[:, 0] / z + c["cx"] + 0.5) * (w / W) - 0.5
    v = (c["fy"] * pc[:, 1] / z + c["cy"] + 0.5) * (h / H) - 0.5
    ok = (pc[:, 2] > 0.5) & (u >= 0) & (v >= 0) & (u < w - 0.5) & (v < h - 0.5)
    u, v, s = u[ok], v[ok], strength[ok]
    xi, yi = np.round(u).astype(int), np.round(v).astype(int)
    hc, wc = h // grid, w // grid
    inside = (xi < wc * grid) & (yi < hc * grid)
    u, v, s, xi, yi = u[inside], v[inside], s[inside], xi[inside], yi[inside]
    cell = (yi // grid) * wc + xi // grid
    order = np.lexsort((s, cell))                  # by cell, strongest last
    last = np.r_[cell[order][1:] != cell[order][:-1], True]
    k = order[last]
    T = np.zeros((grid * grid + 1, hc * wc), np.float32)
    T[-1] = 1.0
    gy, gx = np.mgrid[0:grid, 0:grid]
    ox, oy = u[k] - (xi[k] // grid) * grid, v[k] - (yi[k] // grid) * grid
    wgt = np.exp(-((gx[None] - ox[:, None, None]) ** 2 + (gy[None] - oy[:, None, None]) ** 2)
                 / (2 * spread ** 2)).reshape(len(k), -1)
    T[:-1, cell[k]] = (s[k, None] * wgt / wgt.sum(1, keepdims=True)).T
    T[-1, cell[k]] = 1.0 - s[k]
    pos = np.zeros(hc * wc, bool)
    pos[cell[k]] = True
    return T.reshape(-1, hc, wc), pos.reshape(hc, wc)


def detector_loss(p, lf, T, pos, dustbin_weight=0.2):
    """SuperPoint's detector loss with soft targets, summed over the batch:
    per image the cross-entropy of the 65-way softmax against T (B,65,h,w),
    the keypoint cells (pos) and the empty ones averaged apart, the empty
    ones weighted by dustbin_weight."""
    ce = -(T * F.log_softmax(RD.R.detector_logits(p, lf), 1)).sum(1)
    pos = pos.to(ce.dtype)
    return ((ce * pos).sum((1, 2)) / pos.sum((1, 2)).clamp(min=1)
            + dustbin_weight * (ce * (1 - pos)).sum((1, 2))
            / (1 - pos).sum((1, 2)).clamp(min=1)).sum()


def train(world, params, seed, n_steps, n_pairs, n_frames_cache, pose_range, pose_offset,
          depth_multiplier, pose, lr=1e-3, gap=(1, 6), det=None, levels=None):
    """Fine-tune the local branch of `params` (not modified) for n_steps on
    views `pose(i)` of frames pose_offset .. pose_offset + pose_range - 1.
    `det` (a dict: weight, spread, and texture_points' keywords sigma,
    window, min_curvature, floor) adds the detector term; `levels` (the pyramid's (h, w), level 0 first) makes each
    step run at a level drawn from the pairs' generator. Returns (new
    params, stats)."""
    dev = next(iter(params.values())).device
    det = dict(det or {})
    det_weight, spread = float(det.pop("weight", 0.0)), det.pop("spread", None)
    with deterministic():
        p = {k: (v.detach().clone().requires_grad_(True) if k.startswith(LOCAL_PREFIXES) else v)
             for k, v in params.items()}
        opt = torch.optim.Adam([v for k, v in p.items() if k.startswith(LOCAL_PREFIXES)],
                               lr=lr, betas=(0.9, 0.999), eps=1e-8)
        rng = np.random.default_rng(seed)
        H, W = world.cam["height"], world.cam["width"]
        levels = [tuple(hw) for hw in (levels or [(H, W)])]
        P, strength = texture_points(world, **det) if det_weight > 0 else (None, None)
        idxs = pose_offset + np.linspace(0, pose_range - 1, n_frames_cache).astype(int)
        cache = []
        for i in idxs:
            ps = pose(int(i))
            img, dep = world.render_rgbd(*ps)
            cache.append((ps, dep, torch.as_tensor(img, device=dev)))
        losses, det_losses = [], []
        for _ in range(n_steps):
            ka = int(rng.choice(len(cache) - 1))
            kb = min(ka + int(rng.integers(*gap)), len(cache) - 1)
            (pa, da, ia), (pb, _, ib) = cache[ka], cache[kb]
            ua, ub = world.correspondences(pa, pb, da, n_pairs + 64, rng)
            lvl = int(rng.integers(len(levels))) if len(levels) > 1 else 0
            if len(ua) < n_pairs:
                continue
            h, w = levels[lvl]
            imgs = torch.stack([ia, ib])
            if lvl:
                imgs = torch.stack([RD.R.resize(ia, (h, w)), RD.R.resize(ib, (h, w))])
            # the pairs' pixels on the level, as its half-pixel-centre resize maps them
            sc = np.array([w / W, h / H], np.float32)
            ua_l = torch.as_tensor((ua[:n_pairs] + 0.5) * sc - 0.5, device=dev)
            ub_l = torch.as_tensor((ub[:n_pairs] + 0.5) * sc - 0.5, device=dev)
            opt.zero_grad(set_to_none=True)
            lf = RD.backbone_local(p, imgs[:, None], depth_multiplier)
            dm = RD.R.descriptor_map(p, lf)
            loss = info_nce(RD.R.sample(dm[0], ua_l, (h, w)), RD.R.sample(dm[1], ub_l, (h, w)))
            if det_weight > 0:
                ta, qa = view_targets(world, P, strength, pa, (h, w), spread)
                tb, qb = view_targets(world, P, strength, pb, (h, w), spread)
                ld = detector_loss(p, lf, torch.as_tensor(np.stack([ta, tb]), device=dev),
                                   torch.as_tensor(np.stack([qa, qb]), device=dev))
                loss = loss + det_weight * ld
                det_losses.append(ld.detach())
            loss.backward()
            opt.step()
            losses.append(loss.detach())
    losses = [float(v) for v in losses]
    det_losses = [float(v) for v in det_losses]
    out = {k: v.detach() for k, v in p.items()}
    return out, {"steps": len(losses), "loss_first": losses[0] if losses else None,
                 "loss_last": float(np.mean(losses[-10:])) if losses else None,
                 "det_loss_last": float(np.mean(det_losses[-10:])) if det_losses else None}
