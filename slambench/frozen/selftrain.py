"""HF-Net weights for a run: He-initialized on the card from the seed, then
fine-tuned on a CylinderWorld's exact correspondences.

Frozen copy (commit 27c9911) of the port's models/selftrain.py (symmetric
InfoNCE of the descriptors at ground-truth correspondences, Adam on the
local branch, a cache of rendered views, pairs drawn with numpy), over the
plain network of reference/hfnet.py. The initial weights are drawn in one
call of a torch.Generator on the card. Training runs with deterministic
algorithms (`deterministic`), so one seed gives the same weights in every
run; the setting is restored before the program runs.
"""
from __future__ import annotations

import contextlib
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from ..reference import hfnet as R

LOCAL_PREFIXES = ("conv0.", "desc0.", "desc1.", "det0.", "det1.") + tuple(
    f"blocks.{i}." for i in range(R.LOCAL_ENDPOINT + 1))


def init_params(seed, device):
    """{name: float32 tensor} of the whole network: He-normal weights (the
    NetVLAD clusters 0.1-normal) from one randn draw, zero biases."""
    shapes = R.param_shapes()
    sizes = {k: int(np.prod(s)) for k, (s, fan) in shapes.items()
             if fan is not None or k == "vlad_clusters"}
    g = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    flat = torch.randn(sum(sizes.values()), generator=g, device=device)
    out, at = {}, 0
    for k, (shape, fan) in shapes.items():
        if k in sizes:
            std = 0.1 if fan is None else R.he_std(fan)
            out[k] = (flat[at:at + sizes[k]].view(shape) * std).contiguous()
            at += sizes[k]
        else:
            out[k] = torch.zeros(shape, device=device)
    return out


def info_nce(da, db, temp=10.0):
    S = da @ db.T * temp
    labels = torch.arange(S.shape[0], device=S.device)
    return 0.5 * (F.cross_entropy(S, labels) + F.cross_entropy(S.T, labels))


@contextlib.contextmanager
def deterministic():
    """Deterministic kernels where PyTorch has them (sorted scatters instead
    of atomics), so set-up work repeats bit for bit; restored on exit."""
    flags = (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            yield
    finally:
        torch.use_deterministic_algorithms(flags[0])
        torch.backends.cudnn.deterministic = flags[1]
        torch.backends.cudnn.benchmark = flags[2]


def train(world, params, seed, n_steps, n_pairs, n_frames_cache, pose_range, pose_offset,
          lr=1e-3, gap=(1, 6)):
    """Fine-tune the local branch of `params` (not modified) for n_steps on
    views of the orbit frames pose_offset .. pose_offset + pose_range - 1.
    Returns (new params, stats)."""
    dev = next(iter(params.values())).device
    with deterministic():
        return _train(world, params, seed, n_steps, n_pairs, n_frames_cache, pose_range,
                      pose_offset, lr, gap, dev)


def _train(world, params, seed, n_steps, n_pairs, n_frames_cache, pose_range, pose_offset,
           lr, gap, dev):
    p = {k: (v.detach().clone().requires_grad_(True) if k.startswith(LOCAL_PREFIXES) else v)
         for k, v in params.items()}
    opt = torch.optim.Adam([v for k, v in p.items() if k.startswith(LOCAL_PREFIXES)],
                           lr=lr, betas=(0.9, 0.999), eps=1e-8)
    rng = np.random.default_rng(seed)
    H, W = world.cam["height"], world.cam["width"]
    idxs = pose_offset + np.linspace(0, pose_range - 1, n_frames_cache).astype(int)
    cache = []
    for i in idxs:
        pose = world.orbit_pose(int(i))
        img, dep = world.render_rgbd(*pose)
        cache.append((pose, dep, torch.as_tensor(img, device=dev)))
    losses = []
    for _ in range(n_steps):
        ka = int(rng.choice(len(cache) - 1))
        kb = min(ka + int(rng.integers(*gap)), len(cache) - 1)
        (pa, da, ia), (pb, _, ib) = cache[ka], cache[kb]
        ua, ub = world.correspondences(pa, pb, da, n_pairs + 64, rng)
        if len(ua) < n_pairs:
            continue
        opt.zero_grad(set_to_none=True)
        lf = R.backbone_local(p, torch.stack([ia, ib])[:, None])
        dm = R.descriptor_map(p, lf)
        loss = info_nce(R.sample(dm[0], torch.as_tensor(ua[:n_pairs], device=dev), (H, W)),
                        R.sample(dm[1], torch.as_tensor(ub[:n_pairs], device=dev), (H, W)))
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    losses = [float(v) for v in losses]
    out = {k: v.detach() for k, v in p.items()}
    return out, {"steps": len(losses), "loss_first": losses[0] if losses else None,
                 "loss_last": float(np.mean(losses[-10:])) if losses else None}
