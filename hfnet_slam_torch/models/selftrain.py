"""Self-supervised HF-Net fine-tuning on synthetic ground truth.

Counterpart of hfnet_slam_tpu/models/selftrain.py. A renderable world with
exact correspondences (models/synth.CylinderWorld) trains the descriptor
head with a symmetric InfoNCE over ground-truth pixel correspondences, and
the detector head with SuperPoint-style 65-way cell cross-entropy on known
corner locations. A few hundred Adam steps turn the random-init network
into a usable local feature extractor, which the CNN-in-the-loop run
(scenes.cnn_system) then puts inside the RGB-D SLAM loop.

A train step is one forward and one backward of HF-Net's local branch
(backbone to the local endpoint, both heads) on the pair of images, batched
as one (2,H,W) input, on the network's device; autograd and cuDNN compute
the backward, as XLA does for the reference. optax.adam becomes
torch.optim.Adam with the same betas and eps (optax's eps_root is 0, so the
update is the same). The host loop renders a cache of views and samples
correspondence batches with numpy, drawing from the generator in the
reference's order, so both packages pick the same pairs from the same seed.
"""
from __future__ import annotations

import time

import numpy as np
import torch
import torch.nn.functional as F

from .. import device as D
from ..ops import extract as X
from .hfnet import DETECTOR_GRID, LOCAL_ENDPOINT, HFNet

_LOCAL_PREFIXES = ("conv0.", "desc0.", "desc1.", "det0.", "det1.") + tuple(
    f"blocks.{i}." for i in range(LOCAL_ENDPOINT + 1))


def init_net(device=None) -> HFNet:
    """The port's seed-0 HF-Net, frozen, on `device` (None means CUDA): He
    initialization drawn from a CPU torch.Generator seeded 0, so the CPU and
    the card start from the same weights."""
    dev = D.resolve(device)
    return HFNet(torch.Generator().manual_seed(0)).to(dev).eval()


def trainable_copy(net: HFNet, device=None) -> HFNet:
    """A copy of `net` on `device` whose local-branch parameters (all a train
    step reaches) are fresh tensors that require grad; the global head's
    frozen tensors are shared with `net`, not copied."""
    dev = D.resolve(device)
    state = {k: v.detach().to(dev).clone() if k.startswith(_LOCAL_PREFIXES) else v.to(dev)
             for k, v in net.state_dict().items()}
    out = HFNet()
    out.load_state_dict(state, assign=True)
    for k, p in out.named_parameters():
        p.requires_grad_(k.startswith(_LOCAL_PREFIXES))
    return out


def local_parameters(net: HFNet):
    return [p for k, p in net.named_parameters() if k.startswith(_LOCAL_PREFIXES)]


def info_nce(da, db, temp=10.0):
    """Symmetric InfoNCE of descriptors (n,D) at corresponding pixels:
    row i of each is the other's positive, every other row a negative."""
    S = da @ db.T * temp
    labels = torch.arange(S.shape[0], device=S.device)
    return 0.5 * (F.cross_entropy(S, labels) + F.cross_entropy(S.T, labels))


def detector_ce(net: HFNet, local_feat, tgt, dustbin_weight=0.2):
    """SuperPoint-style detector supervision, summed over the batch: per
    image, 65-way cross-entropy per stride-8 cell against known corner cells
    (tgt == 64 is the dustbin), the rare corner cells and the dustbin cells
    averaged apart. local_feat (B,h,w,128), tgt (B,h,w) int64."""
    ce = F.cross_entropy(net.detector_logits(local_feat), tgt, reduction="none")
    corner = tgt < DETECTOR_GRID ** 2
    pos = torch.where(corner, ce, 0.0).sum((1, 2)) / torch.clamp(corner.sum((1, 2)), min=1)
    neg = torch.where(~corner, ce, 0.0).sum((1, 2)) / torch.clamp((~corner).sum((1, 2)), min=1)
    return (pos + dustbin_weight * neg).sum()


def loss_fn(net: HFNet, img_a, img_b, uv_a, uv_b, tgt_a, tgt_b, hw, det_weight=1.0):
    """The reference's loss_fn: InfoNCE of the descriptors sampled at the
    correspondences, plus det_weight times both images' detector loss. The
    two images go through the backbone as one batch."""
    lf = net.backbone_local(torch.stack([img_a, img_b])[..., None])
    dm = net.descriptor_map(lf)
    loss = info_nce(X.sample_descriptors(dm[0], uv_a, hw), X.sample_descriptors(dm[1], uv_b, hw))
    if det_weight > 0:
        loss = loss + det_weight * detector_ce(net, lf, torch.stack([tgt_a, tgt_b]).long())
    return loss


def make_optimizer(net: HFNet, lr: float):
    """optax.adam(lr) as torch.optim.Adam over the local branch."""
    return torch.optim.Adam(local_parameters(net), lr=lr, betas=(0.9, 0.999), eps=1e-8)


def train_step(net, opt, img_a, img_b, uv_a, uv_b, tgt_a, tgt_b, hw, det_weight):
    """One Adam step on the loss. Returns the loss (a 0-d tensor on the
    network's device; reading it waits for the device)."""
    opt.zero_grad(set_to_none=True)
    loss = loss_fn(net, img_a, img_b, uv_a, uv_b, tgt_a, tgt_b, hw, det_weight)
    loss.backward()
    opt.step()
    return loss.detach()


def train(world, net=None, n_steps=300, n_pairs=192, lr=1e-3, det_weight=0.0,
          pose_range=100, gap=(1, 6), seed=1, n_frames_cache=24, device=None):
    """Fine-tune HF-Net on a CylinderWorld on `device` (None means CUDA).
    `net` (default: init_net) is not modified. Returns (net', stats): net'
    frozen and in eval mode, ready for HFExtractor; stats holds `steps`,
    `loss_first`, `loss_last` (the mean of the last 10), every step's
    `losses` and `train_s`.

    det_weight=0 trains descriptors only (the reference's default); > 0
    adds detector supervision. Views are rendered once, for a cache of
    n_frames_cache poses over the first pose_range frames."""
    dev = D.resolve(device)
    D.full_fp32()
    cam = world.cam
    hw = (cam.height, cam.width)
    model = trainable_copy(init_net(dev) if net is None else net, dev)
    opt = make_optimizer(model, lr)
    rng = np.random.default_rng(seed)

    idxs = np.linspace(0, pose_range - 1, n_frames_cache).astype(int)
    cache = {}
    for i in idxs:
        pose = world.orbit_pose(int(i))
        img, dep = world.render_rgbd(*pose)
        tgt = world.corner_cells(*pose) if det_weight > 0 else \
            np.zeros((cam.height // 8, cam.width // 8), np.int32)
        cache[int(i)] = (pose, dep, torch.as_tensor(img, device=dev),
                         torch.as_tensor(tgt, dtype=torch.int64, device=dev))
    keys = sorted(cache)

    t0 = time.perf_counter()
    losses = []
    for _ in range(n_steps):
        ka = int(rng.choice(len(keys) - 1))
        kb = min(ka + int(rng.integers(*gap)), len(keys) - 1)
        pa, da, ia, ta = cache[keys[ka]]
        pb, _, ib, tb = cache[keys[kb]]
        ua, ub = world.correspondences(pa, pb, da, n_pairs + 64, rng)
        if len(ua) < n_pairs:
            continue
        losses.append(train_step(model, opt, ia, ib,
                                 torch.as_tensor(ua[:n_pairs], device=dev),
                                 torch.as_tensor(ub[:n_pairs], device=dev), ta, tb, hw,
                                 det_weight))
    losses = [float(v) for v in losses]  # waits for the device
    train_s = time.perf_counter() - t0
    model.requires_grad_(False)
    return model.eval(), {
        "steps": len(losses),
        "loss_first": losses[0] if losses else None,
        "loss_last": float(np.mean(losses[-10:])) if losses else None,
        "losses": losses,
        "train_s": train_s,
    }
