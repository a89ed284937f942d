"""The per-frame feature record every extractor emits, and the HF-Net
pyramid extractor.

Counterpart of hfnet_slam_tpu/models/extractor.py. `HFExtractor` builds a
pyramid of the image, runs HF-Net on each level at its native resolution
(the stride-16/32 backbone tail and the NetVLAD head only at level 0, the
reference's kImageToLocal split), selects keypoints with NMS and top-K,
refines them to subpixel and samples their descriptors, all on its device.
It is the CNN counterpart of the stand-in in models/fake.py; both emit the
same fixed-capacity `Features`.
"""
from __future__ import annotations

import copy
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import device as D
from ..ops import extract as X
from ..utils.timing import timings


class Features(NamedTuple):
    """Per-frame extracted features, fixed capacity N = pad_to."""

    xy: torch.Tensor           # (N,2) level-0 pixel coords [x, y], float32
    score: torch.Tensor        # (N,) float32
    octave: torch.Tensor       # (N,) int32 pyramid level
    desc: torch.Tensor         # (N,D) L2-normalized local descriptors
    mask: torch.Tensor         # (N,) bool valid
    global_desc: torch.Tensor  # (G,) float32

    def to(self, device) -> "Features":
        return Features(*(x.to(device) for x in self))


def resize(image, hw):
    """Bilinear resize of an (H,W) float image to hw = (h,w), as
    jax.image.resize(..., "bilinear") does it: half-pixel centres, and an
    antialiasing (triangle) filter widened by the scale when it downsamples."""
    return F.interpolate(image[None, None], size=tuple(hw), mode="bilinear",
                         align_corners=False, antialias=True)[0, 0]


class HFExtractor:
    """Fixed-shape pyramid extractor for one camera resolution.

    Mirrors the reference's extractor config (Settings.h:99-104: nFeatures,
    nLevels, scaleFactor, threshold). `net` is an HFNet; the extractor runs
    it on `device` (None means CUDA) in `dtype`, on a copy when the net lives
    elsewhere or in another dtype. With dtype=torch.bfloat16 the network
    runs in bf16 and NMS, selection and sampling stay float32."""

    def __init__(self, net, image_hw, n_features: int = 1000, n_levels: int = 4,
                 scale_factor: float = 1.2, threshold: float = 0.01, pad_to: int = 1024,
                 nms_radius: int = 4, dtype=torch.float32, device=None):
        self.device = D.resolve(device)
        D.full_fp32()
        H, W = image_hw
        H, W = (H // 8) * 8, (W // 8) * 8  # crop to a multiple of 8 (hf_net.py:188-190)
        self.image_hw = (H, W)
        self.n_levels = n_levels
        self.scale_factor = scale_factor
        self.scales = [scale_factor ** i for i in range(n_levels)]
        self.level_hw = [
            (max(int(round(H / s)) // 8 * 8, 8), max(int(round(W / s)) // 8 * 8, 8))
            for s in self.scales
        ]
        self.threshold = threshold
        self.budgets = X.level_budgets(n_features, scale_factor, n_levels)
        self.pad_to = pad_to
        n = sum(max(int(b), 1) for b in self.budgets)
        if pad_to < n:
            raise ValueError(f"pad_to {pad_to} < total budget {n}")
        self.nms_radius = nms_radius
        self.dtype = dtype
        p = next(net.parameters())
        want = self.device
        if want.type == "cuda" and want.index is None:  # where .to("cuda") puts tensors
            want = torch.device("cuda", torch.cuda.current_device())
        if p.device != want or p.dtype != dtype:
            net = copy.deepcopy(net).to(device=self.device, dtype=dtype)
        self.net = net.eval()

    def __call__(self, image) -> Features:
        """image: (H,W) or (H,W,1) grayscale, uint8 or float in [0,255], a
        numpy array or a tensor. Spans: `extract`, with `extract.forward`
        and `extract.post` for each level."""
        with timings.span("extract"):
            image = torch.as_tensor(image)
            if image.ndim == 3:
                image = image[..., 0]
            image = image[: self.image_hw[0], : self.image_hw[1]]
            image = D.upload(image, None, self.device) if image.device.type == "cpu" \
                else image.to(self.device)
            with torch.no_grad():
                return self._extract(image.to(torch.float32))

    def _extract(self, image) -> Features:
        xs, ss, os_, ds, ms = [], [], [], [], []
        global_desc = None
        for lvl in range(self.n_levels):
            with timings.span("extract.forward"):
                scores_dense, desc_map, g = self._forward_level(lvl, image)
            if g is not None:
                global_desc = g
            with timings.span("extract.post"):
                xy, sc, mk, desc = self._post_level(lvl, scores_dense, desc_map)
            xs.append(xy)
            ss.append(sc)
            os_.append(torch.full((len(sc),), lvl, dtype=torch.int32, device=self.device))
            ds.append(desc)
            ms.append(mk)

        pad = self.pad_to - sum(len(s) for s in ss)
        if pad:
            z = dict(device=self.device)
            xs.append(torch.zeros((pad, 2), **z))
            ss.append(torch.zeros((pad,), **z))
            os_.append(torch.zeros((pad,), dtype=torch.int32, **z))
            ds.append(torch.zeros((pad, ds[0].shape[1]), **z))
            ms.append(torch.zeros((pad,), dtype=torch.bool, **z))
        score = torch.cat(ss)
        return Features(torch.cat(xs), score, torch.cat(os_), torch.cat(ds),
                        torch.cat(ms) & (score > 0), global_desc)

    def _forward_level(self, lvl, image):
        """HF-Net on pyramid level `lvl` of the (H,W) float32 image ->
        (dense scores (1,h,w), descriptor map (1,h/8,w/8,256), and at level 0
        the float32 global descriptor (4096,), else None)."""
        h, w = self.level_hw[lvl]
        lv = resize(image, (h, w)) if lvl else image
        lv = lv[None, :, :, None].to(self.dtype)
        if lvl == 0:
            out = self.net(lv, with_global=True)
            return out["scores_dense"], out["desc_map"], out["global_desc"][0].float()
        scores, desc_map = self.net.local_head(self.net.backbone_local(lv))
        return scores, desc_map, None

    def _post_level(self, lvl, scores_dense, desc_map):
        """NMS, top-K, subpixel refinement and descriptor sampling of one
        level -> (level-0 xy, score, mask, desc), budget-many rows each."""
        h, w = self.level_hw[lvl]
        raw = scores_dense.float()
        scores = X.simple_nms(raw, self.nms_radius)[0]
        k = max(int(self.budgets[lvl]), 1)
        xy, sc, mk = X.select_keypoints(scores, None, self.threshold, k)
        # subpixel peaks on the RAW (pre-NMS) score map
        xy = X.refine_subpixel(raw[0], xy)
        desc = X.sample_descriptors(desc_map[0].float(), xy, (h, w))
        return xy * self.scales[lvl], sc, mk, desc
