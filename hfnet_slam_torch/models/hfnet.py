"""HF-Net in PyTorch: MobileNetV2 backbone + detector/descriptor heads +
NetVLAD global head.

Counterpart of hfnet_slam_tpu/models/hfnet.py, with the same architecture
constants, the same inference-ready parameters (batch norm folded into every
conv's weight and bias) and the same flat .npz format (`load_params`,
`save_params`: keys such as `blocks/3/expand/w`, arrays in the reference's
HWIO layout). Inside the module weights are in PyTorch's layout: dense
convs OIHW, depthwise convs (mid,1,3,3) with groups=mid, and the NetVLAD
projection as a linear layer whose weight is the reference's (K*C, 4096)
matrix transposed. `state_from_flat` / `flat_from_state` convert.

The public methods keep the reference's NHWC layout at their boundaries.
Images have one channel, so (B,H,W,1) is already NCHW in memory; the
activations inside are NCHW and the NHWC results are permuted views of
them, so no layout copy is made between the methods.

Two details a plain translation gets wrong: XLA's 'SAME' padding of a
stride-2 conv is asymmetric (`same_pad`: low = total // 2, the rest high),
and the NetVLAD intra-normalization runs over the cluster axis K, as the
reference's does.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# (expansion, stride, out_channels) for layer_2..layer_18
BLOCKS = [
    (1, 1, 16),
    (6, 2, 24),
    (6, 1, 24),
    (6, 2, 32),
    (6, 1, 64),
    (6, 1, 128),  # local endpoint (index 5 in this list)
    (6, 2, 64),
    (6, 1, 64),
    (6, 1, 64),
    (6, 1, 64),
    (6, 1, 96),
    (6, 1, 96),
    (6, 1, 96),
    (6, 2, 160),
    (6, 1, 160),
    (6, 1, 160),
    (6, 1, 320),  # global endpoint
]
LOCAL_ENDPOINT = 5
DESC_DIM = 256
DETECTOR_GRID = 8
N_CLUSTERS = 64
GLOBAL_DIM = 4096
GLOBAL_FEAT = 320


def same_pad(n: int, k: int, s: int):
    """(low, high) padding of XLA's 'SAME' rule along an axis of length n."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _param(shape, fan_in, generator, scale=None):
    """He-normal (or `scale`-normal) parameter drawn from `generator` on its
    device; without a generator, a placeholder on the meta device."""
    if generator is None:
        t = torch.empty(shape, device="meta")
    else:
        std = math.sqrt(2.0 / fan_in) if scale is None else scale
        t = torch.randn(shape, generator=generator, device=generator.device) * std
    return nn.Parameter(t, requires_grad=False)


def _zeros(n, generator):
    dev = "meta" if generator is None else generator.device
    return nn.Parameter(torch.zeros(n, device=dev), requires_grad=False)


def relu6(x):
    y = torch.clamp(x, 0.0, 6.0)
    if not x.requires_grad:
        return y
    # the reference's jnp.clip passes half the gradient at exactly 0 and 6
    # (ties of lax.max / lax.min), where clamp passes all of it and hardtanh
    # none; zero biases make exact zeros common at initialization
    return 0.5 * (y + F.hardtanh(x, 0.0, 6.0))


def _l2(x, dim):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=dim, keepdim=True), min=1e-12)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class Conv(nn.Module):
    """A BN-folded k x k convolution (weight OIHW, bias) with 'SAME' padding."""

    def __init__(self, cin, cout, k, stride=1, groups=1, generator=None):
        super().__init__()
        self.k, self.stride, self.groups = k, stride, groups
        self.weight = _param((cout, cin // groups, k, k), k * k * cin // groups, generator)
        self.bias = _zeros(cout, generator)

    def forward(self, x):
        if self.k == 1 and self.stride == 1:
            return F.conv2d(x, self.weight, self.bias)
        top, bottom = same_pad(x.shape[-2], self.k, self.stride)
        left, right = same_pad(x.shape[-1], self.k, self.stride)
        if top == bottom and left == right:
            return F.conv2d(x, self.weight, self.bias, self.stride, (top, left), 1, self.groups)
        return F.conv2d(F.pad(x, (left, right, top, bottom)), self.weight, self.bias,
                        self.stride, 0, 1, self.groups)


class Block(nn.Module):
    """MobileNetV2 expanded block: 1x1 expand (unless expansion 1), 3x3
    depthwise, 1x1 linear projection, residual when the shape is kept."""

    def __init__(self, cin, expansion, stride, cout, generator=None):
        super().__init__()
        mid = cin * expansion
        self.residual = stride == 1 and cin == cout
        self.expand = Conv(cin, mid, 1, generator=generator) if expansion != 1 else None
        self.depthwise = Conv(mid, mid, 3, stride, groups=mid, generator=generator)
        self.project = Conv(mid, cout, 1, generator=generator)

    def forward(self, x):
        h = x if self.expand is None else relu6(self.expand(x))
        h = self.project(relu6(self.depthwise(h)))
        return h + x if self.residual else h


class Dense(nn.Module):
    def __init__(self, cin, cout, generator=None):
        super().__init__()
        self.weight = _param((cout, cin), cin, generator)
        self.bias = _zeros(cout, generator)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class HFNet(nn.Module):
    """The full HF-Net. `HFNet(generator)` draws the reference's He
    initialization (init_params' distributions) from `generator`, on the
    generator's device; `HFNet()` holds meta-device placeholders, which
    `from_state` replaces."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.conv0 = Conv(1, 32, 3, 2, generator=g)
        blocks, cin = [], 32
        for expansion, stride, cout in BLOCKS:
            blocks.append(Block(cin, expansion, stride, cout, generator=g))
            cin = cout
        self.blocks = nn.ModuleList(blocks)
        self.desc0 = Conv(128, DESC_DIM, 3, generator=g)
        self.desc1 = Conv(DESC_DIM, DESC_DIM, 1, generator=g)
        self.det0 = Conv(128, 128, 3, generator=g)
        self.det1 = Conv(128, DETECTOR_GRID ** 2 + 1, 1, generator=g)
        self.vlad_memberships = Conv(GLOBAL_FEAT, N_CLUSTERS, 1, generator=g)
        self.vlad_clusters = _param((N_CLUSTERS, GLOBAL_FEAT), None, g, scale=0.1)
        self.proj = Dense(N_CLUSTERS * GLOBAL_FEAT, GLOBAL_DIM, generator=g)

    @classmethod
    def from_state(cls, state: Mapping[str, torch.Tensor], device=None) -> "HFNet":
        """An HFNet holding `state` (a state_dict of the port's layout) on
        `device` (None means CUDA)."""
        from ..device import resolve

        dev = resolve(device)
        net = cls()
        net.load_state_dict({k: v.to(dev) for k, v in state.items()}, assign=True)
        for p in net.parameters():
            p.requires_grad_(False)
        return net.eval()

    # -- the reference's functions, NHWC at the boundaries --------------------
    def backbone_local(self, image):
        """image: (B,H,W,1) raw grayscale [0,255], H,W multiples of 8.
        Returns (B,H/8,W/8,128): the backbone truncated at the local
        endpoint, all that pyramid levels > 0 need."""
        x = (_nchw(image) - 128.0) / 128.0
        x = relu6(self.conv0(x))
        for blk in self.blocks[: LOCAL_ENDPOINT + 1]:
            x = blk(x)
        return _nhwc(x)

    def backbone(self, image):
        """-> (local_feat (B,H/8,W/8,128), global_feat (B,H/32,W/32,320))."""
        local_feat = self.backbone_local(image)
        x = _nchw(local_feat)
        for blk in self.blocks[LOCAL_ENDPOINT + 1:]:
            x = blk(x)
        return local_feat, _nhwc(x)

    def descriptor_map(self, local_feat):
        """-> desc_map (B,H/8,W/8,256), L2-normalized."""
        return _nhwc(_l2(self.desc1(relu6(self.desc0(_nchw(local_feat)))), 1))

    def detector_logits(self, local_feat):
        """-> the detector's 65-way cell logits (B,65,H/8,W/8), NCHW."""
        return self.det1(relu6(self.det0(_nchw(local_feat))))

    def local_head(self, local_feat):
        """-> (dense_scores (B,H,W), desc_map (B,H/8,W/8,256) L2-normalized)."""
        logits = self.detector_logits(local_feat)
        prob = torch.softmax(logits, dim=1)[:, :-1]  # drop the dustbin
        # depth_to_space(8) in DCR order: out[8h+i, 8w+j] = prob[i*8+j, h, w]
        scores = F.pixel_shuffle(prob, DETECTOR_GRID)[:, 0]
        return scores, self.descriptor_map(local_feat)

    def global_head(self, global_feat, valid_mask=None):
        """NetVLAD + dimensionality reduction -> (B, 4096) L2-normalized.
        valid_mask: optional (B, H/32, W/32) 0/1 mask of valid cells."""
        f = _nchw(global_feat)
        m = torch.softmax(self.vlad_memberships(f), dim=1)  # (B,K,h,w)
        if valid_mask is not None:
            m = m * valid_mask[:, None].to(m.dtype)
        # sum_hw m_k (c_k - f) = c_k sum_hw m_k - sum_hw m_k f
        m_sum = m.sum(dim=(2, 3))  # (B,K)
        mf = m.flatten(2) @ f.flatten(2).transpose(1, 2)  # (B,K,C)
        vlad = self.vlad_clusters[None] * m_sum[..., None] - mf
        vlad = _l2(vlad, 1)  # intra-normalization over the cluster axis
        v = _l2(vlad.flatten(1), -1)
        return _l2(self.proj(v), -1)

    def forward(self, image, with_global: bool = True, valid_mask=None) -> Dict[str, torch.Tensor]:
        """image: (B,H,W,1) grayscale [0,255]; valid_mask: optional (B,H,W).
        Returns scores_dense (B,H,W), desc_map (B,H/8,W/8,256) and, with
        with_global, global_desc (B,4096)."""
        local_feat, global_feat = self.backbone(image)
        scores, desc_map = self.local_head(local_feat)
        out = {"scores_dense": scores, "desc_map": desc_map}
        if with_global:
            gmask = None
            if valid_mask is not None:
                gmask = valid_mask[:, ::32, ::32][:, : global_feat.shape[1], : global_feat.shape[2]]
            out["global_desc"] = self.global_head(global_feat, gmask)
        return out


def fold_bn(w, gamma, beta, mean, var, eps=1e-3):
    """Fold batch-norm stats into a conv (OIHW) or dense (out, in) weight and
    its bias (slim's default eps 1e-3)."""
    scale = gamma / torch.sqrt(var + eps)
    return w * scale.reshape((-1,) + (1,) * (w.ndim - 1)), beta - mean * scale


# ---------------------------------------------------------------------------
# the reference's flat .npz format
# ---------------------------------------------------------------------------

def _port_key(ref_key: str) -> str:
    *path, leaf = ref_key.split("/")
    return ".".join(path + [{"w": "weight", "b": "bias"}.get(leaf, leaf)])


def _to_port(ref_key, a):
    if a.ndim == 4:  # HWIO -> OIHW; a depthwise (3,3,1,mid) becomes (mid,1,3,3)
        return a.transpose(3, 2, 0, 1)
    return a.T if ref_key == "proj/w" else a


def _to_ref(ref_key, a):
    if a.ndim == 4:
        return a.transpose(2, 3, 1, 0)
    return a.T if ref_key == "proj/w" else a


def _ref_keys():
    """{reference key: port key} of every parameter."""
    keys = {}
    for pk in HFNet().state_dict():
        *path, leaf = pk.split(".")
        keys["/".join(path + [{"weight": "w", "bias": "b"}.get(leaf, leaf)])] = pk
    return keys


def state_from_flat(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The reference's flat parameter dict (keys like `blocks/3/expand/w`,
    HWIO arrays) -> a CPU state_dict of the port's layout. A missing or
    extra key raises KeyError, a shape mismatch ValueError."""
    expected = HFNet().state_dict()
    keys = _ref_keys()
    extra = set(flat) - set(keys)
    missing = set(keys) - set(flat)
    if extra or missing:
        raise KeyError(f"HF-Net parameters: missing {sorted(missing)[:4]}, extra {sorted(extra)[:4]}")
    state = {}
    for rk, pk in keys.items():
        a = np.array(flat[rk], np.float32)
        want = _to_ref(rk, np.empty(tuple(expected[pk].shape), np.float32)).shape
        if a.shape != want:
            raise ValueError(f"{rk}: shape {a.shape} != expected {want}")
        state[pk] = torch.from_numpy(np.ascontiguousarray(_to_port(rk, a)))
    return state


def flat_from_state(state: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """A state_dict of the port's layout -> the reference's flat dict."""
    return {rk: np.ascontiguousarray(_to_ref(rk, state[pk].detach().float().cpu().numpy()))
            for rk, pk in _ref_keys().items()}


def load_params(path, device=None) -> HFNet:
    """An HFNet from a .npz written by either package's save_params, on
    `device` (None means CUDA)."""
    with np.load(path) as z:
        return HFNet.from_state(state_from_flat({k: z[k] for k in z.files}), device)


def save_params(path, net: HFNet) -> None:
    """Write the reference's flat .npz (uncompressed: random-like float32
    weights barely compress, and compressing 84M of them takes seconds)."""
    np.savez(path, **flat_from_state(net.state_dict()))
