"""Plain HF-Net: the forward pass and the keypoint extraction of one image,
written from the architecture, as functions of a parameter dict.

Frozen copy (commit 27c9911) of the arithmetic of the port's
models/hfnet.py (MobileNetV2 backbone to the local endpoint, the detector
and descriptor heads, the stride-32 tail, NetVLAD and its 4096-d
projection), models/extractor.py (the pyramid) and ops/extract.py (NMS,
top-K, subpixel refinement, bilinear descriptor sampling). It imports no
module of the program: the benchmark makes the parameters, hands the same
dict to the program and to this file, and compares what the two extract.

Parameter names follow the port's state_dict layout (`conv0.weight`,
`blocks.3.expand.weight`, `proj.weight`, ...), dense convs OIHW and
depthwise convs (mid,1,3,3); batch norm is folded into every conv.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# (expansion, stride, out_channels) of MobileNetV2's layers 2..18
BLOCKS = [
    (1, 1, 16), (6, 2, 24), (6, 1, 24), (6, 2, 32), (6, 1, 64), (6, 1, 128),
    (6, 2, 64), (6, 1, 64), (6, 1, 64), (6, 1, 64), (6, 1, 96), (6, 1, 96),
    (6, 1, 96), (6, 2, 160), (6, 1, 160), (6, 1, 160), (6, 1, 320),
]
LOCAL_ENDPOINT = 5  # the block whose output feeds the local heads
DESC_DIM = 256
DETECTOR_GRID = 8
N_CLUSTERS = 64
GLOBAL_DIM = 4096
GLOBAL_FEAT = 320


def param_shapes():
    """{name: (shape, fan_in)} of every parameter, in creation order; biases
    and the NetVLAD clusters have fan_in None (zeros and 0.1-normal)."""
    out = {}

    def conv(name, cin, cout, k, groups=1):
        out[f"{name}.weight"] = ((cout, cin // groups, k, k), k * k * cin // groups)
        out[f"{name}.bias"] = ((cout,), None)

    conv("conv0", 1, 32, 3)
    cin = 32
    for i, (e, _, cout) in enumerate(BLOCKS):
        mid = cin * e
        if e != 1:
            conv(f"blocks.{i}.expand", cin, mid, 1)
        conv(f"blocks.{i}.depthwise", mid, mid, 3, groups=mid)
        conv(f"blocks.{i}.project", mid, cout, 1)
        cin = cout
    conv("desc0", 128, DESC_DIM, 3)
    conv("desc1", DESC_DIM, DESC_DIM, 1)
    conv("det0", 128, 128, 3)
    conv("det1", 128, DETECTOR_GRID ** 2 + 1, 1)
    conv("vlad_memberships", GLOBAL_FEAT, N_CLUSTERS, 1)
    out["vlad_clusters"] = ((N_CLUSTERS, GLOBAL_FEAT), None)
    out["proj.weight"] = ((GLOBAL_DIM, N_CLUSTERS * GLOBAL_FEAT), N_CLUSTERS * GLOBAL_FEAT)
    out["proj.bias"] = ((GLOBAL_DIM,), None)
    return out


def same_pad(n, k, s):
    """(low, high) padding of XLA's 'SAME' rule (low = total // 2)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def relu6(x):
    y = torch.clamp(x, 0.0, 6.0)
    if not x.requires_grad:
        return y
    # half the gradient at exactly 0 and 6, as the original jnp.clip passes
    return 0.5 * (y + F.hardtanh(x, 0.0, 6.0))


def _l2(x, dim):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=dim, keepdim=True), min=1e-12)


def conv(p, name, x, stride=1, groups=1):
    w, b = p[f"{name}.weight"], p[f"{name}.bias"]
    k = w.shape[-1]
    if k == 1 and stride == 1:
        return F.conv2d(x, w, b)
    top, bottom = same_pad(x.shape[-2], k, stride)
    left, right = same_pad(x.shape[-1], k, stride)
    if top == bottom and left == right:
        return F.conv2d(x, w, b, stride, (top, left), 1, groups)
    return F.conv2d(F.pad(x, (left, right, top, bottom)), w, b, stride, 0, 1, groups)


def block(p, i, x):
    e, s, cout = BLOCKS[i]
    cin = x.shape[1]
    h = x if e == 1 else relu6(conv(p, f"blocks.{i}.expand", x))
    h = relu6(conv(p, f"blocks.{i}.depthwise", h, s, groups=h.shape[1]))
    h = conv(p, f"blocks.{i}.project", h)
    return h + x if (s == 1 and cin == cout) else h


def backbone_local(p, image):
    """(B,1,H,W) raw grey [0,255] -> (B,128,H/8,W/8) local features."""
    x = relu6(conv(p, "conv0", (image - 128.0) / 128.0, 2))
    for i in range(LOCAL_ENDPOINT + 1):
        x = block(p, i, x)
    return x


def descriptor_map(p, lf):
    """-> (B,256,H/8,W/8), L2-normalized over channels."""
    return _l2(conv(p, "desc1", relu6(conv(p, "desc0", lf))), 1)


def detector_logits(p, lf):
    return conv(p, "det1", relu6(conv(p, "det0", lf)))


def dense_scores(p, lf):
    """Softmax over the 65 cell classes, dustbin dropped, depth_to_space(8)."""
    prob = torch.softmax(detector_logits(p, lf), dim=1)[:, :-1]
    return F.pixel_shuffle(prob, DETECTOR_GRID)[:, 0]


def global_desc(p, lf):
    """Backbone tail, NetVLAD (intra-normalized over the cluster axis) and
    the 4096-d projection -> (B,4096), L2-normalized."""
    x = lf
    for i in range(LOCAL_ENDPOINT + 1, len(BLOCKS)):
        x = block(p, i, x)
    m = torch.softmax(conv(p, "vlad_memberships", x), dim=1)
    mf = m.flatten(2) @ x.flatten(2).transpose(1, 2)
    vlad = p["vlad_clusters"][None] * m.sum(dim=(2, 3))[..., None] - mf
    v = _l2(_l2(vlad, 1).flatten(1), -1)
    return _l2(F.linear(v, p["proj.weight"], p["proj.bias"]), -1)


# ---------------------------------------------------------------------------
# extraction
# ---------------------------------------------------------------------------

def level_budgets(n_features, scale_factor, n_levels):
    """Geometric split of the keypoint budget over the pyramid levels."""
    inv = 1.0 / scale_factor
    n_desired = n_features * (1 - inv) / (1 - inv ** n_levels)
    out, acc = [], 0
    for _ in range(n_levels - 1):
        b = int(round(n_desired))
        out.append(b)
        acc += b
        n_desired *= inv
    out.append(max(n_features - acc, 0))
    return out


def level_shapes(image_hw, n_levels, scale_factor):
    """Each pyramid level's (h, w): the image scaled by 1/scale^l, cropped
    to multiples of 8."""
    H, W = image_hw
    return [(max(int(round(H / scale_factor ** i)) // 8 * 8, 8),
             max(int(round(W / scale_factor ** i)) // 8 * 8, 8)) for i in range(n_levels)]


def simple_nms(scores, radius):
    """Two rounds of max-pool non-maximum suppression, (B,H,W)."""
    def pool(x):
        return F.max_pool2d(x, 2 * radius + 1, stride=1, padding=radius)

    zeros = torch.zeros_like(scores)
    max_mask = scores == pool(scores)
    supp = pool(max_mask.to(scores.dtype)) > 0
    supp_scores = torch.where(supp, zeros, scores)
    max_mask = max_mask | ((supp_scores == pool(supp_scores)) & ~supp)
    return torch.where(max_mask, scores, zeros)


def select(scores, threshold, k):
    """Top-k of a (H,W) map by a stable descending sort (lower flat index
    first on ties) -> (xy, score, mask)."""
    W = scores.shape[1]
    vals, idx = torch.sort(scores.reshape(-1), descending=True, stable=True)
    vals, idx = vals[:k], idx[:k]
    xy = torch.stack([idx % W, idx // W], -1).to(torch.float32)
    mask = vals >= threshold
    return xy, torch.where(mask, vals, 0.0), mask


def refine(scores, xy):
    """Quadratic vertex of three taps per axis on the raw map, clamped to
    +-0.5 px; border keypoints stay."""
    H, W = scores.shape
    xi, yi = xy[:, 0].long(), xy[:, 1].long()

    def at(yy, xx):
        return scores[yy.clamp(0, H - 1), xx.clamp(0, W - 1)]

    s0 = at(yi, xi)
    sxm, sxp, sym, syp = at(yi, xi - 1), at(yi, xi + 1), at(yi - 1, xi), at(yi + 1, xi)
    denx, deny = sxm - 2.0 * s0 + sxp, sym - 2.0 * s0 + syp
    dx = torch.where(denx.abs() > 1e-9, 0.5 * (sxm - sxp) / denx, 0.0).clamp(-0.5, 0.5)
    dy = torch.where(deny.abs() > 1e-9, 0.5 * (sym - syp) / deny, 0.0).clamp(-0.5, 0.5)
    edge = (xi <= 0) | (xi >= W - 1) | (yi <= 0) | (yi >= H - 1)
    return xy + torch.where(edge[:, None], 0.0, torch.stack([dx, dy], -1))


def sample(desc_map, xy, img_hw):
    """Bilinear descriptor at each keypoint (align-corners mapping of the
    image onto the (C,h,w) map, zero outside), L2-normalized."""
    C, h, w = desc_map.shape
    H, W = img_hw
    x = xy[:, 0] * ((w - 1.0) / (W - 1.0))
    y = xy[:, 1] * ((h - 1.0) / (H - 1.0))
    fx, fy = torch.floor(x), torch.floor(y)
    cx, cy = fx + 1, fy + 1
    dx, dy = cx - x, cy - y

    def gather(ix, iy):
        inb = (ix >= 0) & (ix <= w - 1) & (iy >= 0) & (iy <= h - 1)
        v = desc_map[:, iy.clamp(0, h - 1).long(), ix.clamp(0, w - 1).long()].T
        return v * inb[:, None]

    out = ((dx * dy)[:, None] * gather(fx, fy) + ((1 - dx) * (1 - dy))[:, None] * gather(cx, cy)
           + (dx * (1 - dy))[:, None] * gather(fx, cy) + ((1 - dx) * dy)[:, None] * gather(cx, fy))
    return _l2(out, -1)


def resize(image, hw):
    """Bilinear, half-pixel centres, antialiased when it shrinks."""
    return F.interpolate(image[None, None], size=tuple(hw), mode="bilinear",
                         align_corners=False, antialias=True)[0, 0]


@torch.no_grad()
def extract(p, image, ext):
    """Keypoints of one (H,W) grey image in [0,255] under the extractor
    settings `ext` (n_features, n_levels, scale_factor, threshold, pad_to,
    nms_radius). Returns dict xy (N,2), score, octave, desc (N,256), mask,
    global_desc (4096,), N = pad_to."""
    dev = image.device
    H, W = (image.shape[0] // 8) * 8, (image.shape[1] // 8) * 8
    image = image[:H, :W].to(torch.float32)
    shapes = level_shapes((H, W), ext["n_levels"], ext["scale_factor"])
    budgets = level_budgets(ext["n_features"], ext["scale_factor"], ext["n_levels"])
    xs, ss, os_, ds, ms = [], [], [], [], []
    g = None
    for lvl, (h, w) in enumerate(shapes):
        lv = resize(image, (h, w)) if lvl else image
        lf = backbone_local(p, lv[None, None])
        if lvl == 0:
            g = global_desc(p, lf)[0]
        raw = dense_scores(p, lf)
        dm = descriptor_map(p, lf)[0]
        k = max(int(budgets[lvl]), 1)
        xy, sc, mk = select(simple_nms(raw, ext.get("nms_radius", 4))[0], ext["threshold"], k)
        xy = refine(raw[0], xy)
        ds.append(sample(dm, xy, (h, w)))
        xs.append(xy * ext["scale_factor"] ** lvl)
        ss.append(sc)
        ms.append(mk)
        os_.append(torch.full((k,), lvl, dtype=torch.int32, device=dev))
    pad = ext["pad_to"] - sum(len(s) for s in ss)
    if pad:
        xs.append(torch.zeros((pad, 2), device=dev))
        ss.append(torch.zeros(pad, device=dev))
        os_.append(torch.zeros(pad, dtype=torch.int32, device=dev))
        ds.append(torch.zeros((pad, DESC_DIM), device=dev))
        ms.append(torch.zeros(pad, dtype=torch.bool, device=dev))
    score = torch.cat(ss)
    return {"xy": torch.cat(xs), "score": score, "octave": torch.cat(os_),
            "desc": torch.cat(ds), "mask": torch.cat(ms) & (score > 0), "global_desc": g}


def forward_cost(h, w, with_global, elem_bytes=4):
    """FLOPs (2 per multiply-add over every conv, the NetVLAD contraction and
    the projection) and least bytes (the image, the weights used and the
    outputs, each once) of one forward on an (h,w) image: the backbone to
    the local endpoint and both local heads, with the tail, NetVLAD and
    the projection when `with_global`. The arithmetic of the port's
    tools/extract_breakdown.forward_cost."""
    c = {"flops": 0.0, "weight_bytes": 0.0}

    def cv(H, W, cin, cout, k, s=1, groups=1):
        Ho, Wo = -(-H // s), -(-W // s)
        c["flops"] += 2.0 * Ho * Wo * cout * k * k * cin / groups
        c["weight_bytes"] += (k * k * cin // groups * cout + cout) * elem_bytes
        return Ho, Wo

    H, W = cv(h, w, 1, 32, 3, 2)
    cin = 32
    blocks = BLOCKS if with_global else BLOCKS[: LOCAL_ENDPOINT + 1]
    lh = lw = None
    for i, (e, s, cout) in enumerate(blocks):
        mid = cin * e
        if e != 1:
            cv(H, W, cin, mid, 1)
        Hn, Wn = cv(H, W, mid, mid, 3, s, groups=mid)
        cv(Hn, Wn, mid, cout, 1)
        H, W, cin = Hn, Wn, cout
        if i == LOCAL_ENDPOINT:
            lh, lw = H, W
    cv(lh, lw, 128, DESC_DIM, 3)
    cv(lh, lw, DESC_DIM, DESC_DIM, 1)
    cv(lh, lw, 128, 128, 3)
    cv(lh, lw, 128, DETECTOR_GRID ** 2 + 1, 1)
    out_bytes = (h * w + lh * lw * DESC_DIM) * elem_bytes
    if with_global:
        cv(H, W, GLOBAL_FEAT, N_CLUSTERS, 1)
        kc = N_CLUSTERS * GLOBAL_FEAT
        c["flops"] += 2.0 * H * W * kc + 2.0 * kc * GLOBAL_DIM
        c["weight_bytes"] += (kc * GLOBAL_DIM + GLOBAL_DIM + kc) * elem_bytes
        out_bytes += GLOBAL_DIM * elem_bytes
    c["min_bytes"] = h * w * elem_bytes + c["weight_bytes"] + out_bytes
    return c


def he_std(fan_in):
    return math.sqrt(2.0 / fan_in)
