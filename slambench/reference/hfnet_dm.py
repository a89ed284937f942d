"""Plain HF-Net at any backbone width: the forward pass and the keypoint
extraction of one image, as functions of a parameter dict and the width
(`depth_multiplier`).

Written from HF-Net (arXiv:1812.03506: a MobileNetV2 backbone at depth
multiplier 0.75, SuperPoint's detector and descriptor heads on the stride-8
feature, NetVLAD with 64 clusters and a 4096-d projection on the last one)
and TF-slim's width rule; the block table is hf_net.py's MOBILENET_DEF as
reference/hfnet.py holds it (BLOCKS, at 1.0). The width-free parts (SAME
padding, the heads' convolutions, NMS, top-K, refinement, descriptor
sampling, the pyramid's shapes and budgets) are reference/hfnet.py's, which
this file imports; the parts that depend on the width are written out here.
It imports no module of the program.

Parameter names follow the port's state_dict layout (`conv0.weight`,
`blocks.3.expand.weight`, `proj.weight`, ...), dense convs OIHW and
depthwise convs (mid,1,3,3). Departures from the paper's network, each
also noted at its line: batch norm is folded into every conv (the
inference form); the NetVLAD projection is a dense layer with a bias.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import hfnet as R

BLOCKS = R.BLOCKS          # (expansion, stride, out_channels) of layers 2..18 at 1.0
CONV0 = 32                 # layer_1's channels at 1.0
LOCAL_ENDPOINT = R.LOCAL_ENDPOINT
DESC_DIM, DETECTOR_GRID, N_CLUSTERS, GLOBAL_DIM = (R.DESC_DIM, R.DETECTOR_GRID, R.N_CLUSTERS,
                                                   R.GLOBAL_DIM)
DETECTOR_DIM = 128         # the detector head's hidden width, not multiplied

# The published width's table, written out: conv0, then layer_2..layer_18's
# outputs at 0.75 (make_divisible(c * 0.75)); `channels(0.75)` gives it.
CHANNELS_075 = (24, [16, 24, 24, 24, 48, 96, 48, 48, 48, 48, 72, 72, 72, 120, 120, 120, 240])


def make_divisible(v, divisor=8, min_value=None):
    """TF-slim's `_make_divisible` (mobilenet/conv_blocks.py): v to the
    nearest multiple of `divisor`, at least `min_value` (default
    `divisor`), one more step where rounding lost over 10%."""
    min_value = divisor if min_value is None else min_value
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    return new_v + divisor if new_v < 0.9 * v else new_v


def channels(depth_multiplier):
    """(conv0's channels, [each block's output channels]) at the width:
    slim's depth_multiplier op on every layer of the backbone. The heads
    are defined outside the backbone's scope and keep their sizes."""
    m = float(depth_multiplier)
    return make_divisible(CONV0 * m), [make_divisible(c * m) for _, _, c in BLOCKS]


def table(depth_multiplier):
    """[(cin, mid, stride, cout)] of every block: mid is slim's
    expand_input_by_factor, cin for the first block (expansion 1, divisible
    by 1), make_divisible(cin * 6) for the others."""
    c0, outs = channels(depth_multiplier)
    rows, cin = [], c0
    for (e, s, _), cout in zip(BLOCKS, outs):
        rows.append((cin, cin if e == 1 else make_divisible(cin * e), s, cout))
        cin = cout
    return rows


def param_shapes(depth_multiplier):
    """{name: (shape, fan_in)} of every parameter in creation order; biases
    and the NetVLAD clusters have fan_in None (zeros and 0.1-normal)."""
    out = {}

    def conv(name, cin, cout, k, groups=1):
        out[f"{name}.weight"] = ((cout, cin // groups, k, k), k * k * cin // groups)
        out[f"{name}.bias"] = ((cout,), None)

    c0, _ = channels(depth_multiplier)
    rows = table(depth_multiplier)
    conv("conv0", 1, c0, 3)
    for i, (cin, mid, _, cout) in enumerate(rows):
        if BLOCKS[i][0] != 1:
            conv(f"blocks.{i}.expand", cin, mid, 1)
        conv(f"blocks.{i}.depthwise", mid, mid, 3, groups=mid)
        conv(f"blocks.{i}.project", mid, cout, 1)
    local_c, global_c = rows[LOCAL_ENDPOINT][3], rows[-1][3]
    conv("desc0", local_c, DESC_DIM, 3)
    conv("desc1", DESC_DIM, DESC_DIM, 1)
    conv("det0", local_c, DETECTOR_DIM, 3)
    conv("det1", DETECTOR_DIM, DETECTOR_GRID ** 2 + 1, 1)
    conv("vlad_memberships", global_c, N_CLUSTERS, 1)
    out["vlad_clusters"] = ((N_CLUSTERS, global_c), None)
    # departure: the paper's dimensionality reduction, as a dense layer with a bias
    out["proj.weight"] = ((GLOBAL_DIM, N_CLUSTERS * global_c), N_CLUSTERS * global_c)
    out["proj.bias"] = ((GLOBAL_DIM,), None)
    return out


def block(p, i, x, row):
    """MobileNetV2's expanded block `i` (its `table` row): 1x1 expand unless
    the expansion is 1, 3x3 depthwise, 1x1 linear projection; the residual
    where stride 1 keeps the width. Departure: each conv carries its batch
    norm folded into weight and bias."""
    cin, _, s, cout = row
    h = x if BLOCKS[i][0] == 1 else R.relu6(R.conv(p, f"blocks.{i}.expand", x))
    h = R.relu6(R.conv(p, f"blocks.{i}.depthwise", h, s, groups=h.shape[1]))
    h = R.conv(p, f"blocks.{i}.project", h)
    return h + x if (s == 1 and cin == cout) else h


def backbone_local(p, image, depth_multiplier):
    """(B,1,H,W) raw grey [0,255] -> (B,C,H/8,W/8) local features, C the
    local endpoint's width (96 at 0.75)."""
    rows = table(depth_multiplier)
    x = R.relu6(R.conv(p, "conv0", (image - 128.0) / 128.0, 2))
    for i in range(LOCAL_ENDPOINT + 1):
        x = block(p, i, x, rows[i])
    return x


def global_desc(p, lf, depth_multiplier):
    """The backbone's tail to layer_18, NetVLAD (intra-normalized over the
    cluster axis) and the 4096-d projection -> (B,4096), L2-normalized."""
    rows = table(depth_multiplier)
    x = lf
    for i in range(LOCAL_ENDPOINT + 1, len(BLOCKS)):
        x = block(p, i, x, rows[i])
    m = torch.softmax(R.conv(p, "vlad_memberships", x), dim=1)
    mf = m.flatten(2) @ x.flatten(2).transpose(1, 2)
    vlad = p["vlad_clusters"][None] * m.sum(dim=(2, 3))[..., None] - mf
    v = R._l2(R._l2(vlad, 1).flatten(1), -1)
    return R._l2(F.linear(v, p["proj.weight"], p["proj.bias"]), -1)


def forward(p, image, depth_multiplier, with_global=True):
    """One (B,1,H,W) image batch -> dict scores_dense (B,H,W), desc_map
    (B,256,H/8,W/8) and, with_global, global_desc (B,4096)."""
    lf = backbone_local(p, image, depth_multiplier)
    out = {"scores_dense": R.dense_scores(p, lf), "desc_map": R.descriptor_map(p, lf)}
    if with_global:
        out["global_desc"] = global_desc(p, lf, depth_multiplier)
    return out


@torch.no_grad()
def extract(p, image, ext, depth_multiplier):
    """Keypoints of one (H,W) grey image in [0,255] under the extractor
    settings `ext` (n_features, n_levels, scale_factor, threshold, pad_to,
    nms_radius), as reference/hfnet.extract does it, with the network at
    `depth_multiplier`. Returns dict xy (N,2), score, octave, desc (N,256),
    mask, global_desc (4096,), N = pad_to."""
    dev = image.device
    H, W = (image.shape[0] // 8) * 8, (image.shape[1] // 8) * 8
    image = image[:H, :W].to(torch.float32)
    shapes = R.level_shapes((H, W), ext["n_levels"], ext["scale_factor"])
    budgets = R.level_budgets(ext["n_features"], ext["scale_factor"], ext["n_levels"])
    xs, ss, os_, ds, ms = [], [], [], [], []
    g = None
    for lvl, (h, w) in enumerate(shapes):
        lv = R.resize(image, (h, w)) if lvl else image
        lf = backbone_local(p, lv[None, None], depth_multiplier)
        if lvl == 0:
            g = global_desc(p, lf, depth_multiplier)[0]
        raw = R.dense_scores(p, lf)
        dm = R.descriptor_map(p, lf)[0]
        k = max(int(budgets[lvl]), 1)
        xy, sc, mk = R.select(R.simple_nms(raw, ext.get("nms_radius", 4))[0], ext["threshold"], k)
        xy = R.refine(raw[0], xy)
        ds.append(R.sample(dm, xy, (h, w)))
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


def forward_cost(h, w, with_global, depth_multiplier=1.0, elem_bytes=4):
    """FLOPs (2 per multiply-add over every conv, the NetVLAD contraction and
    the projection) and least bytes (the image, the weights used and the
    outputs, each once) of one forward on an (h,w) image at the width: the
    backbone to the local endpoint and both local heads, with the tail,
    NetVLAD and the projection when `with_global`. At 1.0 the counts of
    reference/hfnet.forward_cost."""
    c = {"flops": 0.0, "weight_bytes": 0.0}

    def cv(H, W, cin, cout, k, s=1, groups=1):
        Ho, Wo = -(-H // s), -(-W // s)
        c["flops"] += 2.0 * Ho * Wo * cout * k * k * cin / groups
        c["weight_bytes"] += (k * k * cin // groups * cout + cout) * elem_bytes
        return Ho, Wo

    c0, _ = channels(depth_multiplier)
    rows = table(depth_multiplier)
    H, W = cv(h, w, 1, c0, 3, 2)
    lh = lw = None
    for i, (cin, mid, s, cout) in enumerate(rows if with_global else rows[:LOCAL_ENDPOINT + 1]):
        if BLOCKS[i][0] != 1:
            cv(H, W, cin, mid, 1)
        H, W = cv(H, W, mid, mid, 3, s, groups=mid)
        cv(H, W, mid, cout, 1)
        if i == LOCAL_ENDPOINT:
            lh, lw = H, W
    local_c, global_c = rows[LOCAL_ENDPOINT][3], rows[-1][3]
    cv(lh, lw, local_c, DESC_DIM, 3)
    cv(lh, lw, DESC_DIM, DESC_DIM, 1)
    cv(lh, lw, local_c, DETECTOR_DIM, 3)
    cv(lh, lw, DETECTOR_DIM, DETECTOR_GRID ** 2 + 1, 1)
    out_bytes = (h * w + lh * lw * DESC_DIM) * elem_bytes
    if with_global:
        cv(H, W, global_c, N_CLUSTERS, 1)
        kc = N_CLUSTERS * global_c
        c["flops"] += 2.0 * H * W * kc + 2.0 * kc * GLOBAL_DIM
        c["weight_bytes"] += (kc * GLOBAL_DIM + GLOBAL_DIM + kc) * elem_bytes
        out_bytes += GLOBAL_DIM * elem_bytes
    c["min_bytes"] = h * w * elem_bytes + c["weight_bytes"] + out_bytes
    return c


def frame_cost(image_hw, ext, depth_multiplier):
    """forward_cost summed over the extractor's pyramid: level 0 with the
    global head, the other levels' local branch."""
    shapes = R.level_shapes(image_hw, ext["n_levels"], ext["scale_factor"])
    per = [forward_cost(h, w, i == 0, depth_multiplier) for i, (h, w) in enumerate(shapes)]
    return {k: sum(c[k] for c in per) for k in ("flops", "weight_bytes", "min_bytes")}
