"""Where the time of one HF-Net pyramid extraction goes, stage by stage, on
the card, beside what each stage could take at best.

    python3 -m hfnet_slam_torch.tools.extract_breakdown [--dtype float32|bfloat16] [--iters N]
        [--depth-multiplier M]

Builds `scenes.euroc_hfnet_system()` (EuRoC 752x480, 1000 features, 4
levels, 1024 slots, random weights from seed 0, HF-Net at width M, default
1.0; the published network is 0.75), extracts a seeded textured
image once, keeps each stage's real inputs, then for every stage (per level:
resize, network forward, NMS, top-K selection, subpixel refinement,
descriptor sampling) and for the whole extraction reports
  * ms: CUDA-event mean over `--iters` back-to-back calls, one sync at the
    end (host enqueue and device work overlap, as in the extractor);
  * device_ms and launches: device kernel time and count of one call under
    torch.profiler;
  * bound_ms / bound_by: the larger of the bytes the stage must move (each
    input read once, each output written once) over 3.35 TB/s and its
    operations over the peak rate of its type (float32 CUDA cores 67
    TFLOP/s; bf16 tensor cores 989 TFLOP/s for the bf16 network);
  * for the forward, the sum over layers of each layer's own traffic
    (unfused activations), and the depthwise convs' share of it;
  * for the whole extraction, also its time when the same launches are
    replayed from one CUDA graph (`graph_ms`): what is left once the host's
    launch cost is gone. The extractor makes no host sync, so it can be
    captured; if capture raises, `graph_error` says why.
Prints one JSON object. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess

import numpy as np
import torch

from .peaks import H100_BF16_FLOPS, H100_BYTES_PER_S, H100_FP32_FLOPS


def forward_cost(h, w, with_global, elem_bytes=4, depth_multiplier=1.0):
    """FLOPs and bytes of HF-Net's forward on one (h,w) image, the backbone
    at `depth_multiplier` (models/hfnet.channel_table).

    Returns dict: flops (2 per multiply-add, over every conv, the NetVLAD
    contractions and the projection), min_bytes (the image, the weights the
    pass uses and the outputs, each once: the least any implementation
    moves), layer_bytes (each layer reading its input and weights and
    writing its output, as an unfused implementation does), and the
    depthwise convs' flops and layer bytes."""
    from ..models.hfnet import (DESC_DIM, GLOBAL_DIM, LOCAL_ENDPOINT, N_CLUSTERS, channel_table,
                                make_divisible)

    c = dict(flops=0.0, layer_bytes=0.0, weight_bytes=0.0, dw_flops=0.0, dw_bytes=0.0)

    def conv(H, W, cin, cout, k, s=1, groups=1, dw=False):
        Ho, Wo = -(-H // s), -(-W // s)
        f = 2.0 * Ho * Wo * cout * k * k * cin / groups
        wb = (k * k * cin // groups * cout + cout) * elem_bytes
        lb = (H * W * cin + Ho * Wo * cout) * elem_bytes + wb
        c["flops"] += f
        c["layer_bytes"] += lb
        c["weight_bytes"] += wb
        if dw:
            c["dw_flops"] += f
            c["dw_bytes"] += lb
        return Ho, Wo

    c0, table = channel_table(depth_multiplier)
    local_c, global_c = table[LOCAL_ENDPOINT][2], table[-1][2]
    H, W = conv(h, w, 1, c0, 3, 2)
    cin = c0
    blocks = table if with_global else table[: LOCAL_ENDPOINT + 1]
    for i, (e, s, cout) in enumerate(blocks):
        mid = cin if e == 1 else make_divisible(cin * e)
        if e != 1:
            conv(H, W, cin, mid, 1)
        Hn, Wn = conv(H, W, mid, mid, 3, s, groups=mid, dw=True)
        conv(Hn, Wn, mid, cout, 1)
        H, W, cin = Hn, Wn, cout
        if i == LOCAL_ENDPOINT:
            lh, lw = H, W
    conv(lh, lw, local_c, DESC_DIM, 3)
    conv(lh, lw, DESC_DIM, DESC_DIM, 1)
    conv(lh, lw, local_c, 128, 3)
    conv(lh, lw, 128, 65, 1)
    out_bytes = (h * w + lh * lw * DESC_DIM) * elem_bytes
    if with_global:
        conv(H, W, global_c, N_CLUSTERS, 1)
        c["flops"] += 2.0 * H * W * N_CLUSTERS * global_c  # sum_hw m f
        kc = N_CLUSTERS * global_c
        c["flops"] += 2.0 * kc * GLOBAL_DIM
        pb = (kc * GLOBAL_DIM + GLOBAL_DIM + kc) * elem_bytes  # projection + clusters
        c["weight_bytes"] += pb
        c["layer_bytes"] += pb
        out_bytes += GLOBAL_DIM * elem_bytes
    c["min_bytes"] = h * w * elem_bytes + c["weight_bytes"] + out_bytes
    return c


def bound(t_ops, t_bytes):
    """(bound ms, what binds) from the operations' and the bytes' ms."""
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _post_bounds(H, W, k, C=256, radius=4):
    """(flops, bytes) of NMS, selection, refinement and sampling of one
    level: NMS runs three separable max pools (2*(2r+1) compares a pixel
    each) and a few elementwise passes; selection sorts the H*W map;
    refinement gathers 5 scores a keypoint; sampling gathers 4 corners of C
    channels a keypoint."""
    n = H * W
    size = 2 * radius + 1
    return {
        "nms": (3 * 2 * size * n + 6 * n, 8.0 * n),
        "select": (n * math.log2(n), 4.0 * n + 16.0 * k),
        "refine": (20.0 * k, 8.0 * k + 20.0 * k + 8.0 * k),
        "sample": (4 * 3 * C * k, 8.0 * k + 4 * 4.0 * C * k + 4.0 * C * k),
    }


def _profile(fn):
    """(device kernel ms, launches) of one call of fn under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.self_device_time_total for e in dev) / 1e3, sum(e.count for e in dev)


def _events_ms(fn, iters):
    for _ in range(3):
        fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def graph_ms(fn, iters):
    """CUDA-event mean ms of fn replayed from one captured CUDA graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream, as capture needs
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return _events_ms(graph.replay, iters)


def breakdown(ext, image, iters=20):
    """Stage table of `ext` (an HFExtractor on CUDA) on one image."""
    from ..models import extractor as E
    from ..ops import extract as X

    peak = H100_BF16_FLOPS if ext.dtype == torch.bfloat16 else H100_FP32_FLOPS
    eb = 2 if ext.dtype == torch.bfloat16 else 4
    img = torch.as_tensor(image).to(ext.device).float()
    rows = []

    def add(name, fn, flops, nbytes, peak_flops=H100_FP32_FLOPS, **extra):
        with torch.inference_mode():
            ms = _events_ms(fn, iters)
            dev_ms, launches = _profile(fn)
        t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / H100_BYTES_PER_S * 1e3
        b, by = bound(t_ops, t_bytes)
        rows.append({"stage": name, "ms": ms, "device_ms": dev_ms, "launches": launches,
                     "bound_ms": b, "bound_by": by, "flops": flops, "bytes": nbytes,
                     "ops_ms": t_ops, **extra})

    with torch.inference_mode():
        H, W = ext.image_hw
        for lvl, (h, w) in enumerate(ext.level_hw):
            if lvl:
                add(f"L{lvl} resize", lambda h=h, w=w: E.resize(img, (h, w)),
                    14.0 * h * w, 4.0 * (H * W + h * w))
            lv = (E.resize(img, (h, w)) if lvl else img)[None, :, :, None].to(ext.dtype)
            if lvl == 0:
                def fwd(lv=lv):
                    return ext.net(lv, with_global=True)
            else:
                def fwd(lv=lv):
                    return ext.net.local_head(ext.net.backbone_local(lv))
            cost = forward_cost(h, w, lvl == 0, eb, ext.net.depth_multiplier)
            add(f"L{lvl} forward", fwd, cost["flops"], cost["min_bytes"], peak,
                layer_bytes=cost["layer_bytes"], depthwise_flops=cost["dw_flops"],
                depthwise_layer_bytes=cost["dw_bytes"],
                layer_bytes_bound_ms=cost["layer_bytes"] / H100_BYTES_PER_S * 1e3)
            out = fwd()
            scores_dense, desc_map = ((out["scores_dense"], out["desc_map"]) if lvl == 0
                                      else out)
            raw = scores_dense.float()
            k = max(int(ext.budgets[lvl]), 1)
            pb = _post_bounds(h, w, k)
            nms = X.simple_nms(raw, ext.nms_radius)[0]
            xy, _, _ = X.select_keypoints(nms, None, ext.threshold, k)
            xy_r = X.refine_subpixel(raw[0], xy)
            dm = desc_map[0].float()
            add(f"L{lvl} nms", lambda raw=raw: X.simple_nms(raw, ext.nms_radius), *pb["nms"])
            add(f"L{lvl} select", lambda nms=nms, k=k: X.select_keypoints(
                nms, None, ext.threshold, k), *pb["select"])
            add(f"L{lvl} refine", lambda raw=raw, xy=xy: X.refine_subpixel(raw[0], xy),
                *pb["refine"])
            add(f"L{lvl} sample", lambda dm=dm, xy=xy_r, hw=(h, w): X.sample_descriptors(
                dm, xy, hw), *pb["sample"])
    # the whole function: its operations at each stage's rate; its bytes are
    # the image, every weight and the padded record, once
    t_ops = sum(r["ops_ms"] for r in rows)
    n = ext.pad_to
    weights = forward_cost(H, W, True, eb, ext.net.depth_multiplier)["weight_bytes"]
    nbytes = (4.0 * H * W + weights
              + n * (8 + 4 + 4 + 4 * 256 + 1) + 4 * 4096)
    with torch.inference_mode():
        ms = _events_ms(lambda: ext(img), iters)
        dev_ms, launches = _profile(lambda: ext(img))
    b, by = bound(t_ops, nbytes / H100_BYTES_PER_S * 1e3)
    whole = {"stage": "whole extraction", "ms": ms, "device_ms": dev_ms,
             "launches": launches, "bound_ms": b, "bound_by": by,
             "flops": sum(r["flops"] for r in rows), "bytes": nbytes, "ops_ms": t_ops,
             "stages_ms_sum": sum(r["ms"] for r in rows)}
    try:
        with torch.inference_mode():
            whole["graph_ms"] = graph_ms(lambda: ext._extract(img), iters)
    except RuntimeError as e:  # a capture the extractor's ops refuse
        whole["graph_error"] = str(e)[:300]
    rows.append(whole)
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--depth-multiplier", type=float, default=1.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("extract_breakdown: needs a CUDA card")
    from ..scenes import euroc_hfnet_system, textured_image

    sys_ = euroc_hfnet_system(dtype=getattr(torch, args.dtype),
                              depth_multiplier=args.depth_multiplier)
    ext = sys_.extractor
    image = textured_image(np.random.default_rng(0), *ext.image_hw)
    rows = breakdown(ext, image, args.iters)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(json.dumps({"card": smi, "dtype": args.dtype,
                      "depth_multiplier": args.depth_multiplier, "image_hw": list(ext.image_hw),
                      "level_hw": ext.level_hw, "budgets": ext.budgets, "stages": rows}))


if __name__ == "__main__":
    main()
