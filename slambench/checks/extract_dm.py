"""Check kind `extract_dm`: the extractor's features of sampled frames, with
the frame's image, against the plain HF-Net at the configuration's width
(reference/hfnet_dm.py, the feed's `depth_multiplier`) on the same weights.

The numbers and their definitions are the `extract` kind's: kp_mismatch,
the largest share of a frame's slots whose validity or position (1e-3 px)
differs; desc_err, the largest absolute difference of a local descriptor
entry on slots valid and placed alike in both; gdesc_err, the largest of a
global descriptor's. The control recomputes the program's side with TF32
on. A feed with no width gives no numbers, which fails the check.
"""
from __future__ import annotations

import numpy as np
import torch

from ..harness.check import clone, precision
from ..reference import hfnet_dm as RD

KIND = "extract_dm"


def hook(cap, run, feed):
    """Wrap each episode's system.extractor (a callable object) as the feed
    attaches it, to offer (image, features) pairs."""
    attach = feed.attach

    def attach_hooked(system, spans):
        attach(system, spans)
        ext = system.extractor

        class Hooked:
            def __getattr__(self, name):
                return getattr(ext, name)

            def __call__(self, image):
                out = ext(image)
                cap.offer(KIND, lambda: (image, clone(tuple(out))))
                return out

        system.extractor = Hooked()

    feed.attach = attach_hooked
    return [(feed, "attach", attach)]


def numbers(samples, run, feed, device, control):
    m = getattr(feed, "depth_multiplier", None)
    if not samples or m is None:
        return {}
    params, ext_cfg = feed.ref_params, feed.ref_extractor
    kp, de, ge = 0.0, 0.0, 0.0
    for image, prog in samples:
        img = torch.as_tensor(np.asarray(image), device=device)
        with precision(False):
            ref = RD.extract(params, img, ext_cfg, m)
        if control:
            with precision(True):
                prog = RD.extract(params, img, ext_cfg, m)
            prog = tuple(prog[k] for k in ("xy", "score", "octave", "desc", "mask",
                                           "global_desc"))
        xy, _, _, desc, mask, g = prog
        both = mask & ref["mask"]
        near = torch.max(torch.abs(xy - ref["xy"]), -1).values <= 1e-3
        bad = (mask != ref["mask"]) | (both & ~near)
        kp = max(kp, float(bad.float().mean()))
        ok = both & near
        if bool(ok.any()):
            de = max(de, float(torch.max(torch.abs(desc[ok] - ref["desc"][ok]))))
        ge = max(ge, float(torch.max(torch.abs(g.float() - ref["global_desc"]))))
    return {"kp_mismatch": kp, "desc_err": de, "gdesc_err": ge}
