"""Check kind `track_step`: sampled calls of the fused tracking step
(slam/fused.track_step), with the inputs the program's step received,
against the plain step (reference/tracking.py).

obs_mismatch: the largest share of a step's slots whose final map point
differs; pose_err: the largest absolute difference of an entry of the final
[R | t]. The control recomputes the program's side with TF32 on.
"""
from __future__ import annotations

import torch

from ..harness.check import precision
from ..reference import tracking as RT


def hook(cap, run, feed):
    from hfnet_slam_torch.slam import fused

    return [cap.hook_function(fused, "track_step", "track_step")]


def _ref_track(args, tf32):
    (kind, cam, W, H, R0, t0, m_pos, m_desc, m_normal, m_dmin, m_dmax, m_valid, motion_ids,
     local_ids, xy, desc, octave, mask, z, wz, cfg) = args
    if kind != 0:
        raise ValueError("reference tracking step: pinhole cameras only")
    with precision(tf32):
        return RT.track_step(cam, W, H, R0, t0, m_pos, m_desc, m_normal, m_dmin, m_dmax,
                             m_valid, motion_ids, local_ids, xy, desc, octave, mask, z, wz,
                             cfg._asdict())


def numbers(samples, run, feed, device, control):
    if not samples:
        return {}
    om, pe = 0.0, 0.0
    for args, kw, out in samples:
        ref = _ref_track(args, False)
        if control:
            out = _ref_track(args, True)
        om = max(om, float((out["obs"].long() != ref["obs"].long()).float().mean()))
        pe = max(pe, float(torch.max(torch.abs(out["R"] - ref["R"]))),
                 float(torch.max(torch.abs(out["t"] - ref["t"]))))
    return {"obs_mismatch": om, "pose_err": pe}
