"""The parent commit's check arithmetic (harness/check.py before the checks
moved into slambench/checks/), kept verbatim for the test that the moved
kinds give the same numbers on the same samples."""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from slambench.reference import ba as RB
from slambench.reference import hfnet as RH
from slambench.reference import tracking as RT


@contextlib.contextmanager
def precision(tf32):
    """Matmuls and convolutions in TF32 (`tf32`) or in full float32."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


# ---- the numbers ---------------------------------------------------------------

def extract_numbers(samples, params, ext_cfg, device, control=False):
    """kp_mismatch: the largest share of a frame's slots whose validity or
    position (1e-3 px) differs; desc_err: the largest absolute difference
    of a local descriptor entry on slots valid and placed alike in both;
    gdesc_err: the largest of a global descriptor's."""
    kp, de, ge = 0.0, 0.0, 0.0
    for image, prog in samples:
        img = torch.as_tensor(np.asarray(image), device=device)
        with precision(False):
            ref = RH.extract(params, img, ext_cfg)
        if control:
            with precision(True):
                prog = RH.extract(params, img, ext_cfg)
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


def _ref_track(args, tf32):
    (kind, cam, W, H, R0, t0, m_pos, m_desc, m_normal, m_dmin, m_dmax, m_valid, motion_ids,
     local_ids, xy, desc, octave, mask, z, wz, cfg) = args
    if kind != 0:
        raise ValueError("reference tracking step: pinhole cameras only")
    with precision(tf32):
        return RT.track_step(cam, W, H, R0, t0, m_pos, m_desc, m_normal, m_dmin, m_dmax,
                             m_valid, motion_ids, local_ids, xy, desc, octave, mask, z, wz,
                             cfg._asdict())


def track_numbers(samples, control=False):
    """obs_mismatch: the largest share of a step's slots whose final map
    point differs; pose_err: the largest absolute difference of an entry
    of the final [R | t]."""
    om, pe = 0.0, 0.0
    for args, kw, out in samples:
        ref = _ref_track(args, False)
        if control:
            out = _ref_track(args, True)
        om = max(om, float((out["obs"].long() != ref["obs"].long()).float().mean()))
        pe = max(pe, float(torch.max(torch.abs(out["R"] - ref["R"]))),
                 float(torch.max(torch.abs(out["t"] - ref["t"]))))
    return {"obs_mismatch": om, "pose_err": pe}


def ba_numbers(samples, camera, detail=None):
    """ba_excess: the largest share of a sampled local BA's reducible cost
    that the program left in the map (reference/ba.excess, float64; the
    camera's intrinsics from the configuration). `detail` collects each
    sample's (share, C_in, C_out, C_ref)."""
    worst = 0.0
    for p, R1, t1, P1 in samples:
        dev = p["poses_R"].device
        cam = torch.tensor([camera[k] for k in ("fx", "fy", "cx", "cy")], dtype=torch.float64,
                           device=dev)
        R, t, P = p["poses_R"].clone(), p["poses_t"].clone(), p["points"].clone()
        R[:len(R1)] = torch.as_tensor(R1, device=dev)
        t[:len(t1)] = torch.as_tensor(t1, device=dev)
        P[:len(P1)] = torch.as_tensor(P1, device=dev)
        with precision(False):
            x, costs = RB.excess(cam, p, R, t, P)
        worst = max(worst, x)
        if detail is not None:
            detail.append((x,) + costs)
    return {"ba_excess": worst}
