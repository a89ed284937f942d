"""Check kind `gba`: sampled global BAs (LocalMapper.run_global_ba, the
loop correction's GlobalBundleAdjustemnt), the whole map's problem read from
the map before the call and its keyframes' poses and points read back after
it (write-back included), against a float64 global BA on the same problem
(reference/loop.py, reference/ba.py's edge and cost).

gba_excess: the largest share, over the sampled problems, of a problem's
reducible cost that the program left. The problem: every
valid keyframe (the call's fixed ones fixed), every valid point they
observe, and every such observation, with the configuration's intrinsics;
the reference runs the call's rounds. A solve skipped or not written back
reads 1. It has no TF32 control. run.detail["gba"] collects (share, C_in,
C_out, C_ref).
"""
from __future__ import annotations

import numpy as np
import torch

from ..harness.check import precision
from ..reference import loop as RL

SCALE_FACTOR = 1.2   # the pyramid's scale between octaves: sigma^2 = 1.2^(2 octave)


def problem(st, fixed_ids):
    """The whole map's BA problem as numpy arrays, and its point ids."""
    kf_ids = np.nonzero(st.kf_valid)[0]
    obs = st.kf_obs[kf_ids]
    kk, ss = np.nonzero(obs >= 0)
    mp = obs[kk, ss]
    ok = st.mp_valid[mp]
    kk, ss, mp = kk[ok], ss[ok], mp[ok]
    if np.any(st.kf_depth[kf_ids[kk], ss] > 0):
        raise ValueError("reference global BA: monocular edges only")
    mp_ids, pt = np.unique(mp, return_inverse=True)
    return {"kf_ids": kf_ids, "mp_ids": mp_ids, "kf_R": st.kf_R[kf_ids].copy(),
            "kf_t": st.kf_t[kf_ids].copy(), "points": st.mp_pos[mp_ids].copy(),
            "fixed": np.isin(kf_ids, np.asarray(list(fixed_ids), int)),
            "kf": kk, "pt": pt, "uv": st.kf_xy[kf_ids[kk], ss].copy(),
            "s2": SCALE_FACTOR ** (-2.0 * st.kf_octave[kf_ids[kk], ss])}


def hook(cap, run, feed):
    from hfnet_slam_torch.slam.local_mapping import LocalMapper

    gba = LocalMapper.run_global_ba

    def run_global_ba(mapper, fixed_ids, *a, **kw):
        j = cap.claim("gba")
        if j is None:
            return gba(mapper, fixed_ids, *a, **kw)
        st = mapper.store
        prob = problem(st, fixed_ids)
        prob["rounds"] = kw.get("rounds", a[0] if a else ((10, True),))
        try:
            return gba(mapper, fixed_ids, *a, **kw)
        finally:
            cap.put("gba", j, (prob, st.kf_R[prob["kf_ids"]].copy(),
                               st.kf_t[prob["kf_ids"]].copy(), st.mp_pos[prob["mp_ids"]].copy()))

    LocalMapper.run_global_ba = run_global_ba
    return [(LocalMapper, "run_global_ba", gba)]


def numbers(samples, run, feed, device, control):
    if not samples or control:
        return {}
    c = run.config["camera"]
    cam = torch.tensor([c["fx"], c["fy"], c["cx"], c["cy"]], dtype=torch.float64, device=device)
    rows = []
    for prob, R1, t1, P1 in samples:
        p = {k: torch.as_tensor(prob[k], device=device)
             for k in ("kf_R", "kf_t", "points", "fixed", "kf", "pt", "uv", "s2")}
        with precision(False):
            x, costs = RL.gba_excess(cam, p, *(torch.as_tensor(v, device=device)
                                               for v in (R1, t1, P1)), rounds=prob["rounds"])
        rows.append((x,) + costs)
    run.detail.setdefault("gba", []).extend(rows)
    return {"gba_excess": max(r[0] for r in rows)}
