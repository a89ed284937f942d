"""Check kind `ba`: sampled local BAs of the mapper, the problem it built and
its keyframes' poses and points as they stand in the map after the call
(write-back included), against ORB-SLAM3's LocalBundleAdjustment in float64
(reference/ba.py) on the same problem.

ba_excess: the largest share of a sampled local BA's reducible cost that
the program left in the map (reference/ba.excess; the camera's intrinsics
from the configuration), so a skipped or unwritten solve reads 1. It has
no TF32 control. run.detail["ba"] collects each sample's (share, C_in,
C_out, C_ref).
"""
from __future__ import annotations

import torch

from ..harness.check import clone, precision
from ..reference import ba as RB


def hook(cap, run, feed):
    """Wrap the mapper's local BA (LocalMapper.local_ba, its _run_ba, and
    optim/ba.bundle_adjust to see the problem it builds) to offer (problem,
    the problem's keyframe poses and points read back from the map after the
    call). Other BAs (map initialization, global) pass unsampled."""
    from hfnet_slam_torch.optim import ba
    from hfnet_slam_torch.slam.local_mapping import LocalMapper as mapper_cls

    local_ba, run_ba, solve = mapper_cls.local_ba, mapper_cls._run_ba, ba.bundle_adjust
    box = {}

    def bundle_adjust(cam_kind, cam_params, prob, *a, **kw):
        box["in"] = (cam_kind, prob)
        return solve(cam_kind, cam_params, prob, *a, **kw)

    def _local_ba(mapper, *a, **kw):
        box["local"] = True
        try:
            return local_ba(mapper, *a, **kw)
        finally:
            box.clear()

    def _run_ba(mapper, *a, **kw):
        box.pop("in", None)
        out = run_ba(mapper, *a, **kw)
        if out is not None and "in" in box and box.get("local"):
            kind, prob = box.pop("in")
            st = mapper.store

            def make():
                if kind != 0:
                    raise ValueError("reference BA: pinhole cameras only")
                p = {k: clone(v) for k, v in prob._asdict().items()}
                return (p, st.kf_R[out["kf_ids"]].copy(), st.kf_t[out["kf_ids"]].copy(),
                        st.mp_pos[out["mp_ids"]].copy())

            cap.offer("ba", make)
        return out

    ba.bundle_adjust = bundle_adjust
    mapper_cls.local_ba, mapper_cls._run_ba = _local_ba, _run_ba
    return [(ba, "bundle_adjust", solve), (mapper_cls, "_run_ba", run_ba),
            (mapper_cls, "local_ba", local_ba)]


def numbers(samples, run, feed, device, control):
    if not samples or control:
        return {}
    camera = run.config["camera"]
    detail = run.detail.setdefault("ba", [])
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
        detail.append((x,) + costs)
    return {"ba_excess": worst}
