"""Check kind `sim3`: sampled calls of the loop closer's Sim3 refinement
(optim/sim3.optimize_sim3, Optimizer::OptimizeSim3: after the RANSAC of a
loop candidate and in the refinement from the last keyframe), with their
inputs, against a float64 minimizer of the same cost (reference/loop.py).

sim3_excess: the largest share, over the sampled calls, of a call's
reducible cost that the program's Sim3 left. The cost is the bidirectional
Huber reprojection cost (delta^2 = the call's chi2 threshold) on the
program's final inlier set, with the configuration's intrinsics; the
reference minimizes it from the call's own start. A refinement skipped (the
start returned) reads 1; an answer that raises the cost reads more.

Beside it, not compared: the same call refined by the port's algorithm
written plainly (reference/loop.sim3_refine), and the largest entry
difference of [R | t] or s between the two, as a share of the plain one's
step from the start (at least STEP_FLOOR). It tells a fault of the
algorithm (sim3_excess high, this low) from one of its code. It has no TF32
control. run.detail["sim3"] collects each call's (share, C_in, C_out,
C_ref, that difference share, inliers in the program's answer, inliers in
the plain one).
"""
from __future__ import annotations

import torch

from ..reference import loop as RL

STEP_FLOOR = 1e-4   # a refinement that moves less is rounding in float32


def hook(cap, run, feed):
    from hfnet_slam_torch.optim import sim3

    return [cap.hook_function(sim3, "optimize_sim3", "sim3")]


def _follow(cam, S0, pairs, valid, out, kw):
    """The plain refinement's answer against the program's: (difference
    share, inliers in the plain answer)."""
    R, t, s, inl = RL.sim3_refine(cam, S0, pairs, valid,
                                  chi2_th=float(kw.get("chi2_th", 10.0)),
                                  n_iters=int(kw.get("n_iters", 20)),
                                  fix_scale=bool(kw.get("fix_scale", False)))
    prog = [out[k].detach().cpu().double() for k in ("R12", "t12", "s12")]
    diff = max(float(torch.max(torch.abs(a.reshape(b.shape) - b)))
               for a, b in zip(prog, (R, t, s)))
    step = max(float(torch.max(torch.abs(a.reshape(b.shape) - b)))
               for a, b in zip(S0, (R, t, s)))
    return diff / max(step, STEP_FLOOR), int(inl.sum())


def numbers(samples, run, feed, device, control):
    if not samples or control:
        return {}
    c = run.config["camera"]
    cam = torch.tensor([c["fx"], c["fy"], c["cx"], c["cy"]], dtype=torch.float64)
    rows = []
    for args, kw, out in samples:
        kind, _, R12, t12, s12, P1, P2, U1, U2, IS1, IS2, valid = args[:12]
        if kind != 0:
            raise ValueError("reference Sim3: pinhole cameras only")
        S_in = [torch.as_tensor(x).detach().cpu().to(torch.float64) for x in (R12, t12, s12)]
        S_in[2] = S_in[2].reshape(())
        S_out = [out[k].detach().cpu() for k in ("R12", "t12", "s12")]
        S_out[2] = S_out[2].reshape(())
        pairs = [x.detach().cpu().to(torch.float64) for x in (P1, P2, U1, U2, IS1, IS2)]
        keep = out["inliers"].detach().cpu()
        x, costs = RL.sim3_excess(cam, S_in, S_out, pairs, keep,
                                  chi2_th=float(kw.get("chi2_th", 10.0)),
                                  fix_scale=bool(kw.get("fix_scale", False)))
        err, n_plain = _follow(cam, S_in, pairs, valid.detach().cpu().bool(), out, kw)
        rows.append((x,) + costs + (err, int(keep.sum()), n_plain))
    run.detail.setdefault("sim3", []).extend(rows)
    return {"sim3_excess": max(r[0] for r in rows)}
