"""Check kind `pose_graph`: sampled essential-graph problems of the loop
closer's corrections (LoopCloser._build_essential_graph, solved by
optim/pose_graph.optimize_pose_graph), with the keyframe poses as they
stand in the map after the write-back, against a float64 minimizer of the
same cost (reference/loop.py).

pg_excess: the largest share, over the sampled problems, of a problem's
reducible cost that the program left (reference/loop.pg_excess, which
divides by no less than PG_FLOOR: a correction that finds its loop already
closed has 1e-11 to 1e-8 to reduce, and its rounding must read near 0). The
vertex state is read back from the map when the correction's global BA
starts (or the correction ends without one): each keyframe's [R | t / s]
there, with the scale s the program's solve gave it (1 where no solve
ran). The edges, weights and fixed vertices are the program's. A solve skipped or not written back
reads 1 or more. It has no TF32 control. run.detail["pose_graph"] collects
(share, C_in, C_out, C_ref).
"""
from __future__ import annotations

import torch

from ..harness.check import clone
from ..reference import loop as RL


def hook(cap, run, feed):
    from hfnet_slam_torch.optim import pose_graph as pg
    from hfnet_slam_torch.slam.local_mapping import LocalMapper
    from hfnet_slam_torch.slam.loop_closing import LoopCloser

    correct, build, solve = LoopCloser._correct_loop, LoopCloser._build_essential_graph, \
        pg.optimize_pose_graph
    gba = LocalMapper.run_global_ba
    box = {}

    def read_back():
        built = box.pop("built", None)
        if built is None:
            return
        prob, kf_ids = built
        s = box.pop("s", None)
        st = box["store"]

        def make():
            K = len(kf_ids)
            return (prob, kf_ids, torch.ones(K) if s is None else s[:K].cpu(),
                    st.kf_R[kf_ids].copy(), st.kf_t[kf_ids].copy())

        cap.offer("pose_graph", make)

    def _correct_loop(lc, *a, **kw):
        box.clear()
        box["store"] = lc.store
        try:
            return correct(lc, *a, **kw)
        finally:
            read_back()
            box.clear()

    def _build(lc, *a, **kw):
        out = build(lc, *a, **kw)
        if out is not None and "store" in box:
            prob, meta = out
            box["built"] = ({k: clone(v) for k, v in prob._asdict().items()},
                            meta["kf_ids"].copy())
        return out

    def optimize_pose_graph(prob, *a, **kw):
        out = solve(prob, *a, **kw)
        if "built" in box:
            box["s"] = out[0].s.detach().clone()
        return out

    def run_global_ba(mapper, *a, **kw):
        read_back()
        return gba(mapper, *a, **kw)

    LoopCloser._correct_loop, LoopCloser._build_essential_graph = _correct_loop, _build
    pg.optimize_pose_graph = optimize_pose_graph
    LocalMapper.run_global_ba = run_global_ba
    return [(LoopCloser, "_correct_loop", correct), (LoopCloser, "_build_essential_graph", build),
            (pg, "optimize_pose_graph", solve), (LocalMapper, "run_global_ba", gba)]


def numbers(samples, run, feed, device, control):
    if not samples or control:
        return {}
    rows = []
    for prob, kf_ids, s, R_map, t_map in samples:
        p = {k: v.detach().cpu() for k, v in prob.items()}
        K = len(kf_ids)
        V_in = (p["R"], p["t"], p["s"])
        R, t, sc = (x.to(torch.float64).clone() for x in V_in)
        s = s.to(torch.float64)
        R[:K] = torch.as_tensor(R_map, dtype=torch.float64)
        t[:K] = torch.as_tensor(t_map, dtype=torch.float64) * s[:, None]
        sc[:K] = s
        edges = {"i": p["e_i"], "j": p["e_j"], "R": p["e_R"], "t": p["e_t"], "s": p["e_s"],
                 "w": p["e_w"], "valid": p["e_valid"]}
        x, costs = RL.pg_excess(V_in, (R, t, sc), edges, p["fixed"])
        rows.append((x,) + costs)
    run.detail.setdefault("pose_graph", []).extend(rows)
    return {"pg_excess": max(r[0] for r in rows)}
