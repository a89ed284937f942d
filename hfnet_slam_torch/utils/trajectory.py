"""Trajectory recovery through reference keyframes.

Counterpart of the recovery half of hfnet_slam_tpu/utils/trajectory.py: each
tracked frame's pose rebuilt from its pose relative to its reference
keyframe and that keyframe's current (possibly loop- or BA-corrected) pose,
as the reference does at save time. The TUM/EuRoC/KITTI savers are ROADMAP.md
Queue 1 item 19.
"""
from __future__ import annotations

import numpy as np


def recovered(traj):
    """(ts, R, t) per entry, rebuilt through the reference keyframe; plain
    (ts, R, t) tuples and entries whose chain is gone keep their track-time
    pose."""
    out = []
    for e in traj:
        if hasattr(e, "recovered_pose"):
            R, t = e.recovered_pose()
            out.append((e.ts, R, t))
        else:
            out.append(tuple(e))
    return out


def recovered_resolved(traj, store=None):
    """Like recovered(), but only the entries whose reference-keyframe chain
    still resolves (into `store`, when given): entries from discarded maps
    live in another gauge. Returns (recovered entries, the same frames'
    track-time poses, resolved fraction)."""
    out, live = [], []
    for e in traj:
        if not hasattr(e, "recovered_pose"):
            continue
        if e.store is None or e.ref_uid < 0 or e.R_rel is None:
            continue
        if store is not None and e.store is not store:
            continue
        if e.store.resolve_uid(int(e.ref_uid)) is None:
            continue
        R, t = e.recovered_pose()
        out.append((e.ts, R, t))
        live.append((e.ts, e.R, e.t))
    return out, live, (len(out) / len(traj) if len(traj) else 0.0)


def keyframe_trajectory(store):
    """(timestamp, R_cw, t_cw) per valid keyframe, in timestamp order."""
    ids = store.valid_kf_ids()
    ids = ids[np.argsort(store.kf_timestamp[ids])]
    return [(float(store.kf_timestamp[k]), store.kf_R[k].copy(), store.kf_t[k].copy())
            for k in ids]
