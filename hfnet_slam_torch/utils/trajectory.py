"""Trajectory export in the reference's three formats, and recovery through
reference keyframes.

Counterpart of hfnet_slam_tpu/utils/trajectory.py (System::SaveTrajectoryTUM /
SaveTrajectoryEuRoC / SaveTrajectoryKITTI and the keyframe variant):
  TUM:   `t tx ty tz qx qy qz qw` (seconds, camera-to-world);
  EuRoC: the same fields with the timestamp in integer nanoseconds;
  KITTI: the row-major 3x4 camera-to-world matrix, 12 numbers a line.
`save` writes each tracked frame's pose rebuilt from its pose relative to its
reference keyframe and that keyframe's current (possibly loop- or
BA-corrected) pose, as the reference does at save time.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import lie


def _cam_to_world(R_cw, t_cw):
    R_wc = np.asarray(R_cw).T
    return R_wc, -R_wc @ np.asarray(t_cw)


def _quat_wxyz(R_wc):
    """Unit quaternion (w, x, y, z) of a rotation, in float32 as the
    reference computes it."""
    return lie.rot_to_quat(torch.from_numpy(np.array(R_wc, np.float32))).numpy()


def tum_lines(traj):
    """traj: iterable of (timestamp, R_cw, t_cw). Returns list[str]."""
    lines = []
    for ts, R_cw, t_cw in traj:
        R_wc, t_wc = _cam_to_world(R_cw, t_cw)
        q = _quat_wxyz(R_wc)
        lines.append(f"{ts:.6f} {t_wc[0]:.7f} {t_wc[1]:.7f} {t_wc[2]:.7f} "
                     f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}")
    return lines


def euroc_lines(traj):
    """EuRoC variant: integer nanosecond timestamps."""
    lines = []
    for ts, R_cw, t_cw in traj:
        R_wc, t_wc = _cam_to_world(R_cw, t_cw)
        q = _quat_wxyz(R_wc)
        lines.append(f"{int(round(ts * 1e9))} {t_wc[0]:.7f} {t_wc[1]:.7f} {t_wc[2]:.7f} "
                     f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}")
    return lines


def kitti_lines(traj):
    """KITTI: row-major 3x4 [R_wc | t_wc] per line, no timestamps."""
    lines = []
    for _, R_cw, t_cw in traj:
        R_wc, t_wc = _cam_to_world(R_cw, t_cw)
        T = np.concatenate([R_wc, t_wc[:, None]], axis=1).reshape(-1)
        lines.append(" ".join(f"{v:.9e}" for v in T))
    return lines


_FORMATS = {"tum": tum_lines, "euroc": euroc_lines, "kitti": kitti_lines}


def save(path, traj, fmt: str = "tum"):
    """Write `traj` (TrajEntry records or (ts, R_cw, t_cw) tuples), each pose
    rebuilt through its reference keyframe, in format `fmt`."""
    lines = _FORMATS[fmt](recovered(traj))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


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
