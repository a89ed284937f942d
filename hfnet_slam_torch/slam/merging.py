"""Map merging: welding the active map into a matched stored map.

Counterpart of hfnet_slam_tpu/slam/merging.py (LoopClosing::MergeLocal):
when place recognition matches a keyframe of the active map into a stored
map, the active map is Sim3-transformed into the stored map's frame and
absorbed. With the struct-of-arrays MapStore this is array surgery on the
host: transform, copy rows, remap ids. The target grows past its capacity
rather than drop anything.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import lie
from .map import MapStore


class _FeatShim:
    """Features-shaped view of stored keyframe rows (for add_keyframe)."""

    def __init__(self, store: MapStore, k: int):
        self.xy = store.kf_xy[k]
        self.desc = store.kf_desc[k]
        self.score = store.kf_score[k]
        self.octave = store.kf_octave[k]
        self.mask = store.kf_mask[k]
        self.global_desc = store.kf_gdesc[k]


def compute_world_transform(active: MapStore, target: MapStore, k: int, cand: int,
                            R_cm, t_cm, s_cm):
    """G = S_{b<-a}, active-map world coordinates into target-map world
    coordinates, from the matched S_cm (candidate camera -> current camera):
    the current keyframe's pose in the target world is S_kb = S_cm T_cand^b,
    and G = S_kb^-1 T_k^a. Returns numpy (R, t) and float s."""
    def T(x):
        return torch.as_tensor(np.asarray(x, np.float32))

    Rc, tc = target.kf_R[cand], target.kf_t[cand]
    Ri, ti, si = lie.sim3_inverse(T(R_cm @ Rc), T(s_cm * (R_cm @ tc) + t_cm), T(float(s_cm)))
    R, t, s = lie.sim3_mul(Ri, ti, si, T(active.kf_R[k]), T(active.kf_t[k]), T(1.0))
    return R.numpy(), t.numpy(), float(s)


def merge_into(active: MapStore, target: MapStore, G):
    """Move every valid keyframe and landmark of `active` into `target`,
    transformed by G = (R, t, s): p_b = s R p_a + t. Returns (kf_remap,
    mp_remap), active id -> target id."""
    Rg, tg, sg = np.asarray(G[0], np.float32), np.asarray(G[1], np.float32), float(G[2])

    mp_ids = np.nonzero(active.mp_valid)[0]
    mp_remap = {}
    if len(mp_ids):
        new_ids = target.add_points(sg * (active.mp_pos[mp_ids] @ Rg.T) + tg,
                                    active.mp_desc[mp_ids])
        # add_points seeds visible/found at 1; carry the real statistics
        target.mp_visible[new_ids] = active.mp_visible[mp_ids]
        target.mp_found[new_ids] = active.mp_found[mp_ids]
        mp_remap = {int(a): int(b) for a, b in zip(mp_ids, new_ids)}

    kf_ids = active.valid_kf_ids()
    kf_ids = kf_ids[np.argsort(active.kf_timestamp[kf_ids])]
    kf_remap = {}
    lut = np.full(active.m_max, -1, np.int32)
    for a, b in mp_remap.items():
        lut[a] = b
    for a in kf_ids:
        # T' = T_a G^-1, scale folded into the translation ([R, t/s])
        Rn = active.kf_R[a] @ Rg.T
        tn = active.kf_t[a] / sg - Rn @ (tg / sg)
        obs_old = active.kf_obs[a]
        obs_new = np.where(obs_old >= 0, lut[np.clip(obs_old, 0, active.m_max - 1)], -1)
        b = target.add_keyframe(Rn, tn, _FeatShim(active, int(a)), float(active.kf_timestamp[a]),
                                obs=obs_new.astype(np.int32), depth=active.kf_depth[a] * sg)
        target.kf_vel[b] = sg * (active.kf_vel[a] @ Rg.T)
        target.kf_bg[b] = active.kf_bg[a]
        target.kf_ba[b] = active.kf_ba[a]
        kf_remap[int(a)] = int(b)
    for a, b in kf_remap.items():
        target.kf_parent[b] = kf_remap.get(int(active.kf_parent[a]), -1)
        target.kf_prev[b] = kf_remap.get(int(active.kf_prev[a]), -1)
    target.imu_initialized = target.imu_initialized or active.imu_initialized
    target.viba1 = target.viba1 or active.viba1
    target.viba2 = target.viba2 or active.viba2
    for a, b in mp_remap.items():
        target.mp_first_kf[b] = kf_remap.get(int(active.mp_first_kf[a]), -1)
    target.loop_edges.extend(store_loop_edges(active, kf_remap))
    return kf_remap, mp_remap


def store_loop_edges(active: MapStore, kf_remap):
    """The active map's loop edges in the target's keyframe ids."""
    return [(kf_remap[a], kf_remap[b]) for a, b in active.loop_edges
            if a in kf_remap and b in kf_remap]
