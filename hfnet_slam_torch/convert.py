"""State carried over from the JAX reference package: HF-Net's weights, the
map and the tracker's frame state.
  * hfnet_params_from_reference: the reference's HF-Net parameter tree
    (hfnet.init_params / load_params / tools/convert_hfnet_weights.py), as
    numpy, -> the port's HFNet state_dict;
  * store_from_reference: the exact .npz the reference's MapStore.save
    writes (hfnet_slam_tpu/slam/map.py, `_ARRAY_FIELDS`) -> the port's
    MapStore, with a stereo rig's right bank (which the snapshot does not
    hold) handed across beside it;
  * tracker_state_from_reference: the reference tracker's last-frame pose
    and observations, velocity, reference keyframe and local-map candidate
    ids, as numpy, applied to a port Tracker;
  * imu_calib_from_reference / preintegrated_from_reference: the
    reference's ImuCalib and Preintegrated records (geometry/imu.py), field
    by field as numpy, -> the port's.
None of them reads JAX arrays: the caller hands numpy (np.asarray) across.
"""
from __future__ import annotations

import numpy as np

import torch

from .geometry import imu
from .models import hfnet
from .slam.map import MapStore
from .slam.tracking import OK, Frame, Tracker


def hfnet_params_from_reference(tree) -> dict:
    """The reference's nested HF-Net parameter tree (dicts and lists of numpy
    arrays, HWIO convs, the (K*C, 4096) projection) -> a CPU state_dict for
    the port's HFNet (`HFNet.from_state`): dense convs to OIHW, depthwise
    convs to (mid,1,3,3), the projection transposed."""

    def flatten(t, prefix=""):
        if isinstance(t, dict):
            for k, v in t.items():
                yield from flatten(v, f"{prefix}{k}/")
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                yield from flatten(v, f"{prefix}{i}/")
        else:
            yield prefix[:-1], np.asarray(t)

    return hfnet.state_from_flat(dict(flatten(tree)))


def store_from_reference(npz_path_or_dict, right_bank=None) -> MapStore:
    """Port MapStore from a reference map snapshot (a path, an open file, or
    the dict-like np.load result). right_bank: the reference store's
    (kf_xy_r, kf_oct_r, kf_obs_r) as numpy, copied into the port's right
    bank."""
    if isinstance(npz_path_or_dict, dict):
        import io

        buf = io.BytesIO()
        np.savez(buf, **npz_path_or_dict)
        buf.seek(0)
        store = MapStore.load(buf)
    else:
        store = MapStore.load(npz_path_or_dict)
    if right_bank is not None:
        store.enable_right_bank()
        for name, arr in zip(("kf_xy_r", "kf_oct_r", "kf_obs_r"), right_bank):
            getattr(store, name)[...] = np.asarray(arr)
    return store


def tracker_state_from_reference(tracker: Tracker, store: MapStore, *, last_R, last_t,
                                 last_obs, last_feats, last_timestamp, velocity,
                                 ref_kf, local_ids):
    """Install the reference tracker's frame state on a port Tracker.

    last_R/last_t: the last frame's world->cam pose; last_obs: its (N,) slot
    -> map point ids; last_feats: its Features (port tensors);
    velocity: (R_v, t_v) or None; ref_kf: reference keyframe slot;
    local_ids: the next frame's (local_mp_cap,) candidate ids or None."""
    tracker.store = store
    frame = Frame(feats=last_feats, timestamp=float(last_timestamp),
                  R=np.asarray(last_R, np.float32).copy(),
                  t=np.asarray(last_t, np.float32).copy(),
                  obs=np.asarray(last_obs, np.int32).copy())
    tracker.last_frame = frame
    tracker.velocity = None if velocity is None else (
        np.asarray(velocity[0], np.float32), np.asarray(velocity[1], np.float32))
    tracker.ref_kf = int(ref_kf)
    tracker._local_ids = None if local_ids is None else np.asarray(local_ids, np.int32).copy()
    tracker._seen_big = store.big_change_idx
    tracker.state = OK
    return tracker


def imu_calib_from_reference(calib) -> imu.ImuCalib:
    """The reference's ImuCalib (noise densities, Tbc_R, Tbc_t) -> the
    port's, keeping every value's float32 bits."""
    f = {k: np.asarray(getattr(calib, k), np.float32) for k in imu.ImuCalib._fields}
    return imu.ImuCalib(sigma_g=float(f["sigma_g"]), sigma_a=float(f["sigma_a"]),
                        sigma_gw=float(f["sigma_gw"]), sigma_aw=float(f["sigma_aw"]),
                        Tbc_R=f["Tbc_R"].copy(), Tbc_t=f["Tbc_t"].copy())


def preintegrated_from_reference(pre, device="cpu") -> imu.Preintegrated:
    """The reference's Preintegrated (single or batched) -> the port's, as
    float32 tensors on `device`."""
    return imu.Preintegrated(*(torch.tensor(np.asarray(getattr(pre, k)), dtype=torch.float32,
                                            device=device)
                               for k in imu.Preintegrated._fields))
