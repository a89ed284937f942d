"""ctypes bindings for the native host-runtime library (mapcore.cpp).

The port's own copy of hfnet_slam_tpu/native: the irregular map bookkeeping
(covisibility, observation scans) stays on the CPU. The library is built
with g++ on first use into the package's build directory (not next to the
source); every entry point has a numpy fallback, used when no compiler is
available.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from ..device import BUILD_DIR

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "mapcore.cpp")
_LIB = os.path.join(BUILD_DIR, "libmapcore.so")

_lib = None
_tried = False
_lock = threading.Lock()


def _build() -> bool:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", _SRC, "-o", tmp],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return False
    os.replace(tmp, _LIB)
    return True


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_LIB) or os.path.getmtime(_LIB) < os.path.getmtime(_SRC):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_LIB)
        except OSError:
            return None
        i64 = ctypes.c_int64
        p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        p_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.covis_update.argtypes = [p_i32, p_u8, i64, i64, i64, i64, p_i32, p_u8]
        lib.covis_update.restype = None
        lib.observing_slots.argtypes = [p_i32, p_u8, i64, i64, i64, p_u8,
                                        p_i32, p_i32, p_i32, i64]
        lib.observing_slots.restype = i64
        _lib = lib
        return _lib


def covis_update(kf_obs, kf_valid, covis, k, m_max, scratch=None):
    """Update row/col k of the covisibility matrix in place."""
    lib = get_lib()
    K, N = kf_obs.shape
    if lib is not None:
        if scratch is None:
            scratch = np.zeros(m_max, np.uint8)
        lib.covis_update(np.ascontiguousarray(kf_obs, np.int32),
                         np.ascontiguousarray(kf_valid, np.uint8),
                         K, N, m_max, int(k), covis, scratch)
        return
    obs_k = kf_obs[k]
    obs_k = obs_k[obs_k >= 0]
    if len(obs_k) == 0:
        return
    member = np.zeros(m_max, bool)
    member[obs_k] = True
    for j in np.nonzero(kf_valid)[0]:
        if j == k:
            continue
        obs_j = kf_obs[j]
        w = int(member[obs_j[obs_j >= 0]].sum())
        covis[k, j] = w
        covis[j, k] = w


def observing_slots(kf_obs, kf_valid, member, cap=None):
    """All (kf, slot, mp) triples whose map point is in `member`."""
    lib = get_lib()
    K, N = kf_obs.shape
    M = len(member)
    if lib is not None:
        cap = cap or K * N
        out_kf = np.empty(cap, np.int32)
        out_slot = np.empty(cap, np.int32)
        out_mp = np.empty(cap, np.int32)
        n = lib.observing_slots(np.ascontiguousarray(kf_obs, np.int32),
                                np.ascontiguousarray(kf_valid, np.uint8),
                                K, N, M, np.ascontiguousarray(member, np.uint8),
                                out_kf, out_slot, out_mp, cap)
        return out_kf[:n], out_slot[:n], out_mp[:n]
    obs = kf_obs.copy()
    obs[~kf_valid] = -1
    sel = (obs >= 0) & member.astype(bool)[np.clip(obs, 0, M - 1)]
    kf_idx, slot_idx = np.nonzero(sel)
    return kf_idx.astype(np.int32), slot_idx.astype(np.int32), obs[kf_idx, slot_idx]
