"""The synthetic browse scene the port is driven and measured on.

The trajectory is bench.py's browse sequence (slam_loop_fps): a camera on a
10 m circle looking at the centre of a 16 m landmark cloud, bobbing
vertically. `jolt_at` adds a hand-held camera jerk: from that frame on every
pose is pre-multiplied by a 0.1 rad yaw about the camera's y axis (~45 px of
sudden image motion), which defeats the constant-velocity search and sends
tracking through the brute-force matcher (TrackReferenceKeyFrame).

`browse_spec` is the one definition of the scene's system as plain data; the
port's `browse_system` and the parity tests' JAX builder both read it, so the
two packages are driven with identical configurations.
"""
from __future__ import annotations

import numpy as np

from .geometry import cameras
from .models.fake import FakeExtractor, SyntheticWorld
from .slam.local_mapping import MapperConfig
from .slam.system import SLAMSystem, SystemConfig
from .slam.tracking import TrackerConfig

# tests/test_fused.py's small system: 512 slots, 64-d descriptors
SMALL = dict(n_landmarks=1200, desc_dim=64, pad_to=512, max_per_frame=420,
             k_max=128, m_max=8192, gdesc_dim=64, local_mp_cap=1024,
             ba_mp_cap=2048, ba_edge_cap=8192)
# bench.py's production widths: 1024 slots, 256-d local, 4096-d global
PRODUCTION = dict(n_landmarks=2600, desc_dim=256, pad_to=1024, max_per_frame=900,
                  k_max=256, m_max=16384, gdesc_dim=4096, local_mp_cap=2048,
                  ba_mp_cap=4096, ba_edge_cap=16384)


def browse_pose(i, jolt_at=None, radius=10.0, rate=0.010, bob=0.4):
    """World->camera (R, t) of frame i, float32."""
    th = rate * i
    c = np.array([radius * np.sin(th), bob * np.sin(0.07 * i), radius - radius * np.cos(th)])
    fwd = np.array([0.0, 0.0, radius]) - c
    fwd /= np.linalg.norm(fwd)
    right = np.cross(np.array([0.0, 1.0, 0.0]), fwd)
    right /= np.linalg.norm(right)
    R_wc = np.stack([right, np.cross(fwd, right), fwd], 1)
    R, t = R_wc.T, -R_wc.T @ c
    if jolt_at is not None and i >= jolt_at:
        a = 0.1
        Ry = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
        R, t = Ry @ R, Ry @ t
    return R.astype(np.float32), t.astype(np.float32)


def browse_spec(size):
    """Keyword arguments of every object of the browse system at `size`
    (SMALL or PRODUCTION): pinhole camera, landmark cloud, extractor,
    SystemConfig, TrackerConfig and MapperConfig. Sync mode, loop closing off
    (the slice's configuration)."""
    s = size
    return dict(
        cam=dict(fx=450.0, fy=450.0, cx=320.0, cy=240.0, width=640, height=480),
        world=dict(seed=5, n_landmarks=s["n_landmarks"], extent=16.0,
                   center=(0, 0, 10.0), desc_dim=s["desc_dim"]),
        ext=dict(pad_to=s["pad_to"], noise_px=0.3, desc_noise=0.03,
                 max_landmarks_per_frame=s["max_per_frame"], seed=7,
                 gdesc_dim=s["gdesc_dim"]),
        system=dict(k_max=s["k_max"], m_max=s["m_max"], n_slots=s["pad_to"],
                    desc_dim=s["desc_dim"], gdesc_dim=s["gdesc_dim"], loop_closing=False),
        tracker=dict(local_mp_cap=s["local_mp_cap"], min_init_med_parallax_deg=4.0),
        mapper=dict(ba_kf_cap=16, ba_mp_cap=s["ba_mp_cap"],
                    ba_edge_cap=s["ba_edge_cap"], tri_neighbors=5))


def browse_system(size, device=None):
    """(SLAMSystem, FakeExtractor) of `browse_spec(size)` on `device`
    (None means CUDA)."""
    sp = browse_spec(size)
    cam = cameras.pinhole(**sp["cam"], device=device)
    world = SyntheticWorld.cloud(**sp["world"])
    ext = FakeExtractor(world, cam, **sp["ext"], device=device)
    cfg = SystemConfig(**sp["system"], tracker=TrackerConfig(**sp["tracker"]),
                       mapper=MapperConfig(**sp["mapper"]))
    return SLAMSystem(cam, ext, cfg, device=device), ext


def production_browse_system(device=None):
    """The browse system at production widths: 1024 keypoint slots, 256-d
    local and 4096-d global descriptors, a 256-keyframe / 16384-point map,
    bench.py's tracker and mapper caps."""
    return browse_system(PRODUCTION, device)
