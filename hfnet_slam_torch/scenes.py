"""The synthetic scenes the port is driven and measured on.

Browse: bench.py's browse sequence (slam_loop_fps), a camera on a 10 m
circle looking at the centre of a 16 m landmark cloud, bobbing vertically.
`jolt_at` adds a hand-held camera jerk: from that frame on every pose is
pre-multiplied by a 0.1 rad yaw about the camera's y axis (~45 px of sudden
image motion), which defeats the constant-velocity search and sends tracking
through the brute-force matcher (TrackReferenceKeyFrame). `reloc_spec` is
the same scene with the tracker overrides of tests/test_reloc.py's blackout,
whose featureless frames `BLACKOUT` send tracking through relocalization.

Loop circuit: bench.py's `_loop_metrics` scene, a camera orbiting a 6 m
circle facing outward at a landmark ring past one full revolution, so the
start region is revisited and loop closing has drift to correct
(LOOP_PRODUCTION: 330 frames over 2.2 laps at production widths, as the
reference's sync circuit; LOOP_SMALL: tests/test_loop.py's 170-frame run).

Each `*_spec` is the one definition of a system as plain data; the port's
builders and the parity tests' JAX builder both read it, so the two packages
are driven with identical configurations.
"""
from __future__ import annotations

import numpy as np

from .geometry import cameras
from .models.fake import FakeExtractor, SyntheticWorld
from .slam.local_mapping import MapperConfig
from .slam.loop_closing import LoopCloserConfig
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

# tests/test_reloc.py's blackout: frames 55-61 carry no features
BLACKOUT = range(55, 62)

# tests/test_loop.py's loop_run: 512 slots, 64-d, 170 frames over 2.25 laps
LOOP_SMALL = dict(
    n_landmarks=4000, desc_dim=64, pad_to=512, noise_px=0.3, desc_noise=0.03,
    max_per_frame=480, gdesc_dim=64, frames=170, total_angle=2.25 * np.pi,
    mapper=dict(ba_kf_cap=16, ba_mp_cap=2048, ba_edge_cap=8192, tri_neighbors=5),
    loop=dict(min_pair_matches=30, min_sim3_inliers=15, min_proj_matches=30,
              consistency_hits=1, n_covis_window=5, window_mp_cap=2048, gba_kf_cap=48,
              gba_mp_cap=4096, gba_edge_cap=16384, ransac_hyps=256))
# bench.py's _loop_metrics circuit (its sync pass): 1024 slots, 256-d local,
# 4096-d global, 330 frames over 2.2 laps
LOOP_PRODUCTION = dict(
    n_landmarks=5000, desc_dim=256, pad_to=1024, noise_px=0.5, desc_noise=0.02,
    max_per_frame=900, gdesc_dim=4096, frames=330, total_angle=4.4 * np.pi,
    mapper=dict(ba_kf_cap=16, ba_mp_cap=4096, ba_edge_cap=16384, tri_neighbors=5),
    loop=dict(min_pair_matches=60, min_sim3_inliers=25, min_proj_matches=45,
              consistency_hits=2, n_covis_window=5, window_mp_cap=2048, gba_kf_cap=48,
              gba_mp_cap=8192, gba_edge_cap=32768, ransac_hyps=256))


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


def reloc_spec(size):
    """browse_spec with tests/test_reloc.py's tracker overrides: keyframes
    accrue before the blackout (kf_ref_ratio 0.95), a 3-keyframe map counts
    as mature (so a lost track relocalizes instead of starting a new map),
    and 30 pose inliers accept a relocalization."""
    sp = browse_spec(size)
    sp["tracker"].update(kf_ref_ratio=0.95, mature_map_kfs=2, min_reloc_inliers=30)
    return sp


def ring_pose(i, n_frames, total_angle, radius=6.0, bob=0.15):
    """World->camera (R, t) of frame i of the loop circuit, float32: the
    camera on a circle of `radius` about (0, 0, radius), facing outward."""
    th = total_angle * i / n_frames
    out = np.array([np.sin(th), 0.0, -np.cos(th)])
    c = np.array([0.0, 0.0, radius]) + radius * out + np.array([0.0, bob * np.sin(0.1 * i), 0.0])
    right = np.cross(np.array([0.0, 1.0, 0.0]), out)
    right /= np.linalg.norm(right)
    R_wc = np.stack([right, np.cross(out, right), out], 1)
    return R_wc.T.astype(np.float32), (-R_wc.T @ c).astype(np.float32)


def ring_world(n_landmarks, desc_dim, seed=11):
    """(landmarks, descriptors, generator) of the circuit's landmark ring,
    drawn as bench.py and tests/test_loop.py draw it; either package's
    SyntheticWorld takes the triple."""
    rng = np.random.default_rng(seed)
    th = rng.uniform(0, 2 * np.pi, n_landmarks)
    rr = rng.uniform(12.0, 20.0, n_landmarks)
    pts = np.stack([rr * np.sin(th), rng.uniform(-4.0, 4.0, n_landmarks),
                    6.0 - rr * np.cos(th)], 1).astype(np.float32)
    d = rng.standard_normal((n_landmarks, desc_dim)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return pts, d, rng


def loop_spec(size):
    """Keyword arguments of every object of the loop-circuit system at
    `size` (LOOP_SMALL or LOOP_PRODUCTION): sync mode, loop closing on."""
    s = size
    return dict(
        cam=dict(fx=450.0, fy=450.0, cx=320.0, cy=240.0, width=640, height=480),
        world=dict(n_landmarks=s["n_landmarks"], desc_dim=s["desc_dim"]),
        ext=dict(pad_to=s["pad_to"], noise_px=s["noise_px"], desc_noise=s["desc_noise"],
                 max_landmarks_per_frame=s["max_per_frame"], seed=7, max_depth=25.0,
                 gdesc_dim=s["gdesc_dim"]),
        system=dict(k_max=256, m_max=16384, n_slots=s["pad_to"], desc_dim=s["desc_dim"],
                    gdesc_dim=s["gdesc_dim"], loop_closing=True, async_mapping=False),
        tracker=dict(local_mp_cap=2048, min_init_med_parallax_deg=1.0),
        mapper=dict(s["mapper"]), loop=dict(s["loop"]))


def _system(sp, world, device):
    cam = cameras.pinhole(**sp["cam"], device=device)
    ext = FakeExtractor(world, cam, **sp["ext"], device=device)
    cfg = SystemConfig(**sp["system"], tracker=TrackerConfig(**sp["tracker"]),
                       mapper=MapperConfig(**sp["mapper"]),
                       loop=LoopCloserConfig(**sp.get("loop", {})))
    return SLAMSystem(cam, ext, cfg, device=device), ext


def browse_system(size, device=None, spec=browse_spec):
    """(SLAMSystem, FakeExtractor) of `spec(size)` (browse_spec or
    reloc_spec) on `device` (None means CUDA)."""
    sp = spec(size)
    return _system(sp, SyntheticWorld.cloud(**sp["world"]), device)


def loop_system(size, device=None):
    """(SLAMSystem, FakeExtractor) of `loop_spec(size)` on `device`."""
    sp = loop_spec(size)
    return _system(sp, SyntheticWorld(*ring_world(**sp["world"])), device)


def production_browse_system(device=None):
    """The browse system at production widths: 1024 keypoint slots, 256-d
    local and 4096-d global descriptors, a 256-keyframe / 16384-point map,
    bench.py's tracker and mapper caps."""
    return browse_system(PRODUCTION, device)
