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

EuRoC with HF-Net (`euroc_hfnet_system`): the EuRoC MAV cam0 pinhole
(752x480) with the HF-Net pyramid extractor at bench.py's headline
configuration (1000 features, 4 levels at 1.2, threshold 0.01, 1024 slots)
and randomly initialized weights drawn from a seeded generator: no HF-Net
checkpoint is in the repository. `textured_image` draws the images it is
driven with: Gaussian blobs from a seeded generator.

Each `*_spec` is the one definition of a system as plain data; the port's
builders and the parity tests' JAX builder both read it, so the two packages
are driven with identical configurations. `browse_system` and `loop_system`
take `async_mapping=True` for the async mapping/loop/GBA pipeline.

A synthetic EuRoC sequence (`write_euroc_sequence`): `textured_image` frames
in EuRoC's `mav0/cam0` layout (8-bit PNGs, data.csv with nanosecond
timestamps 50 ms apart) and a settings file in the reference's format, for
the EuRoC runner (examples/run_euroc.py) where no real sequence is at hand.
The texture moves 4 px a frame and, from `shake[0]` on, every other frame
sits `shake[1]` px further along it (the hand-held shake that sends tracking
to the reference keyframe through row_top2).

Visual-inertial (`vi_system`): bench.py's `_vi_metrics` scene, the browse
cloud seen from an analytic arc (`vi_pose`, 0.4 rad/s on a 10 m circle,
bobbing) with exact 200 Hz IMU from its finite differences (`synth_imu`:
specific force and body rate, body = camera). VI_PRODUCTION is bench.py's
scenario (100 frames at 10 Hz, gravity along -y, production widths);
VI_SMALL is tests/test_vi_slam.py's (110 frames at 20 Hz, gravity along -z,
512 slots, 64-d). `write_euroc_inertial_sequence` writes such a run as an
EuRoC folder (cam0 PNGs of a synthetic texture, imu0/data.csv) with a
settings file carrying the IMU keys.

Stereo and RGB-D (`rgbd_system`, `stereo_system`, `rig_system`,
`stereo_vi_system`): a fake extractor takes a pose, not an image, so these
systems' "images" are poses: `(R_cw, t_cw)` for RGB-D, and
`(camera, R_cw, t_cw)` for stereo, where the `PoseRig` adapter sends camera
0 to the left and 1 to the right FakeExtractor; `stereo_images` makes a
frame's pair. The runs go through track_rgbd, track_stereo and
track_stereo_inertial themselves.
  * rgbd: the browse scene with ground-truth depth, 0.5% noise per landmark
    and frame, splatted into a 640x480 float32 depth image
    (`depth_image`): each visible landmark fills the 3x3 pixels around its
    projection, the nearest landmark winning, so the nearest-pixel lookup
    of a keypoint with the extractor's pixel noise still finds its depth;
    th_depth 25 m;
  * stereo: the browse cloud seen by a rectified right camera 0.1 m along
    x (tests/test_stereo.py's rig), th_depth STEREO_TH_DEPTH (12 m);
  * rig: tests/test_stereo.py's KB8 512x512 fisheye pair (right camera
    0.11 m along x, slightly rotated, its own intrinsics) with `cam_right`
    and `T_lr` set, so the right bank and the ToBody edges run; a cloud 0.3
    to 5 m in front, the camera sliding along x;
  * stereo_vi: the VI scene with a rectified right camera 0.11 m along x
    (EuRoC's baseline), through track_stereo_inertial.
`write_tum_rgbd_sequence` writes a TUM RGB-D folder (textured 640x480
frames, 16-bit depth PNGs at factor 5000 of a tilted plane, rgb.txt,
depth.txt) and a settings file of TUM1's camera for the RGB-D runner.

CNN in the loop (`cnn_system`, `cnn_run`): bench.py's `_cnn_metrics`
scenario (:682-869). A CylinderWorld (models/synth.py) renders exact RGB-D
views of a textured wall around an orbit; HF-Net, from the port's seed-0
weights, is fine-tuned on the world's exact correspondences
(models/selftrain.py) and then extracts every frame of the RGB-D SLAM loop,
with depth sampled at its keypoints (ops/stereo.depth_at_keypoints).
CNN_PRODUCTION is bench.py's branch for the accelerator (640x480, 675
features, 4 levels, 250 steps, 120 frames), CNN_SMALL its CPU branch
(320x240, 400 features, 2 levels, 100 steps, 60 frames).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .device import resolve
from .geometry import cameras
from .models.extractor import HFExtractor
from .models import selftrain
from .models.fake import FakeExtractor, SyntheticWorld
from .models.hfnet import HFNet
from .models.synth import CylinderWorld
from .slam.local_mapping import MapperConfig
from .slam.loop_closing import LoopCloserConfig
from .slam.system import SLAMSystem, SystemConfig
from .slam.tracking import TrackerConfig
from .slam.vi import VIConfig

# tests/test_fused.py's small system: 512 slots, 64-d descriptors
SMALL = dict(n_landmarks=1200, desc_dim=64, pad_to=512, max_per_frame=420,
             k_max=128, m_max=8192, gdesc_dim=64, local_mp_cap=1024,
             ba_mp_cap=2048, ba_edge_cap=8192)
# bench.py's production widths: 1024 slots, 256-d local, 4096-d global
PRODUCTION = dict(n_landmarks=2600, desc_dim=256, pad_to=1024, max_per_frame=900,
                  k_max=256, m_max=16384, gdesc_dim=4096, local_mp_cap=2048,
                  ba_mp_cap=4096, ba_edge_cap=16384)

# EuRoC MAV cam0 (sensor.yaml intrinsics; the distortion is not modelled)
EUROC_CAM0 = dict(fx=458.654, fy=457.296, cx=367.215, cy=248.375, width=752, height=480)
# bench.py's pyramid_extraction_latency configuration (EuRoC.yaml:67-80)
EUROC_HFNET = dict(n_features=1000, n_levels=4, scale_factor=1.2, threshold=0.01, pad_to=1024)

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


# (frame, px): the hand-held shake of the EuRoC sequences (chip_smoke.py's
# extraction phase and write_euroc_sequence). From that frame on, every
# other frame sits 200 px further along the texture, far beyond the motion
# model's 30 px search window, so the image jumps 200 px on every frame.
# Random-weight descriptors are alike enough that the motion model may follow
# one jump on false matches (after a single lasting 100 px jolt, 3 of 5 runs
# on an H100 never launched row_top2), not eight: the tracker falls back to
# the reference keyframe through row_top2
SHAKE = (12, 200)


def _system(sp, world, device):
    cam = cameras.pinhole(**sp["cam"], device=device)
    ext = FakeExtractor(world, cam, **sp["ext"], device=device)
    cfg = SystemConfig(**sp["system"], tracker=TrackerConfig(**sp["tracker"]),
                       mapper=MapperConfig(**sp["mapper"]),
                       loop=LoopCloserConfig(**sp.get("loop", {})))
    return SLAMSystem(cam, ext, cfg, device=device), ext


def browse_system(size, device=None, spec=browse_spec, async_mapping=False):
    """(SLAMSystem, FakeExtractor) of `spec(size)` (browse_spec or
    reloc_spec) on `device` (None means CUDA), in the async pipeline when
    `async_mapping`."""
    sp = spec(size)
    sp["system"]["async_mapping"] = async_mapping
    return _system(sp, SyntheticWorld.cloud(**sp["world"]), device)


def loop_system(size, device=None, async_mapping=False):
    """(SLAMSystem, FakeExtractor) of `loop_spec(size)` on `device`, in the
    async pipeline when `async_mapping`."""
    sp = loop_spec(size)
    sp["system"]["async_mapping"] = async_mapping
    return _system(sp, SyntheticWorld(*ring_world(**sp["world"])), device)


def production_browse_system(device=None):
    """The browse system at production widths: 1024 keypoint slots, 256-d
    local and 4096-d global descriptors, a 256-keyframe / 16384-point map,
    bench.py's tracker and mapper caps."""
    return browse_system(PRODUCTION, device)


def textured_image(rng, h, w):
    """A grayscale image in [0,255] of random Gaussian blobs (one per 120
    px, sigma 1.5-10 px, either sign) on a mid-grey ground, float32."""
    n_blobs = h * w // 120
    img = np.full((h, w), 128.0)
    ys, xs = rng.uniform(0, h, n_blobs), rng.uniform(0, w, n_blobs)
    sig = rng.uniform(1.5, 10.0, n_blobs)
    amp = rng.uniform(-90.0, 90.0, n_blobs)
    for y, x, s, a in zip(ys, xs, sig, amp):
        r = int(3 * s) + 1
        y0, y1 = max(int(y) - r, 0), min(int(y) + r + 1, h)
        x0, x1 = max(int(x) - r, 0), min(int(x) + r + 1, w)
        gy, gx = np.mgrid[y0:y1, x0:x1]
        img[y0:y1, x0:x1] += a * np.exp(-((gy - y) ** 2 + (gx - x) ** 2) / (2 * s * s))
    return np.clip(img, 0, 255).astype(np.float32)


def euroc_hfnet_system(device=None, dtype=torch.float32, seed=0, depth_multiplier=1.0):
    """SLAMSystem on EuRoC cam0 whose extractor is HF-Net at
    `depth_multiplier` (He-initialized from a torch.Generator seeded with
    `seed`, on the device) at bench.py's headline configuration, running in
    `dtype`; 1024 slots, 256-d local and 4096-d global descriptors. Feed it
    480x752 grayscale images through `track_monocular`; the extractor is
    `system.extractor`."""
    dev = resolve(device)
    cam = cameras.pinhole(**EUROC_CAM0, device=dev)
    net = HFNet(torch.Generator(device=dev).manual_seed(seed), depth_multiplier)
    ext = HFExtractor(net, (EUROC_CAM0["height"], EUROC_CAM0["width"]), **EUROC_HFNET,
                      dtype=dtype, device=dev)
    cfg = SystemConfig(n_slots=EUROC_HFNET["pad_to"], desc_dim=256, gdesc_dim=4096)
    return SLAMSystem(cam, ext, cfg, device=dev)


EUROC_T0_NS = 1403636579763555584  # MH_01_easy's first cam0 timestamp
EUROC_SETTINGS = """%YAML:1.0
File.version: "1.0"
Camera.type: "PinHole"
Camera1.fx: {fx}
Camera1.fy: {fy}
Camera1.cx: {cx}
Camera1.cy: {cy}
Camera.width: {width}
Camera.height: {height}
Camera.fps: 20
Camera.RGB: 1
Extractor.type: "HFNetTPU"
Extractor.nFeatures: {n_features}
Extractor.nLevels: {n_levels}
Extractor.scaleFactor: {scale_factor}
Extractor.threshold: {threshold}
loopClosing: 1
"""


EUROC_STEP_PX = 4  # the synthetic sequence's pan between frames
EUROC_TEXTURE_SEED = 0


def write_euroc_sequence(out_dir, n_frames, shake=SHAKE):
    """Write `n_frames` textured frames of cam0's size in EuRoC's layout
    under out_dir/mav0 and a settings file out_dir/settings.yaml. Returns
    (mav0 path, settings path, frame timestamps in seconds)."""
    from .utils.datasets import write_png

    H, W = EUROC_CAM0["height"], EUROC_CAM0["width"]
    at, px = shake
    offs = [EUROC_STEP_PX * i + (px if i >= at and (i - at) % 2 == 0 else 0)
            for i in range(n_frames)]
    canvas = textured_image(np.random.default_rng(EUROC_TEXTURE_SEED), H, W + max(offs))
    data = os.path.join(out_dir, "mav0", "cam0", "data")
    os.makedirs(data, exist_ok=True)
    lines, stamps = ["#timestamp [ns],filename"], []
    for i, o in enumerate(offs):
        ns = EUROC_T0_NS + i * 50_000_000
        write_png(os.path.join(data, f"{ns}.png"),
                  np.round(canvas[:, o:o + W]).astype(np.uint8))
        lines.append(f"{ns},{ns}.png")
        stamps.append(ns * 1e-9)
    with open(os.path.join(out_dir, "mav0", "cam0", "data.csv"), "w") as f:
        f.write("\n".join(lines) + "\n")
    settings = os.path.join(out_dir, "settings.yaml")
    with open(settings, "w") as f:
        f.write(EUROC_SETTINGS.format(**EUROC_CAM0, **EUROC_HFNET))
    return os.path.join(out_dir, "mav0"), settings, np.asarray(stamps)


# ---------------------------------------------------------------------------
# visual-inertial scenes
# ---------------------------------------------------------------------------
VI_IMU_DT = 0.005  # 200 Hz
# tests/test_vi_slam.py's run: 512 slots, 64-d, 1400 landmarks, 20 Hz frames
VI_SMALL = dict(n_landmarks=1400, desc_dim=64, pad_to=512, max_per_frame=480,
                desc_noise=0.03, gdesc_dim=64, k_max=128, m_max=8192,
                mapper=dict(ba_kf_cap=16, ba_mp_cap=2048, ba_edge_cap=8192, tri_neighbors=5),
                frames=110, frame_dt=0.05, grav=(0.0, 0.0, -9.81))
# bench.py's _vi_metrics: 1024 slots, 256-d local, 4096-d global, 1800
# landmarks, 10 Hz frames, the inertial-window caps sized to production
# shapes
VI_PRODUCTION = dict(n_landmarks=1800, desc_dim=256, pad_to=1024, max_per_frame=900,
                     desc_noise=0.015, gdesc_dim=4096, k_max=128, m_max=16384,
                     mapper=dict(ba_kf_cap=16, ba_mp_cap=4096, ba_edge_cap=16384,
                                 tri_neighbors=5, iba_mp_cap=4096, iba_edge_cap=16384),
                     frames=100, frame_dt=0.1, grav=(0.0, -9.81, 0.0))
# tests/test_vi_dropout.py's clock and gravity (bench.py's), at VI_SMALL's
# widths: frames 60-69 of a 90-frame async run carry no features
VI_DROPOUT = dict(frames=90, frame_dt=0.1, grav=(0.0, -9.81, 0.0), blackout=range(60, 70))


def vi_pose(t, radius=10.0, rate=0.4, bob=0.4):
    """(R_wc, c): camera-to-world rotation and centre at time t, float64."""
    th = rate * t
    c = np.array([radius * np.sin(th), bob * np.sin(1.4 * t), radius - radius * np.cos(th)])
    fwd = np.array([0.0, 0.0, radius]) - c
    fwd /= np.linalg.norm(fwd)
    right = np.cross(np.array([0.0, 1.0, 0.0]), fwd)
    right /= np.linalg.norm(right)
    return np.stack([right, np.cross(fwd, right), fwd], 1), c


def synth_imu(t0, t1, grav=VI_PRODUCTION["grav"]):
    """Exact IMU rows [ax ay az wx wy wz dt] over (t0, t1] for body = camera:
    specific force R^T (a_w - g) and body rate log(R^T R_next) / dt from
    central differences of vi_pose, float32."""
    from . import lie

    h = VI_IMU_DT
    n = int(round((t1 - t0) / h))
    ts = t0 + h * np.arange(1, n + 1)
    Rs, f_b, Rrel = [], [], []
    for t in ts:
        R, c = vi_pose(t)
        _, c_p = vi_pose(t - h)
        R_n, c_n = vi_pose(t + h)
        f_b.append(R.T @ ((c_n - 2 * c + c_p) / (h * h) - np.asarray(grav)))
        Rrel.append(R.T @ R_n)
    if n == 0:
        return np.zeros((0, 7), np.float32)
    w_b = lie.so3_log(torch.tensor(np.stack(Rrel), dtype=torch.float64)).numpy() / h
    return np.concatenate([np.stack(f_b), w_b, np.full((n, 1), h)], 1).astype(np.float32)


def vi_frame_pose(t):
    """World->camera (R, t) of the VI scene at time t, float32."""
    R_wc, c = vi_pose(t)
    R_cw = R_wc.T.astype(np.float32)
    return R_cw, (-R_cw @ c).astype(np.float32)


def vi_spec(size, async_mapping=False, vi_marg_prior=True):
    """Keyword arguments of every object of the VI system at `size`
    (VI_SMALL or VI_PRODUCTION): loop closing off, bench.py's VIConfig."""
    s = size
    return dict(
        cam=dict(fx=450.0, fy=450.0, cx=320.0, cy=240.0, width=640, height=480),
        world=dict(seed=5, n_landmarks=s["n_landmarks"], extent=16.0, center=(0, 0, 10.0),
                   desc_dim=s["desc_dim"]),
        ext=dict(pad_to=s["pad_to"], noise_px=0.3, desc_noise=s["desc_noise"],
                 max_landmarks_per_frame=s["max_per_frame"], seed=7, gdesc_dim=s["gdesc_dim"]),
        system=dict(k_max=s["k_max"], m_max=s["m_max"], n_slots=s["pad_to"],
                    desc_dim=s["desc_dim"], gdesc_dim=s["gdesc_dim"], loop_closing=False,
                    async_mapping=async_mapping),
        tracker=dict(local_mp_cap=2048, min_init_med_parallax_deg=2.0,
                     vi_marg_prior=vi_marg_prior),
        mapper=dict(s["mapper"]),
        vi=dict(t_init=1.5, t_viba1=3.5, t_viba2=8.0, min_kfs_for_init=6, meas_cap=512),
        imu=dict(freq=1.0 / VI_IMU_DT))


def vi_system(size, device=None, async_mapping=False, vi_marg_prior=True):
    """(SLAMSystem, FakeExtractor) of vi_spec(size) on `device` (None means
    CUDA), visual-inertial with the default IMU noise at 200 Hz."""
    from .geometry import imu

    sp = vi_spec(size, async_mapping, vi_marg_prior)
    cam = cameras.pinhole(**sp["cam"], device=device)
    ext = FakeExtractor(SyntheticWorld.cloud(**sp["world"]), cam, **sp["ext"], device=device)
    cfg = SystemConfig(**sp["system"], tracker=TrackerConfig(**sp["tracker"]),
                       mapper=MapperConfig(**sp["mapper"]), vi=VIConfig(**sp["vi"]))
    return SLAMSystem(cam, ext, cfg, imu_calib=imu.default_calib(**sp["imu"]),
                      device=device), ext


def vi_blank_features(size):
    """A frame the matcher can do nothing with (a visual blackout), as
    numpy arrays in the Features layout."""
    n, d, g = size["pad_to"], size["desc_dim"], size["gdesc_dim"]
    from .models.extractor import Features

    return Features(xy=torch.zeros((n, 2)), score=torch.zeros(n),
                    octave=torch.zeros(n, dtype=torch.int32), desc=torch.zeros((n, d)),
                    mask=torch.zeros(n, dtype=torch.bool),
                    global_desc=torch.ones(g) / np.sqrt(g))


EUROC_IMU_SETTINGS = EUROC_SETTINGS + """IMU.NoiseGyro: 1.7e-4
IMU.NoiseAcc: 2.0e-3
IMU.GyroWalk: 1.9e-5
IMU.AccWalk: 3.0e-3
IMU.Frequency: 200.0
IMU.T_b_c1: !!opencv-matrix
   rows: 4
   cols: 4
   dt: f
   data: [1.0, 0.0, 0.0, 0.0,
          0.0, 1.0, 0.0, 0.0,
          0.0, 0.0, 1.0, 0.0,
          0.0, 0.0, 0.0, 1.0]
"""


def write_euroc_inertial_sequence(out_dir, n_frames, shake=SHAKE):
    """write_euroc_sequence's frames plus mav0/imu0/data.csv: 200 Hz rows
    (timestamp [ns], w_RS_S xyz [rad/s], a_RS_S xyz [m/s^2]) from the VI
    scene's exact IMU, spanning the frames, and a settings file with the
    IMU keys (identity T_b_c1). Returns (mav0 path, settings path, frame
    timestamps in seconds)."""
    mav0, settings, stamps = write_euroc_sequence(out_dir, n_frames, shake=shake)
    rows = synth_imu(-VI_IMU_DT, (n_frames - 1) * 0.05 + VI_IMU_DT)
    lines = ["#timestamp [ns],w_RS_S_x [rad s^-1],w_RS_S_y [rad s^-1],w_RS_S_z [rad s^-1],"
             "a_RS_S_x [m s^-2],a_RS_S_y [m s^-2],a_RS_S_z [m s^-2]"]
    for i, r in enumerate(rows):
        ns = EUROC_T0_NS + i * int(VI_IMU_DT * 1e9)
        lines.append(",".join([str(ns)] + [repr(float(r[c])) for c in (3, 4, 5, 0, 1, 2)]))
    os.makedirs(os.path.join(mav0, "imu0"), exist_ok=True)
    with open(os.path.join(mav0, "imu0", "data.csv"), "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(settings, "w") as f:
        f.write(EUROC_IMU_SETTINGS.format(**EUROC_CAM0, **EUROC_HFNET))
    return mav0, settings, stamps


# ---------------------------------------------------------------------------
# stereo and RGB-D scenes
# ---------------------------------------------------------------------------
DEPTH_NOISE = 0.005  # relative, per landmark and frame (tests/test_stereo.py:126)
STEREO_BASELINE = 0.1  # the rectified browse rig (tests/test_stereo.py:21-37)
# close-point threshold of the rectified rigs, 120 baselines (ORB-SLAM3's
# settings use 35-40; fewer than 100 points of the browse cloud lie within
# 10 m of frame 0 at SMALL). A stereo depth at z carries z * 0.42 px / bf of
# relative noise (0.3 px per keypoint), 11% at 12 m: the noise of far seeds
# along their rays attenuates the tracked motion: with every point close
# (th_depth 25 m) chip_smoke.py phase 13 on an H100 gave a metric ATE of
# 0.086 m against 0.024 m scale-corrected
STEREO_TH_DEPTH = 12.0
# tests/test_stereo.py:223-243's KB8 rig: right camera 11 cm along the left
# one's x, slightly rotated (x_l = R_lr x_r + t_lr), its own intrinsics
RIG_CAM_L = (190.0, 190.0, 256.0, 256.0, 0.0035, 0.0007, -0.0037, 0.0007, 512, 512)
RIG_CAM_R = (190.5, 190.2, 255.0, 257.0, 0.0034, 0.0008, -0.0038, 0.0006, 512, 512)
RIG_PHI_LR = (0.01, -0.02, 0.005)
RIG_T_LR = (0.11, 0.002, -0.001)
# the rig run: tests/test_rig.py:182's scene (SMALL: its widths and 14
# frames) and the same scene at production widths
RIG_SMALL = dict(n_landmarks=900, extent=8.0, center=(0.0, 0.0, 4.0), desc_dim=32,
                 pad_to=256, max_per_frame=220, k_max=32, m_max=4096, gdesc_dim=64,
                 local_mp_cap=512, min_stereo_init_points=50, frames=14, step=(0.10, 0.02),
                 mapper=dict(ba_kf_cap=8, ba_mp_cap=1024, ba_edge_cap=4096, tri_neighbors=3))
RIG_PRODUCTION = dict(n_landmarks=3600, extent=10.0, center=(1.5, 0.0, 4.0), desc_dim=256,
                      pad_to=1024, max_per_frame=900, k_max=256, m_max=16384, gdesc_dim=4096,
                      local_mp_cap=2048, min_stereo_init_points=100, frames=60,
                      step=(0.05, 0.01),
                      mapper=dict(ba_kf_cap=16, ba_mp_cap=4096, ba_edge_cap=16384,
                                  tri_neighbors=5))
VI_BASELINE = 0.11  # EuRoC's stereo baseline


class PoseRig:
    """Extractor adapter of the stereo scenes: an "image" is (camera, R_cw,
    t_cw), and the camera index picks the FakeExtractor."""

    def __init__(self, *extractors):
        self.extractors = extractors

    def __call__(self, image):
        c, R, t = image
        return self.extractors[c](R, t)


def stereo_images(R, t, R_rl, t_rl):
    """The (left, right) "images" of a frame whose left camera has the
    world->camera pose (R, t): the right camera's is T_rl o T_lw."""
    R_r = (np.asarray(R_rl, np.float32) @ R).astype(np.float32)
    t_r = (np.asarray(R_rl, np.float32) @ t + np.asarray(t_rl, np.float32)).astype(np.float32)
    return (0, R, t), (1, R_r, t_r)


def rgbd_spec(size):
    """browse_spec with the close-depth threshold of tests/test_stereo.py's
    RGB-D run (th_depth 25 m): every landmark of the cloud counts as close."""
    sp = browse_spec(size)
    sp["tracker"].update(th_depth=25.0)
    return sp


def stereo_spec(size):
    """browse_spec on the rectified rig: a 0.1 m baseline, and close points
    within STEREO_TH_DEPTH."""
    sp = browse_spec(size)
    sp["system"]["baseline"] = STEREO_BASELINE
    sp["tracker"].update(th_depth=STEREO_TH_DEPTH)
    return sp


def depth_image(world, cam, R, t, frame, noise=DEPTH_NOISE, min_depth=0.3, max_depth=40.0):
    """(H, W) float32 depth map in metres of `world` seen from the pinhole
    `cam` at world->camera (R, t): every landmark in the extractor's depth
    band splats its depth, times 1 + N(0, noise) drawn per landmark from a
    generator seeded with `frame`, into the 3x3 pixels around its
    projection; where splats overlap the nearest wins; 0 elsewhere."""
    H, W = cam.height, cam.width
    fx, fy, cx, cy = (float(v) for v in cam.params[:4])
    pc = world.landmarks.astype(np.float64) @ np.asarray(R, np.float64).T + np.asarray(t)
    z = pc[:, 2] * (1 + np.random.default_rng(frame).normal(0, noise, len(pc)))
    ok = (pc[:, 2] > min_depth) & (pc[:, 2] < max_depth)
    u = np.round(fx * pc[ok, 0] / pc[ok, 2] + cx).astype(np.int64)
    v = np.round(fy * pc[ok, 1] / pc[ok, 2] + cy).astype(np.int64)
    zz = z[ok]
    img = np.full(H * W, np.inf)
    for du in (-1, 0, 1):
        for dv in (-1, 0, 1):
            uu, vv = u + du, v + dv
            inside = (uu >= 0) & (uu < W) & (vv >= 0) & (vv < H)
            np.minimum.at(img, vv[inside] * W + uu[inside], zz[inside])
    img[~np.isfinite(img)] = 0.0
    return img.reshape(H, W).astype(np.float32)


def rgbd_system(size, device=None, async_mapping=False):
    """(SLAMSystem, FakeExtractor) of rgbd_spec(size): feed it
    `track_rgbd((R, t), depth_image(ext.world, ext.cam, R, t, i), ts)`."""
    sp = rgbd_spec(size)
    sp["system"]["async_mapping"] = async_mapping
    return _system(sp, SyntheticWorld.cloud(**sp["world"]), device)


def _stereo_extractors(world, cam, ext_kw, device):
    left = FakeExtractor(world, cam, **ext_kw, device=device)
    right = FakeExtractor(world, cam, **dict(ext_kw, seed=ext_kw["seed"] + 1), device=device)
    return left, right


def stereo_system(size, device=None):
    """(SLAMSystem, left FakeExtractor) of stereo_spec(size), whose extractor
    is a PoseRig of the left and right cameras: feed it
    `track_stereo(*stereo_images(R, t, eye(3), (-0.1, 0, 0)), ts)`."""
    sp = stereo_spec(size)
    cam = cameras.pinhole(**sp["cam"], device=device)
    ext_l, ext_r = _stereo_extractors(SyntheticWorld.cloud(**sp["world"]), cam, sp["ext"],
                                      device)
    cfg = SystemConfig(**sp["system"], tracker=TrackerConfig(**sp["tracker"]),
                       mapper=MapperConfig(**sp["mapper"]))
    return SLAMSystem(cam, PoseRig(ext_l, ext_r), cfg, device=device), ext_l


def rig_spec(size):
    """Keyword arguments of the fisheye rig system at `size` (RIG_SMALL or
    RIG_PRODUCTION): tests/test_rig.py:182's cameras, extrinsic, extractor
    noise, depth band and tracker gates."""
    s = size
    return dict(
        cam_l=RIG_CAM_L, cam_r=RIG_CAM_R, phi_lr=RIG_PHI_LR, t_lr=RIG_T_LR,
        world=dict(seed=3, n_landmarks=s["n_landmarks"], extent=s["extent"],
                   center=s["center"], desc_dim=s["desc_dim"]),
        ext=dict(pad_to=s["pad_to"], noise_px=0.2, desc_noise=0.02,
                 max_landmarks_per_frame=s["max_per_frame"], seed=7, max_depth=5.0,
                 gdesc_dim=s["gdesc_dim"]),
        system=dict(k_max=s["k_max"], m_max=s["m_max"], n_slots=s["pad_to"],
                    desc_dim=s["desc_dim"], gdesc_dim=s["gdesc_dim"], loop_closing=False),
        tracker=dict(local_mp_cap=s["local_mp_cap"],
                     min_stereo_init_points=s["min_stereo_init_points"], th_depth=6.0),
        mapper=dict(s["mapper"]), frames=s["frames"], step=s["step"])


def rig_pose(i, step):
    """World->camera (R, t) of the rig's left camera at frame i: facing +z,
    sliding step = (dx, dy) metres a frame."""
    c = np.array([step[0] * i, step[1] * i, 0.0])
    return np.eye(3, dtype=np.float32), (-c).astype(np.float32)


def rig_extrinsic():
    """(R_lr, t_lr) of the rig, float32."""
    from . import lie

    R_lr = lie.so3_exp(torch.tensor(RIG_PHI_LR, dtype=torch.float32)).numpy()
    return R_lr.astype(np.float32), np.asarray(RIG_T_LR, np.float32)


def rig_system(size, device=None):
    """(SLAMSystem, left FakeExtractor, (R_rl, t_rl)) of rig_spec(size): the
    KB8 rig with cam_right and T_lr set. Feed it
    `track_stereo(*stereo_images(*rig_pose(i, size["step"]), R_rl, t_rl), ts)`."""
    sp = rig_spec(size)
    cam_l = cameras.kb8(*sp["cam_l"], device=device)
    cam_r = cameras.kb8(*sp["cam_r"], device=device)
    R_lr, t_lr = rig_extrinsic()
    world = SyntheticWorld.cloud(**sp["world"])
    ext_l = FakeExtractor(world, cam_l, **sp["ext"], device=device)
    ext_r = FakeExtractor(world, cam_r, **dict(sp["ext"], seed=8), device=device)
    cfg = SystemConfig(**sp["system"], baseline=float(np.linalg.norm(t_lr)), cam_right=cam_r,
                       T_lr=(R_lr, t_lr), tracker=TrackerConfig(**sp["tracker"]),
                       mapper=MapperConfig(**sp["mapper"]))
    sys_ = SLAMSystem(cam_l, PoseRig(ext_l, ext_r), cfg, device=device)
    return sys_, ext_l, (R_lr.T, (-R_lr.T @ t_lr).astype(np.float32))


def stereo_vi_spec(size):
    """vi_spec with a rectified right camera VI_BASELINE along x and the
    stereo browse's close-depth threshold."""
    sp = vi_spec(size)
    sp["system"]["baseline"] = VI_BASELINE
    sp["tracker"]["th_depth"] = STEREO_TH_DEPTH
    return sp


def stereo_vi_system(size, device=None):
    """(SLAMSystem, left FakeExtractor) of stereo_vi_spec(size),
    stereo-inertial: feed it `track_stereo_inertial(*stereo_images(
    *vi_frame_pose(t), eye(3), (-0.11, 0, 0)), t, synth_imu(t - dt, t, grav))`."""
    from .geometry import imu

    sp = stereo_vi_spec(size)
    cam = cameras.pinhole(**sp["cam"], device=device)
    ext_l, ext_r = _stereo_extractors(SyntheticWorld.cloud(**sp["world"]), cam, sp["ext"],
                                      device)
    cfg = SystemConfig(**sp["system"], tracker=TrackerConfig(**sp["tracker"]),
                       mapper=MapperConfig(**sp["mapper"]), vi=VIConfig(**sp["vi"]))
    return SLAMSystem(cam, PoseRig(ext_l, ext_r), cfg, imu_calib=imu.default_calib(**sp["imu"]),
                      device=device), ext_l


# ORB-SLAM3's Examples/RGB-D/TUM1.yaml camera (fr1 sequences), with the
# HF-Net extractor keys of the EuRoC settings
TUM1_CAM = dict(fx=517.306408, fy=516.469215, cx=318.643040, cy=255.313989, width=640,
                height=480)
TUM_RGBD_SETTINGS = """%YAML:1.0
File.version: "1.0"
Camera.type: "PinHole"
Camera1.fx: {fx}
Camera1.fy: {fy}
Camera1.cx: {cx}
Camera1.cy: {cy}
Camera1.k1: 0.262383
Camera1.k2: -0.953104
Camera1.p1: -0.005358
Camera1.p2: 0.002628
Camera1.k3: 1.163314
Camera.width: {width}
Camera.height: {height}
Camera.fps: 30
Camera.RGB: 1
Stereo.ThDepth: 40.0
Stereo.b: 0.07732
RGBD.DepthMapFactor: 5000.0
Extractor.type: "HFNetTPU"
Extractor.nFeatures: {n_features}
Extractor.nLevels: {n_levels}
Extractor.scaleFactor: {scale_factor}
Extractor.threshold: {threshold}
loopClosing: 0
"""
TUM_DEPTH_FACTOR = 5000.0
TUM_T0 = 1305031102.175304  # fr1/xyz's first rgb timestamp


def tum_plane_depth(h, w):
    """The synthetic sequence's depth in metres: a plane tilted along x,
    1.75 m at the left edge to 2.25 m at the right."""
    return np.broadcast_to(2.0 + 0.5 * (np.arange(w) / w - 0.5), (h, w)).astype(np.float64)


def write_tum_rgbd_sequence(out_dir, n_frames):
    """Write `n_frames` textured 640x480 frames (8-bit PNGs, the texture
    panning 4 px a frame) and their depth (16-bit PNGs of tum_plane_depth at
    factor 5000) in TUM RGB-D's layout under out_dir, with rgb.txt,
    depth.txt (depth stamped 10 ms after its image, as the sensor's two
    clocks) and a settings file out_dir/settings.yaml. Returns (sequence
    path, settings path, rgb timestamps in seconds)."""
    from .utils.datasets import write_png

    H, W = TUM1_CAM["height"], TUM1_CAM["width"]
    canvas = textured_image(np.random.default_rng(EUROC_TEXTURE_SEED), H,
                            W + EUROC_STEP_PX * n_frames)
    raw = np.round(tum_plane_depth(H, W) * TUM_DEPTH_FACTOR).astype(np.uint16)
    for sub in ("rgb", "depth"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
    rgb, dep, stamps = ["# color images"], ["# depth maps"], []
    for i in range(n_frames):
        ts = TUM_T0 + i / 30.0
        o = EUROC_STEP_PX * i
        write_png(os.path.join(out_dir, "rgb", f"{ts:.6f}.png"),
                  np.round(canvas[:, o:o + W]).astype(np.uint8))
        write_png(os.path.join(out_dir, "depth", f"{ts + 0.01:.6f}.png"), raw)
        rgb.append(f"{ts:.6f} rgb/{ts:.6f}.png")
        dep.append(f"{ts + 0.01:.6f} depth/{ts + 0.01:.6f}.png")
        stamps.append(float(f"{ts:.6f}"))
    for name, lines in (("rgb.txt", rgb), ("depth.txt", dep)):
        with open(os.path.join(out_dir, name), "w") as f:
            f.write("\n".join(lines) + "\n")
    settings = os.path.join(out_dir, "settings.yaml")
    with open(settings, "w") as f:
        f.write(TUM_RGBD_SETTINGS.format(**TUM1_CAM, **EUROC_HFNET))
    return out_dir, settings, np.asarray(stamps)


# ---------------------------------------------------------------------------
# CNN in the loop (bench.py's _cnn_metrics)
# ---------------------------------------------------------------------------

CNN_PRODUCTION = dict(width=640, height=480, n_features=675, n_levels=4, pad_to=1024,
                      n_steps=250, frames=120)
CNN_SMALL = dict(width=320, height=240, n_features=400, n_levels=2, pad_to=1024,
                 n_steps=100, frames=60)
CNN_TRAIN = dict(n_pairs=192, n_frames_cache=24)  # pose_range = the run's frames


def cnn_world(size, device=None) -> CylinderWorld:
    """The CylinderWorld of bench.py's CNN run (1400 blobs, seed 5) seen by
    a pinhole of focal 0.7 W at `size`."""
    W, H = size["width"], size["height"]
    cam = cameras.pinhole(0.70 * W, 0.70 * W, W / 2.0, H / 2.0, W, H, device=device)
    return CylinderWorld(cam, n_blobs=1400, seed=5)


def cnn_spec(n_slots, k_max=128, m_max=16384):
    """bench.py's RGB-D SystemConfig of the CNN run (:790-812) as plain
    data: loop closing off, 0.1 m virtual baseline, async mapping, the
    reference's 0.75 / 0.6 match gates."""
    return {
        "system": dict(k_max=k_max, m_max=m_max, n_slots=n_slots, desc_dim=256, gdesc_dim=4096,
                       loop_closing=False, baseline=0.1, async_mapping=True),
        "tracker": dict(local_mp_cap=2048, th_high=0.75, th_low=0.6, motion_window=8.0,
                        local_window=3.0, th_depth=30.0),
        "mapper": dict(ba_kf_cap=16, ba_mp_cap=4096, ba_edge_cap=16384, tri_neighbors=5),
    }


def cnn_system(size, device=None):
    """bench.py's CNN-in-the-loop system at `size` (CNN_PRODUCTION or
    CNN_SMALL) on `device` (None means CUDA): HF-Net from the port's seed-0
    init (selftrain.init_net) fine-tuned on the world, behind the HF-Net
    extractor (675 or 400 features, threshold 0.003, 1024 slots), and
    bench.py's RGB-D SystemConfig (`cnn_spec`).
    Returns (SLAMSystem, CylinderWorld, the training's stats); drive it
    with `cnn_run`."""
    dev = resolve(device)
    world = cnn_world(size, dev)
    trained, stats = selftrain.train(world, n_steps=size["n_steps"], pose_range=size["frames"],
                                     device=dev, **CNN_TRAIN)
    W, H, pad = size["width"], size["height"], size["pad_to"]
    ext = HFExtractor(trained, (H, W), n_features=size["n_features"],
                      n_levels=size["n_levels"], pad_to=pad, threshold=0.003, device=dev)
    sp = cnn_spec(pad)
    cfg = SystemConfig(**sp["system"], tracker=TrackerConfig(**sp["tracker"]),
                       mapper=MapperConfig(**sp["mapper"]))
    return SLAMSystem(world.cam, ext, cfg, device=dev), world, stats


def cnn_run(sys_, world, n_frames):
    """bench.py's CNN-in-the-loop run: n_frames of the orbit rendered first,
    extracted with their keypoint depth one frame ahead on a worker
    (utils/prefetch.pipeline_frames), tracked through track_features at
    0.05 s a frame. Leaves the system drained (finish()), not shut down.
    Returns bench.py's keys (cnn_e2e_fps from frame min(20, n/3) on,
    cnn_tracked_frac, cnn_lost, cnn_kf_count, cnn_inliers_p50, ate_cnn_m
    and cnn_path_m when more than 20 frames were tracked) and the run's
    `states` and `inliers` per frame."""
    import time

    from .evaluation import ate
    from .ops import stereo as S
    from .slam.tracking import LOST
    from .utils.prefetch import pipeline_frames

    frames = [world.render_rgbd(*world.orbit_pose(i)) for i in range(n_frames)]
    ext, dev, factor = sys_.extractor, sys_.device, sys_.cfg.depth_factor

    def extract_item(item):
        _, (img, dep) = item
        feats = ext(img)
        depth = S.depth_at_keypoints(torch.as_tensor(dep, device=dev), feats.xy, factor)
        return feats, depth.cpu().numpy()

    est, gtc, states, inliers = [], [], [], []
    warm = min(20, n_frames // 3)
    t0 = None
    for (i, _), (feats, depth) in pipeline_frames(extract_item, list(enumerate(frames))):
        if i == warm:
            t0 = time.perf_counter()
        R, t = world.orbit_pose(i)
        st, Re, te = sys_.track_features(feats, 0.05 * i, depth=depth)
        states.append(st)
        inliers.append(sys_.tracker.n_inliers)
        if Re is not None:
            est.append(-np.asarray(Re).T @ np.asarray(te))
            gtc.append(-R.T @ t)
    dt = time.perf_counter() - t0
    sys_.finish()
    out = {
        "cnn_e2e_fps": (n_frames - warm) / dt,
        "cnn_tracked_frac": len(est) / n_frames,
        "cnn_lost": sum(1 for s in states if s == LOST),
        "cnn_kf_count": int(sys_.store.kf_valid.sum()),
        "cnn_inliers_p50": float(np.percentile(np.asarray(inliers, float), 50)),
        "states": states, "inliers": inliers,
    }
    if len(est) > 20:
        out["ate_cnn_m"] = float(ate.ate_rmse(np.asarray(est), np.asarray(gtc),
                                              with_scale=False))
        out["cnn_path_m"] = float(np.linalg.norm(np.diff(np.asarray(gtc), axis=0),
                                                 axis=1).sum())
    return out
