"""SLAM system facade: the public API of the port.

Counterpart of hfnet_slam_tpu/slam/system.py in its synchronous monocular
form: construction wires the extractor, tracker and local mapper around one
MapStore; `track_monocular(image, t)` / `track_features(feats, t)` are the
per-frame entries; `save_map` / `load_map` use the reference's .npz format.

`SLAMSystem(cam, extractor, cfg, device=None)` runs on CUDA (None) unless the
caller passes device="cpu"; a CUDA request without a card raises. Features
it receives are moved to that device. Configurations outside this slice
raise NotImplementedError naming their ROADMAP.md item.
"""
from __future__ import annotations

import dataclasses

from .. import device as D
from ..geometry import cameras
from .atlas import Atlas
from .local_mapping import LocalMapper, MapperConfig
from .map import MapStore
from .tracking import LOST, Tracker, TrackerConfig


@dataclasses.dataclass
class SystemConfig:
    """The reference's SystemConfig fields. `loop` and `vi` stay None until
    the loop-closing and visual-inertial slices bring their configs."""

    k_max: int = 256
    m_max: int = 32768
    n_slots: int = 1024
    desc_dim: int = 256
    gdesc_dim: int = 4096
    loop_closing: bool = True
    async_mapping: bool = False
    baseline: float = 0.0
    depth_factor: float = 1.0
    cam_right: object = None
    T_lr: object = None
    virtual_baseline: float = 0.08
    tracker: TrackerConfig = dataclasses.field(default_factory=TrackerConfig)
    mapper: MapperConfig = dataclasses.field(default_factory=MapperConfig)
    loop: object = None
    vi: object = None


def _check_slice(cfg: SystemConfig, imu_calib):
    if cfg.loop_closing:
        raise NotImplementedError(
            "loop closing is ROADMAP.md Queue 1 item 14; pass "
            "SystemConfig(loop_closing=False)")
    if cfg.async_mapping:
        raise NotImplementedError(
            "the async mapping/loop pipeline is ROADMAP.md Queue 1 item 14")
    if imu_calib is not None:
        raise NotImplementedError("visual-inertial SLAM is ROADMAP.md Queue 1 item 15")
    if cfg.baseline > 0 or cfg.cam_right is not None or cfg.T_lr is not None:
        raise NotImplementedError("stereo / RGB-D SLAM is ROADMAP.md Queue 1 item 16")


class SLAMSystem:
    """Monocular SLAM. `extractor(image) -> Features` is injected (the fake
    extractor of models/fake.py in this slice)."""

    def __init__(self, cam: cameras.Camera, extractor, cfg: SystemConfig = None,
                 imu_calib=None, device=None):
        self.cfg = cfg or SystemConfig()
        _check_slice(self.cfg, imu_calib)
        self.device = D.resolve(device)
        D.full_fp32()
        self.cam = cam.to(self.device)
        self.extractor = extractor
        c = self.cfg
        self.atlas = Atlas(c.k_max, c.m_max, c.n_slots, c.desc_dim, c.gdesc_dim)
        bf = self.cam.fx * (c.baseline if c.baseline > 0 else c.virtual_baseline)
        c.tracker.bf = bf
        c.mapper.bf = bf
        self.mapper = LocalMapper(self.cam, self.store, c.mapper, device=self.device)
        self.tracker = Tracker(self.cam, self.store, c.tracker, mapper=self.mapper,
                               device=self.device)
        self._traj_mark = 0

    @property
    def store(self) -> MapStore:
        return self.atlas.active

    def track_monocular(self, image, timestamp: float):
        """Feed one frame. Returns (state, R_cw, t_cw); the pose may be None."""
        return self.track_features(self.extractor(image), timestamp)

    def track_stereo(self, image_left, image_right, timestamp: float):
        raise NotImplementedError("stereo SLAM is ROADMAP.md Queue 1 item 16")

    def track_rgbd(self, image, depth_image, timestamp: float):
        raise NotImplementedError("RGB-D SLAM is ROADMAP.md Queue 1 item 16")

    def track_monocular_inertial(self, image, timestamp: float, imu):
        raise NotImplementedError("visual-inertial SLAM is ROADMAP.md Queue 1 item 15")

    def track_features(self, feats, timestamp: float):
        """Feed pre-extracted features (testing / offline pipelines)."""
        feats = feats.to(self.device)
        if self.cam.dist is not None:
            feats = feats._replace(xy=self.cam.undistort(feats.xy))
        out = self.tracker.track(feats, timestamp)
        if out[0] == LOST:
            self._handle_lost()
        return out

    def finish(self):
        """Drain pending work (a no-op in the synchronous pipeline)."""

    def shutdown(self):
        """Nothing to stop in the synchronous pipeline."""

    def activate_localization_mode(self):
        self.tracker.localization_only = True

    def deactivate_localization_mode(self):
        self.tracker.localization_only = False

    def _handle_lost(self):
        """A mature map is stored and a fresh one starts; an immature one
        (<= mature_map_kfs keyframes) is discarded in place."""
        if self.store.kf_valid.sum() > self.cfg.tracker.mature_map_kfs:
            store = self.atlas.create_new_map()
        else:
            store = self.atlas.reset_active_map()
        self._rewire(store)
        self.tracker.reset_for_new_map(store)
        self._traj_mark = len(self.tracker.trajectory)

    def _rewire(self, store):
        self.mapper.store = store
        self.mapper.recent_points = []
        self.mapper.kf_born = {}
        self.tracker.store = store

    @property
    def trajectory(self):
        return self.tracker.trajectory

    def save_map(self, path):
        """Single-map .npz snapshot of the active map (the reference format)."""
        self.store.save(path)

    def load_map(self, path):
        """Replace the active map with a .npz snapshot written by either
        package's save_map."""
        from ..convert import store_from_reference

        store = store_from_reference(path)
        self.atlas.maps[self.atlas.active_idx] = store
        self._rewire(store)
