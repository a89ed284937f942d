"""SLAM system facade: the public API of the port.

Counterpart of hfnet_slam_tpu/slam/system.py: construction
wires the extractor, tracker, local mapper and (with the reference's default
loop_closing=True) the loop closer around the atlas's active MapStore;
`track_monocular(image, t)` / `track_features(feats, t)` are the per-frame
entries; a loop-closer hit in another map welds the maps (`execute_merge`,
`weld_after_merge`). With `SystemConfig(async_mapping=True)` mapping, loop
closing and global BA run on worker threads (slam/pipeline.py) around one
map lock; `finish()` drains them and `shutdown()` stops them. The trajectory
savers write TUM, EuRoC or KITTI lines; `save_map` / `load_map` and
`save_atlas` / `load_atlas` use the reference's formats.

`SLAMSystem(cam, extractor, cfg, imu_calib=None, device=None)` runs on CUDA
(None) unless the caller passes device="cpu"; a CUDA request without a card
raises. Features it receives are moved to that device. With an `imu_calib`
(geometry/imu.ImuCalib) the system is visual-inertial (IMU_MONOCULAR):
`track_monocular_inertial(image, t, imu)` and `track_features(feats, t,
imu=rows)` take the (N,7) IMU rows covering (t_prev, t], a slam.vi.VIManager
runs the staged IMU initialization, and the mapper and loop closer switch
to their inertial solves once it has.

Stereo and RGB-D: `track_rgbd(image, depth_image, t)` samples the depth
map at the keypoints (ops/stereo.depth_at_keypoints, times
cfg.depth_factor); `track_stereo(left, right, t)` associates the two
images' features, along the rows of a rectified rig (`cfg.baseline`) or,
with `cfg.cam_right` and `cfg.T_lr` set, through each fisheye camera's own
model with triangulation, whose matched right keypoints become right-bank
observations with ToBody edges in BA; `track_stereo_inertial` adds the IMU
rows. The depth-edge weight base bf = fx * baseline (or the RGB-D virtual
baseline) reaches the tracker and the mapper in every mode; a monocular
frame carries no depth, so its edges carry no depth row.

`install_mesh(mesh)` (a parallel/multihost.Mesh) routes big global BAs
through the distributed Schur solver and large keyframe databases' place
recognition through the sharded scan, in this map and every later one.

`start_webviewer()` attaches the live in-browser viewer
(utils/webviewer.WebViewer), or `system.viewer = LiveViewer(...)` the PNG one
(utils/viewer.py): track_features hands it every frame first, and its step
gate may hold the frame there; `shutdown()` releases and closes it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import device as D
from ..geometry import cameras
from ..models.extractor import Features
from ..ops import stereo as S
from . import merging
from .atlas import Atlas
from .local_mapping import LocalMapper, MapperConfig
from .loop_closing import LoopCloser, LoopCloserConfig
from .map import MapStore
from .tracking import LOST, Tracker, TrackerConfig
from .vi import VIConfig, VIManager


@dataclasses.dataclass
class SystemConfig:
    """The reference's SystemConfig fields."""

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
    loop: LoopCloserConfig = dataclasses.field(default_factory=LoopCloserConfig)
    vi: VIConfig = dataclasses.field(default_factory=VIConfig)


class SLAMSystem:
    """Monocular, stereo and RGB-D SLAM, each with or without an IMU.
    `extractor(image) -> Features` is injected: the HF-Net pyramid extractor
    of models/extractor.py (the entry points take images), or the synthetic
    one of models/fake.py (whose "image" is the ground-truth pose)."""

    def __init__(self, cam: cameras.Camera, extractor, cfg: SystemConfig = None,
                 imu_calib=None, device=None):
        self.cfg = cfg or SystemConfig()
        self.device = D.resolve(device)
        self.imu_calib = imu_calib
        D.full_fp32()
        self.cam = cam.to(self.device)
        self.extractor = extractor
        c = self.cfg
        self.atlas = Atlas(c.k_max, c.m_max, c.n_slots, c.desc_dim, c.gdesc_dim)
        bf = self.cam.fx * (c.baseline if c.baseline > 0 else c.virtual_baseline)
        c.tracker.bf = bf
        c.mapper.bf = bf
        self.mapper = LocalMapper(self.cam, self.store, c.mapper, device=self.device)
        self.cam_right = None
        if c.cam_right is not None and c.T_lr is not None:
            # fisheye rig: right keypoints become observations with ToBody
            # edges in BA; the stored extrinsic is x_r = R_rl x_l + t_rl
            if c.cam_right.kind != cam.kind:
                raise ValueError("rig cameras must share the projection model kind")
            self.cam_right = c.cam_right.to(self.device)
            R_lr = np.asarray(c.T_lr[0], np.float32)
            t_lr = np.asarray(c.T_lr[1], np.float32)
            c.mapper.rig = (R_lr.T, -R_lr.T @ t_lr,
                            self.cam_right.params.cpu().numpy())
            self.store.enable_right_bank()
        self.loop_closer = (LoopCloser(self.cam, self.store, c.loop, mapper=self.mapper,
                                       device=self.device) if c.loop_closing else None)
        self.vi = (VIManager(imu_calib, self.store, c.vi, device=self.device)
                   if imu_calib is not None else None)
        if self.vi is not None:
            # the mapper's window BA goes inertial once the IMU is initialized,
            # and the staged init runs FullInertialBA through the mapper
            self.mapper.vim = self.vi
            self.vi.mapper = self.mapper
        self.tracker = Tracker(self.cam, self.store, c.tracker, mapper=self.mapper,
                               loop_closer=self.loop_closer, vi=self.vi, device=self.device)
        if self.loop_closer is not None:
            self.loop_closer.system = self  # enables cross-map merges
        self._traj_mark = 0
        self.viewer = None  # utils/viewer.LiveViewer or utils/webviewer.WebViewer
        self.worker = None
        self.loop_worker = None
        self.gba_worker = None
        if c.async_mapping:
            from .pipeline import GBAWorker, LoopWorker, MappingWorker

            self.worker = MappingWorker(self)
            self.tracker.worker = self.worker
            self.tracker.lock = self.worker.map_lock
            self.mapper.lock = self.worker.map_lock
            if self.loop_closer is not None:
                self.loop_closer.lock = self.worker.map_lock
                self.loop_closer.mapping_worker = self.worker
                # the LoopClosing thread: detection never blocks triangulation
                self.loop_worker = LoopWorker(self)
                # detached, abortable global BA: a correction returns at once
                self.gba_worker = GBAWorker(self.mapper)
                self.loop_closer.gba_worker = self.gba_worker

    @property
    def store(self) -> MapStore:
        return self.atlas.active

    def track_monocular(self, image, timestamp: float):
        """Feed one frame. Returns (state, R_cw, t_cw); the pose may be None."""
        return self.track_features(self.extractor(image), timestamp)

    def _stereo_depth(self, image_left, image_right):
        """Extract both images and associate them: (left Features, per-slot
        depth as numpy, the right frame for the right bank or None)."""
        fl = self.extractor(image_left).to(self.device)
        fr = self.extractor(image_right).to(self.device)
        if self.cam_right is not None:
            R_lr, t_lr = (torch.as_tensor(np.asarray(x, np.float32), device=self.device)
                          for x in self.cfg.T_lr)
            depth, idx, _ = S.match_stereo_fisheye(
                self.cam.kind, self.cam.params, self.cam_right.kind, self.cam_right.params,
                fl.xy, fl.desc, fl.octave, fl.mask, fr.xy, fr.desc, fr.octave, fr.mask,
                R_lr, t_lr)
            fr_host = Features(*(x.cpu().numpy() for x in fr))
            return fl, depth.cpu().numpy(), (fr_host, idx.cpu().numpy())
        depth, _ = S.match_stereo(fl.xy, fl.desc, fl.octave, fl.mask, fr.xy, fr.desc,
                                  fr.octave, fr.mask, fx=self.cam.fx, baseline=self.cfg.baseline)
        return fl, depth.cpu().numpy(), None

    def track_stereo(self, image_left, image_right, timestamp: float):
        """Stereo frame: extract both images, associate them for depth (rows of
        a rectified rig, or the fisheye rig's triangulation), then track."""
        fl, depth, right = self._stereo_depth(image_left, image_right)
        return self.track_features(fl, timestamp, depth=depth, right=right)

    def track_rgbd(self, image, depth_image, timestamp: float):
        """RGB-D frame: the registered depth map (raw units, times
        cfg.depth_factor) sampled at the keypoints."""
        feats = self.extractor(image).to(self.device)
        dimg = torch.as_tensor(np.asarray(depth_image, np.float32), device=self.device) \
            if not torch.is_tensor(depth_image) else depth_image.to(self.device, torch.float32)
        depth = S.depth_at_keypoints(dimg, feats.xy, self.cfg.depth_factor)
        return self.track_features(feats, timestamp, depth=depth.cpu().numpy())

    def track_monocular_inertial(self, image, timestamp: float, imu):
        """Mono-inertial frame: imu = (N,7) [ax ay az wx wy wz dt] rows
        covering (t_prev, t]."""
        return self.track_features(self.extractor(image), timestamp, imu=imu)

    def track_stereo_inertial(self, image_left, image_right, timestamp: float, imu):
        """Stereo-inertial frame: track_stereo's depth plus the (N,7) IMU rows.
        As the reference's, it hands no right observations to the tracker."""
        fl, depth, _ = self._stereo_depth(image_left, image_right)
        return self.track_features(fl, timestamp, depth=depth, imu=imu)

    def install_mesh(self, mesh, dist_min_kfs: int = 48, retrieval_min_kfs: int = 64):
        """Route big compute over `mesh` (parallel/multihost.Mesh): global BA
        of dist_min_kfs keyframes or more through the distributed Schur
        solver (parallel/dist_ba.py), and the place-recognition scan of a
        keyframe table of retrieval_min_kfs rows or more with its keyframe
        axis sharded (parallel/retrieval.py). Below those sizes nothing
        changes. Maps the atlas creates later inherit the mesh."""
        self.mapper.mesh = mesh
        self.mapper.dist_min_kfs = dist_min_kfs
        self._mesh = (mesh, dist_min_kfs, retrieval_min_kfs)
        for m in self.atlas.maps:
            m.retrieval_mesh = mesh
            m.retrieval_min_kfs = retrieval_min_kfs

    def track_features(self, feats, timestamp: float, depth=None, imu=None, right=None):
        """Feed pre-extracted features (testing / offline pipelines), with the
        frame's per-slot depth (numpy, 0 = none), its IMU rows on a
        visual-inertial system, and on a fisheye rig the right frame's
        (Features as numpy, left->right match) for the right bank. An
        attached viewer sees every frame first; its step gate may block
        here."""
        if self.viewer is not None:
            self.viewer.on_frame(self.store, self.tracker)
        feats = feats.to(self.device)
        if self.cam.dist is not None:
            # depth was sampled at the raw pixel, where the sensor measured it
            feats = feats._replace(xy=self.cam.undistort(feats.xy))
        out = self.tracker.track(feats, timestamp, depth=depth, imu=imu, right=right)
        if out[0] == LOST:
            self._handle_lost()
        return out

    def finish(self):
        """Drain the mapping, loop and GBA queues in topological order
        (mapping feeds loop, loop feeds GBA) and raise a worker's exception
        again; a no-op in the synchronous pipeline. Call it before reading
        the final map or saving trajectories."""
        for w in (self.worker, self.loop_worker, self.gba_worker):
            if w is not None:
                w.drain()

    def start_webviewer(self, host="127.0.0.1", port=0, **kw):
        """Start the live in-browser viewer (utils/webviewer.WebViewer; the
        reference's Pangolin thread) and attach it as this system's frame
        hook; in async mode it snapshots under the map lock. Returns the
        viewer: open `viewer.url` in a browser."""
        from ..utils.webviewer import WebViewer

        lock = self.worker.map_lock if self.worker is not None else None
        self.viewer = WebViewer(host=host, port=port, lock=lock, **kw)
        return self.viewer

    def shutdown(self):
        """System::Shutdown: release and close the viewer (a gated tracker
        would hang the drain), then drain and stop the worker threads, in
        finish()'s order."""
        if self.viewer is not None and hasattr(self.viewer, "close"):
            self.viewer.release()
            self.viewer.close()
        for w in (self.worker, self.loop_worker, self.gba_worker):
            if w is not None:
                w.drain()
                w.stop()

    def activate_localization_mode(self):
        """Track against the frozen map: no keyframes, so no mapping or loop
        closing."""
        with self.tracker.lock:
            self.tracker.localization_only = True

    def deactivate_localization_mode(self):
        with self.tracker.lock:
            self.tracker.localization_only = False

    def _handle_lost(self):
        """A mature map is stored and a fresh one starts; an immature one
        (<= mature_map_kfs keyframes) is discarded in place."""
        with self.tracker.lock:
            if self.store.kf_valid.sum() > self.cfg.tracker.mature_map_kfs:
                store = self.atlas.create_new_map()
            else:
                store = self.atlas.reset_active_map()
            self._rewire(store)
            self.tracker.reset_for_new_map(store)
            self._traj_mark = len(self.tracker.trajectory)

    def _rewire(self, store):
        if getattr(self, "_mesh", None) is not None:  # a new map inherits the mesh
            store.retrieval_mesh = self._mesh[0]
            store.retrieval_min_kfs = self._mesh[2]
        if self.cfg.mapper.rig is not None:
            store.enable_right_bank()  # fresh maps of a rig keep their ToBody edges
        self.mapper.store = store
        self.mapper.recent_points = []
        self.mapper.kf_born = {}
        self.tracker.store = store
        if self.loop_closer is not None:
            self.loop_closer.store = store
            self.loop_closer._reset_pending()
        if self.vi is not None:
            self.vi.store = store

    # ------------------------------------------------------------------
    def execute_merge(self, target_idx: int, k: int, cand: int, R_cm, t_cm, s_cm, win_mps):
        """Weld the active map into atlas map `target_idx` through the
        matched Sim3 (LoopClosing::MergeLocal; between two IMU-initialized
        maps the inertial MergeLocal2 gates: scale within 0.90-1.1, and after
        VIBA1 a yaw-only weld at unit scale). Returns keyframe k's id in the
        merged map, or False."""
        active = self.store
        target = self.atlas.maps[target_idx]
        G = merging.compute_world_transform(active, target, k, cand, R_cm, t_cm, s_cm)
        if active.imu_initialized and target.imu_initialized:
            Rg, tg, sg = G
            if not (0.90 <= sg <= 1.1):
                return False  # "scale bad estimated. Abort merging"
            if active.viba1:
                from .. import lie

                phi = lie.so3_log(torch.as_tensor(np.asarray(Rg, np.float32))).numpy()
                phi[0] = 0.0
                phi[1] = 0.0
                G = (lie.so3_exp(torch.as_tensor(phi)).numpy(), tg, 1.0)
        kf_remap, _ = merging.merge_into(active, target, G)
        if k not in kf_remap:
            return False
        k_new = kf_remap[k]
        for b in kf_remap.values():
            target.update_covisibility(b)
        # the target becomes active, the absorbed map is dropped
        self.atlas.maps = [m for m in self.atlas.maps if m is not active]
        self.atlas.active_idx = self.atlas.index_of(target)
        self._rewire(target)

        tr = self.tracker
        tr.ref_kf = k_new
        tr.velocity = None
        if tr.last_frame is not None:
            tr.last_frame.R = target.kf_R[k_new].copy()
            tr.last_frame.t = target.kf_t[k_new].copy()
            tr.last_frame.obs = target.kf_obs[k_new].copy()
        target.bump_change()
        tr._vi_state = None
        if self.vi is not None:
            # the chain preintegrations follow their keyframes (body-frame
            # quantities, invariant to the world transform)
            tr._last_kf = k_new
            self.vi.store = target
            self.vi.kf_pre = {kf_remap[a]: p for a, p in self.vi.kf_pre.items() if a in kf_remap}
            self.vi.kf_meas = {kf_remap[a]: m for a, m in self.vi.kf_meas.items()
                               if a in kf_remap}
            tr._imu_since_kf = []
        # the trajectory recorded in the absorbed map moves into the target
        # frame; reference-keyframe links follow the transplanted keyframes
        # (relative translations rescale by 1/s)
        Rg, tg, sg = G
        for e in tr.trajectory[self._traj_mark:]:
            R_new = e.R @ Rg.T
            e.R, e.t = R_new, e.t / sg - R_new @ (tg / sg)
            if e.store is active and e.ref_uid >= 0:
                old_slot = active._uid_slot.get(int(e.ref_uid))
                new_slot = kf_remap.get(old_slot) if old_slot is not None else None
                if new_slot is None:
                    e.store = None  # chain broken; the absolute pose stands
                else:
                    e.store = target
                    e.ref_uid = int(target.kf_uid[new_slot])
                    e.t_rel = e.t_rel / sg
            elif e.store is active:
                e.store = None
        return k_new

    def weld_after_merge(self, k_new: int, win_mps) -> None:
        """The welding passes after a merge: seam fuse, window BA, global
        polish with the oldest keyframe fixed. Called without the map lock:
        each stage takes it for its host work, so tracking overlaps the
        solves (mapping stays paused by the caller)."""
        target = self.store
        if self.loop_closer is not None:
            with self.loop_closer.lock:
                if target is self.store and target.kf_valid[k_new]:
                    window = [k_new] + [int(j) for j in target.covisible_kfs(
                        k_new, n=8, min_weight=1)]
                    self.loop_closer._fuse_loop_points(window, np.asarray(win_mps))
        if target.imu_initialized and self.mapper.vim is not None:
            # MergeInertialBA: the inertial window BA around the weld
            self.mapper.local_inertial_ba(k_new, self.mapper.vim)
            return
        self.mapper.local_ba(k_new)
        lc = self.cfg.loop
        self.mapper.run_global_ba(fixed_ids=[int(target.valid_kf_ids()[0])],
                                  rounds=lc.gba_rounds, kf_cap=lc.gba_kf_cap,
                                  mp_cap=lc.gba_mp_cap, edge_cap=lc.gba_edge_cap)

    @property
    def trajectory(self):
        return self.tracker.trajectory

    def trajectory_tum(self) -> str:
        """TUM lines `t tx ty tz qx qy qz qw` (camera-to-world) of every
        tracked frame, rebuilt through its reference keyframe so that loop and
        GBA corrections reach it (System::SaveTrajectoryTUM)."""
        from ..utils import trajectory as TJ

        return "\n".join(TJ.tum_lines(TJ.recovered(self.tracker.trajectory))) + "\n"

    def save_trajectory(self, path, fmt: str = "tum"):
        """fmt: tum | euroc | kitti (SaveTrajectory{TUM,EuRoC,KITTI})."""
        from ..utils import trajectory as TJ

        TJ.save(path, self.tracker.trajectory, fmt)

    def save_keyframe_trajectory(self, path, fmt: str = "tum"):
        """SaveKeyFrameTrajectoryTUM: the active map's keyframe poses."""
        from ..utils import trajectory as TJ

        TJ.save(path, TJ.keyframe_trajectory(self.store), fmt)

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

    def save_atlas(self, path):
        """Whole-session snapshot (SaveAtlas): every map plus a manifest with
        md5 sums, in the reference's format."""
        self.atlas.save(path)

    def load_atlas(self, path):
        """Replace the atlas with a snapshot written by either package's
        save_atlas; raises IOError when a map file's md5 differs."""
        self.atlas = Atlas.load(path)
        self._rewire(self.atlas.active)
