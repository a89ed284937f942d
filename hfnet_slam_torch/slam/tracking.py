"""Per-frame tracking: the SLAM front-end state machine.

Counterpart of hfnet_slam_tpu/slam/tracking.py. The irregular state machine
stays in host Python and numpy; every per-frame compute block (projection
and brute-force matching, pose optimization, the fused track_step) runs on
the tracker's device. States: NOT_INITIALIZED -> OK -> (RECENTLY_)LOST; a
track lost on a mature map relocalizes (global retrieval, brute-force
matching through the row_top2 kernel on CUDA, batched PnP RANSAC, pose
optimization). Each new keyframe goes to the local mapper and then to the
loop closer: inline in the synchronous pipeline, through the mapping
worker's queue in the async one (slam/pipeline.py). There the tracker holds
the map lock for a frame and releases it around its device work, whose
inputs it copies under the lock; a solve that a whole-map move
(store.big_change_idx) overtook is discarded.

Visual-inertial mode (`vi`, a slam.vi.VIManager): each frame's IMU block
is buffered since the last keyframe. Once the IMU is initialized every frame
takes the staged path (the fused program is visual-only): the IMU
prediction seeds the motion-model search, the 15-d state is solved by
optim/inertial (anchored on the last frame with the marginal prior while the
map stands still, else on the last keyframe), a missed projection search
falls back to the reference keyframe through the brute-force kernel from
the IMU prediction, and a visual blackout dead-reckons on the IMU while
RECENTLY_LOST.

Stereo and RGB-D: a frame may carry a per-slot depth (0 = none) and, on a
fisheye rig, the right frame's features with the left->right match. The
first frame with enough close depths seeds a metric map
(StereoInitialization); observations with depth get the pixel-equivalent
depth row (weight bf / z^2) in the pose solves and the fused step; the
keyframe policy takes the depth sensors' branches; and each keyframe seeds
up to max_depth_points_per_kf of its nearest close points on free slots and
stores its matched right keypoints in the map's right bank.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import device as D
from .. import lie
from ..geometry import cameras, twoview
from ..models.extractor import Features
from ..ops import matching as M
from ..optim import inertial as VIOPT
from ..optim import pnp, pose_opt
from ..utils.timing import timings
from . import fused, retrieval, search
from .map import MapStore
from .pipeline import NULL_LOCK

NOT_INITIALIZED = 0
OK = 1
LOST = 2
RECENTLY_LOST = 3

_STATE_NAMES = {0: "NOT_INITIALIZED", 1: "OK", 2: "LOST", 3: "RECENTLY_LOST"}


def _orthonormalize_np(R):
    """Nearest rotation (Frobenius) via SVD for the host-side motion model."""
    U, _, Vt = np.linalg.svd(R.astype(np.float64))
    W = U @ Vt
    if np.linalg.det(W) < 0:
        U[:, -1] = -U[:, -1]
        W = U @ Vt
    return W.astype(np.float32)


@dataclasses.dataclass
class TrackerConfig:
    """The reference's TrackerConfig, field for field."""

    motion_window: float = 15.0
    motion_window_retry: float = 30.0
    local_window: float = 4.0
    init_window: float = 100.0
    th_high: float = 0.75
    th_low: float = 0.6
    min_init_matches: int = 100
    init_match_max_dist: float = 0.6
    init_match_ratio: float = 0.9
    min_motion_matches: int = 20
    min_ref_matches: int = 15
    min_pose_inliers: int = 10
    min_local_inliers: int = 30
    max_frames_between_kf: int = 10
    min_frames_between_kf: int = 0
    kf_ref_ratio: float = 0.9
    min_reloc_matches: int = 15
    min_reloc_pnp_inliers: int = 10
    min_reloc_inliers: int = 50
    recently_lost_frames: int = 60
    mature_map_kfs: int = 10
    pnp_hyps: int = 256
    th_depth: float = 35.0
    th_far: float = 0.0
    min_stereo_init_points: int = 100
    max_depth_points_per_kf: int = 100
    bf: float = 0.0
    local_mp_cap: int = 4096
    min_init_points: int = 60
    min_init_med_parallax_deg: float = 1.5
    vi_marg_prior: bool = True


@dataclasses.dataclass
class TrajEntry:
    """One tracked frame: the absolute pose at track time plus its pose
    relative to the reference keyframe, so later corrections reach it."""

    ts: float
    R: np.ndarray
    t: np.ndarray
    store: object = None
    ref_uid: int = -1
    R_rel: Optional[np.ndarray] = None
    t_rel: Optional[np.ndarray] = None

    def __iter__(self):
        return iter((self.ts, self.R, self.t))

    def recovered_pose(self):
        if self.store is None or self.ref_uid < 0 or self.R_rel is None:
            return self.R, self.t
        hit = self.store.resolve_uid(int(self.ref_uid))
        if hit is None:
            return self.R, self.t
        slot, R_ch, t_ch = hit
        R_ref = R_ch @ self.store.kf_R[slot]
        t_ref = R_ch @ self.store.kf_t[slot] + t_ch
        return self.R_rel @ R_ref, self.R_rel @ t_ref + self.t_rel


@dataclasses.dataclass
class Frame:
    feats: Features                     # tensors on the tracker's device
    timestamp: float
    R: Optional[np.ndarray] = None      # world->cam, float32
    t: Optional[np.ndarray] = None
    obs: Optional[np.ndarray] = None    # (N_slots,) mp id or -1
    depth: Optional[np.ndarray] = None  # (N_slots,) stereo/RGB-D depth, 0 = none
    v: Optional[np.ndarray] = None      # body velocity (visual-inertial mode)
    # fisheye rig: (right Features, left slot -> right slot match) as numpy
    right: Optional[tuple] = None
    _host: Optional[Features] = None

    @property
    def host(self) -> Features:
        """numpy copy of the features, made once per frame."""
        if self._host is None:
            self._host = Features(*(x.cpu().numpy() for x in self.feats))
        return self._host

    @property
    def n_feats(self):
        return int(self.host.mask.sum())


class Tracker:
    def __init__(self, cam: cameras.Camera, store: MapStore, cfg: TrackerConfig = None,
                 mapper=None, loop_closer=None, vi=None, rng_seed: int = 0, device=None):
        self.device = D.resolve(device)
        self.cam = cam.to(self.device)
        self.store = store
        self.cfg = cfg or TrackerConfig()
        self.mapper = mapper
        self.loop_closer = loop_closer
        self.vi = vi
        self._imu_since_kf: list = []  # raw (N,7) blocks since the last keyframe
        self._last_kf = -1
        # LastFrame anchoring: the previous frame's optimized body state and
        # the 15x15 marginal prior carried between solves; both reset when
        # the map moves (map_change_idx, the reference's mbMapUpdated)
        self._vi_state = None
        self._vi_prior = None
        self._cur_imu_block = None
        self._seen_change = -1
        self._anchor_fid = -1
        self._frame_anchor = None
        self._frame_anchor_prior = None
        self.state = NOT_INITIALIZED
        self.last_frame: Optional[Frame] = None
        self.init_ref: Optional[Frame] = None
        self.velocity = None  # (R_v, t_v): T_cur = T_v o T_last
        self.ref_kf = -1
        self.frames_since_kf = 0
        self.frame_id = 0
        self.n_inliers = 0
        self.frames_lost = 0
        self.n_relocalizations = 0
        # RANSAC samples for two-view init: a generator seeded the way the
        # reference seeds its PRNG key (tracking.py:196)
        self._gen = torch.Generator().manual_seed(
            int(np.random.default_rng(rng_seed).integers(0, 2**31)))
        self.trajectory = []
        c = self.cfg
        self._fused_cfg = fused.FusedConfig(
            motion_window=c.motion_window, motion_window_retry=c.motion_window_retry,
            local_window=c.local_window, th_high=c.th_high,
            min_motion_matches=c.min_motion_matches)
        self._local_ids = None
        self._seen_big = -1
        # async pipeline wiring (slam/pipeline.py): SLAMSystem sets the
        # shared map lock and the mapping worker the keyframes go to
        self.lock = NULL_LOCK
        self.worker = None
        self.localization_only = False

    def _t(self, x, dtype=torch.float32):
        """Host array -> a copy on the tracker's device (device.upload)."""
        return D.upload(x, dtype, self.device)

    # ------------------------------------------------------------------
    def reset_for_new_map(self, store: MapStore):
        self.store = store
        self.state = NOT_INITIALIZED
        self.last_frame = None
        self.init_ref = None
        self.velocity = None
        self.ref_kf = -1
        self.frames_since_kf = 0
        self.frames_lost = 0
        self.n_inliers = 0
        self._seen_big = -1
        self._local_ids = None
        self._imu_since_kf = []
        self._last_kf = -1
        self._vi_state = None
        self._vi_prior = None
        self._seen_change = -1
        self._anchor_fid = -1
        if self.vi is not None:
            self.vi.reset(store)

    # ------------------------------------------------------------------
    def track(self, feats: Features, timestamp, depth=None, imu=None, right=None):
        """Main entry. depth: optional (N_slots,) per-keypoint depth (stereo or
        RGB-D); imu: optional (N,7) [ax ay az wx wy wz dt] rows covering
        (t_prev, t]; right: optional (right Features, left->right match idx)
        of a fisheye rig. Returns (state, R, t); the pose may be None."""
        with timings.span("track"):
            with timings.span("track.lock"):
                if (self.worker is not None and self.vi is not None
                        and not self.store.imu_initialized):
                    # until the IMU is initialized a frame starts only once
                    # the mapping worker took the last keyframe: the staged
                    # init runs when its keyframe is due, on locally mapped
                    # keyframes (a queued keyframe skips its local BA)
                    self.worker.wait_queue_below(1)
                self.lock.acquire()
            try:
                return self._track(feats, timestamp, depth, imu, right)
            finally:
                self.lock.release()

    def _track(self, feats, timestamp, depth=None, imu=None, right=None):
        big = self.store.big_change_idx
        if big != self._seen_big:
            if self._seen_big >= 0:
                self.velocity = None
                self._vi_state = None
                self._vi_prior = None
            self._seen_big = big
        if self.vi is not None and self.vi.bad_imu:
            # the mapper flagged an IMU init without enough motion: reset the
            # active map (Tracking.cc:1108-1114)
            self.state = LOST
            self.frame_id += 1
            return self.state, None, None
        if depth is not None:
            depth = np.asarray(depth)
            if self.cfg.th_far > 0:  # System.thFarPoints
                depth = np.where(depth > self.cfg.th_far, 0.0, depth)
        frame = Frame(feats=feats, timestamp=timestamp, depth=depth, right=right)
        if self.last_frame is not None and self.state == OK:
            dt = timestamp - self.last_frame.timestamp
            max_gap = 1.0 if self.vi is not None else 5.0
            if dt < 0 or dt > max_gap:  # timestamp-jump guard (Tracking.cc:1122)
                self.state = LOST
                self.frame_id += 1
                return self.state, None, None
        if self.vi is not None and imu is not None and len(imu):
            self._cur_imu_block = np.asarray(imu, np.float32)
            self._imu_since_kf.append(self._cur_imu_block)
        else:
            self._cur_imu_block = None
        if self.state == NOT_INITIALIZED:
            with timings.span("track.init"):
                if frame.depth is not None:
                    self._stereo_initialization(frame)
                else:
                    self._monocular_initialization(frame)
        elif self.state == OK:
            # the fused program is visual-only: an initialized IMU takes the
            # staged path
            vi_active = self._vi_active()
            handled = False if vi_active else self._track_fused(frame)
            if not handled:
                if not vi_active:
                    timings.count("fallbacks")
                with timings.span("track.fallback"):
                    if self._track_frame(frame):
                        self._track_local_map(frame)
                    else:
                        frame.R = None
                        frame.t = None
            if frame.R is None:
                self._on_tracking_failure()
            else:
                with timings.span("track.kf_decision"):
                    need = not self.localization_only and self._need_new_keyframe(frame)
                if need:
                    with timings.span("track.keyframe"):
                        self._create_keyframe(frame)
                self.last_frame = frame
        elif self.state == RECENTLY_LOST and self._vi_active():
            with timings.span("track.fallback"):
                self._track_recently_lost_vi(frame)
        elif self.state == RECENTLY_LOST:
            with timings.span("track.fallback"):
                relocalized = self._relocalize(frame)
                if relocalized:
                    self.state = OK
                    self._track_local_map(frame)
            if relocalized:
                if frame.R is not None:
                    self.last_frame = frame
                    self.frames_since_kf = self.cfg.max_frames_between_kf  # re-anchor soon
                else:
                    self._on_tracking_failure()
            else:
                self.frames_lost += 1
                if self.frames_lost > self.cfg.recently_lost_frames:
                    self.state = LOST
        if frame.R is not None:
            self.trajectory.append(self._traj_entry(frame, timestamp))
        self.frame_id += 1
        return self.state, frame.R, frame.t

    def _traj_entry(self, frame, timestamp) -> TrajEntry:
        store = self.store
        e = TrajEntry(timestamp, frame.R.copy(), frame.t.copy())
        k = self.ref_kf
        if k >= 0 and store.kf_valid[k]:
            R_rel = frame.R @ store.kf_R[k].T
            e.store = store
            e.ref_uid = int(store.kf_uid[k])
            e.R_rel = R_rel
            e.t_rel = frame.t - R_rel @ store.kf_t[k]
        return e

    def _track_recently_lost_vi(self, frame):
        """IMU dead reckoning through a visual dropout (Tracking.cc:1285-1316):
        each frame tries visual re-acquisition from the IMU prediction; a
        recovery counts only with min_local_inliers (a keyframe from a barely
        passing pose poisons the chain); otherwise the predicted pose is
        published, until recently_lost_frames have passed."""
        recovered = False
        if self.last_frame is not None and self.last_frame.obs is not None:
            recovered = self._track_frame(frame)
            if recovered:
                self._track_local_map(frame)
                recovered = frame.R is not None and self.n_inliers >= self.cfg.min_local_inliers
        if recovered:
            self.state = OK
            self.frames_lost = 0
            self.last_frame = frame
            return
        frame.R, frame.t = self._predicted_pose()
        frame.obs = np.full(self.store.n_slots, -1, np.int32)
        self._vi_state = None  # the LastFrame anchor is stale: anchor on the KF next
        self.frames_lost += 1
        if self.frames_lost > self.cfg.recently_lost_frames:
            frame.R = None
            frame.t = None
            self.state = LOST

    def _on_tracking_failure(self):
        """OK -> RECENTLY_LOST on a mature or IMU-initialized map, else LOST."""
        self._vi_prior = None
        if self._vi_active() or self.store.kf_valid.sum() > self.cfg.mature_map_kfs:
            self.state = RECENTLY_LOST
            self.frames_lost = 0
        else:
            self.state = LOST

    # ------------------------------------------------------------------
    # initialization
    # ------------------------------------------------------------------
    def _monocular_initialization(self, frame: Frame):
        cfg = self.cfg
        if self.init_ref is None or self.init_ref.n_feats < cfg.min_init_matches:
            self.init_ref = frame
            self._imu_since_kf = []  # the buffer spans init_ref -> now
            return
        ref = self.init_ref
        rf, ff = ref.feats, frame.feats

        def run_search():  # frame-owned inputs: no store access
            idx, _ = search.search_for_initialization(
                rf.xy, rf.desc, rf.mask, ff.xy, ff.desc, ff.mask,
                window=cfg.init_window, max_dist=cfg.init_match_max_dist,
                ratio=cfg.init_match_ratio)
            return idx.cpu().numpy()

        # the (re)init attempts touch no store state: holding the lock
        # through them starves the mapping worker of the fresh map
        idx = self._unlocked(run_search)
        n_matches = int((idx >= 0).sum())
        if n_matches < cfg.min_init_matches:
            self.init_ref = frame
            self._imu_since_kf = []
            return

        slots1 = np.nonzero(idx >= 0)[0]
        slots2 = idx[slots1]
        xn1 = self.cam.unproject(rf.xy)[:, :2].cpu().numpy()
        xn2 = self.cam.unproject(ff.xy)[:, :2].cpu().numpy()
        N = len(idx)
        m1 = np.zeros((N, 2), np.float32)
        m2 = np.zeros((N, 2), np.float32)
        m1[: len(slots1)] = xn1[slots1]
        m2[: len(slots1)] = xn2[slots2]
        mask = self._t(np.arange(N) < len(slots1), torch.bool)
        m1_t, m2_t = self._t(m1), self._t(m2)

        def run_ransac():  # device-heavy H/F RANSAC: no store access
            samples = twoview.draw_samples(mask, 200, self._gen)
            res = twoview.reconstruct_two_views(m1_t, m2_t, mask, samples, 1.0 / self.cam.fx)
            return {k: v.cpu().numpy() for k, v in res.items()}

        res = self._unlocked(run_ransac)
        if (not bool(res["ok"]) or int(res["n_good"]) < cfg.min_init_points
                or float(res["med_parallax_deg"]) < cfg.min_init_med_parallax_deg):
            return
        self._create_initial_map(ref, frame, slots1, slots2, res["good"],
                                 res["R21"], res["t21"], res["points"])

    def _create_initial_map(self, ref, frame, slots1, slots2, good, R21, t21, p3d):
        """CreateInitialMapMonocular: two KFs, points, init BA, median-depth
        scale normalization."""
        store = self.store
        g = np.nonzero(good[: len(slots1)])[0]
        pts = p3d[g]
        s1 = slots1[g]
        s2 = slots2[g]
        d = ref.host.desc[s1] + frame.host.desc[s2]
        d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-12)

        kf0 = store.add_keyframe(np.eye(3), np.zeros(3), ref.host, ref.timestamp)
        kf1 = store.add_keyframe(R21, t21, frame.host, frame.timestamp)
        ids = store.add_points(pts, d, first_kf=kf0)
        store.assign_observations(kf0, s1, ids)
        store.assign_observations(kf1, s2, ids)
        store.update_covisibility(kf1)
        if self.mapper is not None:
            # the mapper takes the lock itself for its build and write-back:
            # holding it through a 20-iteration LM starves the worker
            self._unlocked(lambda: self.mapper.initial_ba(kf0, kf1))
        depths = (store.mp_pos[ids] @ store.kf_R[kf0].T + store.kf_t[kf0])[:, 2]
        med = float(np.median(depths))
        if med <= 0:  # degenerate init; roll back
            store.remove_points(ids)
            store.remove_keyframe(kf0)
            store.remove_keyframe(kf1)
            return
        store.kf_t[kf1] /= med
        store.mp_pos[ids] /= med
        store.mark_points_dirty(ids)

        frame.R = store.kf_R[kf1].copy()
        frame.t = store.kf_t[kf1].copy()
        obs = np.full(len(frame.host.mask), -1, np.int32)
        obs[s2] = ids
        frame.obs = obs
        self.ref_kf = kf1
        self.last_frame = frame
        self.velocity = None
        self.frames_since_kf = 0
        if self.vi is not None:
            # the IMU chain starts across the init pair
            meas = self._meas_since_kf()
            pre = self._unlocked(lambda: self.vi.integrate(meas))
            self.vi.first_kf_ts = float(ref.timestamp)
            self.vi.on_keyframe(kf1, kf0, pre, meas=meas)
            self._imu_since_kf = []
            self._last_kf = kf1
        self.state = OK

    # ------------------------------------------------------------------
    # stereo / RGB-D initialization (Tracking::StereoInitialization)
    # ------------------------------------------------------------------
    def _stereo_initialization(self, frame: Frame):
        """Depth makes scale observable: the first frame with at least
        min_stereo_init_points close depths seeds the map at metric scale."""
        cfg = self.cfg
        store = self.store
        ok = frame.host.mask & (frame.depth > 0) & (frame.depth < cfg.th_depth)
        slots = np.nonzero(ok)[0]
        if len(slots) < cfg.min_stereo_init_points:
            return
        frame.R = np.eye(3, dtype=np.float32)
        frame.t = np.zeros(3, np.float32)
        kf = store.add_keyframe(frame.R, frame.t, frame.host, frame.timestamp,
                                depth=frame.depth)
        ids = store.add_points(self._unproject_depth(frame, slots), frame.host.desc[slots],
                               first_kf=kf)
        store.assign_observations(kf, slots, ids)
        obs = np.full(store.n_slots, -1, np.int32)
        obs[slots] = ids
        frame.obs = obs
        self.ref_kf = kf
        self.last_frame = frame
        self.velocity = None
        self.frames_since_kf = 0
        if self.vi is not None:
            self.vi.first_kf_ts = float(frame.timestamp)
            self._imu_since_kf = []
            self._last_kf = kf
        self.state = OK

    def _unproject_depth(self, frame: Frame, slots):
        """World positions of keypoints from their depth (UnprojectStereo)."""
        xn = self.cam.unproject(frame.feats.xy).cpu().numpy()  # (N,3), z = 1 rays
        p_c = xn[slots] * frame.depth[slots, None]
        return (p_c - frame.t[None, :]) @ frame.R  # R^T (p_c - t), batched

    def _depth_rows(self, frame):
        """(z_meas, wz) of the frame's observations as float32 numpy: the
        depth row's weight bf / z^2 where a depth was measured, else 0; None
        without depth (a monocular frame)."""
        if frame.depth is None or self.cfg.bf <= 0:
            return None
        z = np.where(frame.depth > 0, frame.depth, 0.0).astype(np.float32)
        wz = np.where(z > 0, self.cfg.bf / np.maximum(z, 1e-3) ** 2, 0.0).astype(np.float32)
        return z, wz

    # ------------------------------------------------------------------
    # per-frame tracking
    # ------------------------------------------------------------------
    def _vi_active(self):
        return (self.vi is not None and self.store.imu_initialized
                and self._last_kf >= 0 and self.store.kf_valid[self._last_kf])

    def _meas_since_kf(self):
        """The raw IMU rows since the last keyframe (a copy)."""
        if self._imu_since_kf:
            return np.concatenate(self._imu_since_kf, axis=0)
        return np.zeros((0, 7), np.float32)

    def _kf_body_state(self, k):
        """Copies of keyframe k's body state (R_wb, p_wb, v, bg, ba)."""
        store = self.store
        R_wb, p_wb = self.vi.cam_to_body(store.kf_R[k], store.kf_t[k])
        return (R_wb, p_wb, store.kf_vel[k].copy(), store.kf_bg[k].copy(),
                store.kf_ba[k].copy())

    def _predicted_pose(self, locked=False):
        if self._vi_active():
            # PredictStateIMU from the last keyframe (Tracking.cc:1041): the
            # rows since it are integrated at its bias, off the lock
            state = self._kf_body_state(self._last_kf)
            meas = self._meas_since_kf()

            def run():
                return self.vi.predict(state, self.vi.integrate(meas, state[3], state[4]))

            big0 = self.store.big_change_idx
            R_wb, p_wb, _ = run() if locked else self._unlocked(run)
            if self.store.big_change_idx != big0:  # the map moved meanwhile
                return self._predicted_pose(locked=True)
            return self.vi.body_to_cam(R_wb, p_wb)
        R_l, t_l = self.last_frame.R, self.last_frame.t
        if self.velocity is None:
            return R_l.copy(), t_l.copy()
        R_v, t_v = self.velocity
        return R_v @ R_l, R_v @ t_l + t_v

    def _unlocked(self, fn):
        """Run a device computation and its blocking read-back with the map
        lock released. Its inputs must be copies taken under the lock; the
        caller re-validates ids afterwards."""
        self.lock.release()
        try:
            return fn()
        finally:
            self.lock.acquire()

    def _revalidate_obs(self, obs):
        """Drop observations of points culled while a kernel ran off the
        lock."""
        store = self.store
        return np.where((obs >= 0) & store.mp_valid[np.clip(obs, 0, store.m_max - 1)],
                        obs, -1).astype(np.int32)

    def _pose_optimize_frame(self, frame, R0, t0):
        """Pose-only optimization over frame.obs; with an initialized IMU the
        15-d visual-inertial solve. Returns the inlier count."""
        if self._vi_active():
            return self._pose_optimize_frame_vi(frame, R0, t0)
        store = self.store
        obs = frame.obs
        valid = (obs >= 0) & frame.host.mask
        pts = store.mp_pos[np.clip(obs, 0, store.m_max - 1)]
        inv_sigma2 = 1.0 / (1.2 ** (2.0 * frame.host.octave))
        args = (self._t(R0), self._t(t0), self._t(pts), frame.feats.xy, self._t(inv_sigma2),
                self._t(valid, torch.bool))
        rows = self._depth_rows(frame)
        zw = {} if rows is None else {"z_meas": self._t(rows[0]), "wz": self._t(rows[1])}

        def run():  # inputs copied above; the solve waits off the lock
            res = pose_opt.pose_optimize(self.cam.kind, self.cam.params, *args, **zw)
            return [res[k].cpu().numpy() for k in ("R", "t", "inlier")]

        frame.R, frame.t, inlier = self._unlocked(run)
        frame.obs = self._revalidate_obs(np.where(inlier, obs, -1))
        return int(inlier.sum())

    def _vi_anchor(self):
        """The previous state the frame's VI solves anchor on, fixed once per
        frame so the second (local-map) solve does not re-apply the IMU block
        to the state the first one advanced: the last frame's optimized state
        and block while the map stands still (PoseInertialOptimizationLast-
        Frame), else the last keyframe's state and the rows since it
        (...LastKeyFrame). Returns [state, meas, use_prior, pre]."""
        store = self.store
        if self._anchor_fid != self.frame_id:
            map_updated = store.map_change_idx != self._seen_change
            self._seen_change = store.map_change_idx
            use_last_frame = (not map_updated and self._vi_state is not None
                              and self._cur_imu_block is not None
                              and len(self._cur_imu_block) > 0)
            if use_last_frame:
                state, meas = self._vi_state, self._cur_imu_block
            else:
                state, meas = self._kf_body_state(self._last_kf), self._meas_since_kf()
            use_prior = use_last_frame and self._vi_prior is not None and self.cfg.vi_marg_prior
            self._frame_anchor = [state, meas, use_prior, None]
            self._frame_anchor_prior = self._vi_prior if use_prior else None
            self._anchor_fid = self.frame_id
        return self._frame_anchor

    def _pose_optimize_frame_vi(self, frame, R0, t0):
        """The 15-d state [R_wb p_wb v bg ba] against the frame's
        observations, one inertial edge from the anchor (_vi_anchor) and the
        bias walks: optim/inertial.pose_inertial_optimize, or with the
        marginal prior pose_inertial_optimize_marg, whose output prior the
        next frame takes. The solve runs off the lock on copies; when a
        whole-map move lands meanwhile, the frame re-anchors on the last
        keyframe in the new frame and solves again under the lock."""
        store = self.store
        vi = self.vi
        for attempt in (0, 1):
            anchor = self._vi_anchor()
            (R1, p1, v1, bg1, ba1), meas, use_prior, _ = anchor
            prior = self._frame_anchor_prior
            obs = frame.obs
            valid = (obs >= 0) & frame.host.mask
            pts = store.mp_pos[np.clip(obs, 0, store.m_max - 1)].copy()
            inv_sigma2 = 1.0 / (1.2 ** (2.0 * frame.host.octave))
            R2, p2 = vi.cam_to_body(R0, t0)
            v2 = frame.v if frame.v is not None else v1
            T = self._t
            args = (T(R1), T(p1), T(v1), T(bg1), T(ba1))
            cur = (T(R2), T(p2), T(v2))
            vis = (T(pts), frame.feats.xy, T(inv_sigma2), T(valid, torch.bool))
            prior_t = None if prior is None else T(prior)

            def run():
                if anchor[3] is None:  # the anchor's preintegration, once per frame
                    anchor[3] = vi.integrate(meas, bg1, ba1)
                if use_prior:
                    res = VIOPT.pose_inertial_optimize_marg(
                        self.cam.kind, self.cam.params, vi.Tbc_R, vi.Tbc_t, *args, prior_t,
                        anchor[3], *cur, *vis)
                else:
                    res = VIOPT.pose_inertial_optimize(
                        self.cam.kind, self.cam.params, vi.Tbc_R, vi.Tbc_t, *args,
                        anchor[3], *cur, *vis)
                return {k: v.cpu().numpy() for k, v in res.items()}

            big0 = store.big_change_idx
            res = self._unlocked(run) if attempt == 0 else run()
            if store.big_change_idx == big0:
                break
            self._seen_big = store.big_change_idx
            self.velocity = None
            self._vi_state = None
            self._vi_prior = None
            self._anchor_fid = -1
            R0, t0 = self._predicted_pose(locked=True)
        self._vi_prior = res["prior_info_out"] if use_prior else res["H"]
        frame.R, frame.t = vi.body_to_cam(res["R"], res["p"])
        frame.v = res["v"]
        self._vi_state = (res["R"], res["p"], res["v"], res["bg"], res["ba"])
        frame.obs = self._revalidate_obs(np.where(res["inlier"], obs, -1))
        return int(res["inlier"].sum())

    def _track_frame(self, frame) -> bool:
        ok = self._track_with_motion_model(frame)
        if not ok:
            ok = self._track_reference_keyframe(frame)
        return ok

    def _track_with_motion_model(self, frame) -> bool:
        cfg = self.cfg
        store = self.store
        R0, t0 = self._predicted_pose()
        last_obs = self.last_frame.obs
        mp_ids = np.unique(last_obs[last_obs >= 0])
        mp_ids = mp_ids[store.mp_valid[mp_ids]]
        if len(mp_ids) < 3:
            return False
        cap = cfg.local_mp_cap
        mp_pos, mp_desc, mp_valid, mp_ids_p = self._pad_mps(mp_ids, cap)
        f = frame.feats
        R0_t, t0_t = self._t(R0), self._t(t0)

        def run_search():  # inputs copied by _pad_mps; the kernels wait off the lock
            for radius in (cfg.motion_window, cfg.motion_window_retry):
                idx, _, _ = search.search_by_projection(
                    self.cam.kind, self.cam.params, (self.cam.width, self.cam.height),
                    R0_t, t0_t, mp_pos, mp_desc, mp_valid,
                    f.xy, f.desc, f.octave, f.mask, radius=radius, max_dist=cfg.th_high)
                idx = idx.cpu().numpy()
                n = int((idx >= 0).sum())
                if n >= cfg.min_motion_matches:
                    break
            return idx, n

        idx, n = self._unlocked(run_search)
        if n < cfg.min_motion_matches:
            return False
        frame.obs = self._revalidate_obs(
            np.where(idx >= 0, mp_ids_p[np.clip(idx, 0, cap - 1)], -1))
        n_in = self._pose_optimize_frame(frame, R0, t0)
        self.n_inliers = n_in
        return n_in >= cfg.min_pose_inliers

    def _track_reference_keyframe(self, frame) -> bool:
        """TrackReferenceKeyFrame: brute-force mutual matching of the frame
        against the reference keyframe's observed slots (the row_top2 kernel
        on CUDA), then pose optimization from the last pose."""
        cfg = self.cfg
        store = self.store
        k = self.ref_kf
        if k < 0 or not store.kf_valid[k]:
            return False
        # copies under the lock: slot reuse may overwrite the keyframe's
        # rows while the kernel runs off it
        kf_obs = store.kf_obs[k].copy()
        maskB = (kf_obs >= 0) & store.kf_mask[k]
        descB, maskB_t = self._t(store.kf_desc[k]), self._t(maskB, torch.bool)

        def run():
            idx, _ = search.search_brute_force(frame.feats.desc, frame.feats.mask, descB,
                                               maskB_t, max_dist=cfg.th_low, ratio=0.9)
            return idx.cpu().numpy()

        idx = self._unlocked(run)
        if int((idx >= 0).sum()) < cfg.min_ref_matches:
            return False
        frame.obs = self._revalidate_obs(np.where(
            idx >= 0, kf_obs[np.clip(idx, 0, len(kf_obs) - 1)], -1))
        if self._vi_active():
            # after a dropout the last pose is stale: start from the IMU
            # prediction (Tracking.cc:1285)
            R0, t0 = self._predicted_pose()
        else:
            R0, t0 = self.last_frame.R, self.last_frame.t
        n_in = self._pose_optimize_frame(frame, R0, t0)
        self.n_inliers = n_in
        return n_in >= cfg.min_pose_inliers

    # ------------------------------------------------------------------
    # fused fast path (slam/fused.py)
    # ------------------------------------------------------------------
    def _track_fused(self, frame) -> bool:
        """Motion search -> pose LM -> local search -> pose LM on the device.
        True when this path handled the frame (success, or a definitive
        failure with frame.R = None); False hands the frame to the staged
        fallbacks (TrackReferenceKeyFrame)."""
        cfg = self.cfg
        store = self.store
        if self.last_frame is None or self.last_frame.obs is None:
            return False
        last_obs = self.last_frame.obs
        mp_ids = np.unique(last_obs[last_obs >= 0])
        mp_ids = mp_ids[store.mp_valid[mp_ids]]
        if len(mp_ids) < 3:
            return False
        if self._local_ids is None:
            with timings.span("track.local_set"):
                self._update_local_set(last_obs)
            if self._local_ids is None:
                return False
        with timings.span("track.map_sync"):
            dm = fused.get_device_map(store, self.device)
            dm.sync()
        with timings.span("track.prepare"):
            R0, t0 = self._predicted_pose()
            motion_ids = np.full(store.n_slots, -1, np.int64)
            n_m = min(len(mp_ids), store.n_slots)
            motion_ids[:n_m] = mp_ids[:n_m]
            rows = self._depth_rows(frame)
            if rows is None:
                z = wz = torch.zeros(store.n_slots, dtype=torch.float32, device=self.device)
            else:
                z, wz = self._t(rows[0]), self._t(rows[1])
            f = frame.feats
            # the mirror's tables are replaced, never written, by later syncs,
            # and the id vectors and poses are copies: the step may run off
            # the lock
            args = (self._t(R0), self._t(t0)) + dm.snapshot() + (
                self._t(motion_ids, torch.int64), self._t(self._local_ids, torch.int64))

        def run():
            with timings.span("track.step"):
                out = fused.track_step(
                    self.cam.kind, self.cam.params, float(self.cam.width),
                    float(self.cam.height), *args, f.xy, f.desc, f.octave, f.mask, z, wz,
                    self._fused_cfg)
            with timings.span("track.readback"):  # one host copy per frame
                return {k: v.cpu().numpy() for k, v in out.items()}

        out = self._unlocked(run)
        # a whole-map move (loop correction, GBA propagation) may have landed
        # meanwhile: the pose is in the old gauge. Discard it; with the motion
        # model reset, the reference-keyframe route re-anchors
        if store.big_change_idx != self._seen_big:
            self._seen_big = store.big_change_idx
            self.velocity = None
            self._vi_state = None
            self._vi_prior = None
            return False
        n1, n_in1, n_in2 = (int(x) for x in out["stats"])
        if n1 < cfg.min_motion_matches or n_in1 < cfg.min_pose_inliers:
            return False  # staged fallbacks (ref-KF brute force) take over

        with timings.span("track.update"):
            frame.R = out["R"]
            frame.t = out["t"]
            frame.obs = self._revalidate_obs(out["obs"])
            self.n_inliers = n_in2
            vis = out["vis_local"]
            lids = self._local_ids
            store.mp_visible[lids[(lids >= 0) & vis]] += 1
            obs1 = out["obs1"]
            store.mp_visible[np.unique(obs1[obs1 >= 0])] += 1
            store.mp_found[frame.obs[frame.obs >= 0]] += 1
            if n_in2 < cfg.min_local_inliers and n_in2 < cfg.min_pose_inliers:
                frame.R = None
                frame.t = None
                return True
            R_l, t_l = self.last_frame.R, self.last_frame.t
            R_v = _orthonormalize_np(frame.R @ R_l.T)
            self.velocity = (R_v, frame.t - R_v @ t_l)
        with timings.span("track.local_set"):
            self._update_local_set(frame.obs)
        return True

    def _update_local_set(self, obs):
        """Local-map candidate ids for the next fused frame
        (UpdateLocalKeyFrames/Points) and the reference keyframe refresh."""
        store = self.store
        matched = np.unique(obs[obs >= 0])
        matched = matched[store.mp_valid[matched]]
        if len(matched) == 0:
            self._local_ids = None
            return
        kf_ids, _, _ = store.observing_slots(matched)
        if len(kf_ids) == 0:
            self._local_ids = None
            return
        counts = np.bincount(kf_ids, minlength=store.k_max)
        local_kfs = np.nonzero(counts)[0]
        self.ref_kf = int(local_kfs[np.argmax(counts[local_kfs])])
        extra = []
        for k in local_kfs[np.argsort(-counts[local_kfs])][:10]:
            extra.extend(store.covisible_kfs(k, n=10, min_weight=15))
        if extra:
            local_kfs = np.unique(np.concatenate([local_kfs, np.asarray(extra, int)]))
        local_mps = store.points_seen_by(local_kfs)
        cap = self.cfg.local_mp_cap
        ids = np.full(cap, -1, np.int32)
        n = min(len(local_mps), cap)
        ids[:n] = local_mps[:n]
        self._local_ids = ids

    # ------------------------------------------------------------------
    # relocalization (Tracking::Relocalization)
    # ------------------------------------------------------------------
    def _relocalize(self, frame) -> bool:
        """Global-descriptor retrieval -> brute-force matching against each
        candidate keyframe's observed slots (the row_top2 kernel on CUDA,
        ratio 0.9) -> batched PnP RANSAC -> pose optimization, with the
        widened-projection retry for a candidate landing 10-50 inliers.
        The PnP samples come from a generator seeded by the frame id, as
        the reference seeds its key."""
        cfg = self.cfg
        store = self.store
        f = frame.feats
        cands = retrieval.detect_relocalization_candidates(store, frame.host.global_desc,
                                                           device=self.device)
        for c in cands[:5]:
            kf_obs = store.kf_obs[c]
            maskB = (kf_obs >= 0) & store.kf_mask[c]
            if int(maskB.sum()) < cfg.min_reloc_matches:
                continue
            idx, _ = search.search_brute_force(
                f.desc, f.mask, self._t(store.kf_desc[c]), self._t(maskB, torch.bool),
                max_dist=cfg.th_low, ratio=0.9)
            idx = idx.cpu().numpy()
            slots = np.nonzero(idx >= 0)[0]
            if len(slots) < cfg.min_reloc_matches:
                continue
            mp_ids = kf_obs[idx[slots]]
            ok_mp = store.mp_valid[mp_ids]
            slots, mp_ids = slots[ok_mp], mp_ids[ok_mp]
            if len(slots) < cfg.min_reloc_matches:
                continue

            N = store.n_slots
            n = len(slots)
            pts = np.zeros((N, 3), np.float32)
            uv = np.zeros((N, 2), np.float32)
            inv_s2 = np.ones(N, np.float32)
            val = np.zeros(N, bool)
            pts[:n] = store.mp_pos[mp_ids]
            uv[:n] = frame.host.xy[slots]
            inv_s2[:n] = 1.0 / (1.2 ** (2.0 * frame.host.octave[slots]))
            val[:n] = True
            val_t = self._t(val, torch.bool)
            picks = pnp.draw_picks(val_t, cfg.pnp_hyps, 6,
                                   torch.Generator().manual_seed(self.frame_id))
            res = pnp.pnp_ransac(self.cam.kind, self.cam.params, self._t(pts), self._t(uv),
                                 self._t(inv_s2), val_t, picks)
            if int(res["n_inliers"]) < cfg.min_reloc_pnp_inliers:
                continue

            obs = np.full(N, -1, np.int32)
            obs[slots] = mp_ids
            frame.obs = obs
            n_in = self._pose_optimize_frame(frame, res["R"].cpu().numpy(),
                                             res["t"].cpu().numpy())
            if n_in < cfg.min_reloc_pnp_inliers:
                frame.R = None
                frame.t = None
                continue
            if n_in < cfg.min_reloc_inliers:
                n_in = self._reloc_escalate(frame, c, n_in)
            if n_in >= cfg.min_reloc_inliers:
                self.ref_kf = int(c)
                self.velocity = None
                self._local_ids = None
                self.n_inliers = n_in
                self.n_relocalizations += 1
                return True
            frame.R = None
            frame.t = None
        return False

    def _reloc_escalate(self, frame, c: int, n_in: int) -> int:
        """Widened-projection retry for a failing candidate
        (Tracking.cc:3141-3169): project the candidate's points at the
        estimated pose with a coarse window (10 px, TH_HIGH), re-optimize;
        at 30-50 inliers one fine pass (3 px, TH_LOW) and a last
        optimization."""
        cfg = self.cfg
        store = self.store
        kf_obs = store.kf_obs[c]
        mp_c = kf_obs[np.nonzero((kf_obs >= 0) & store.kf_mask[c])[0]]
        mp_c = np.unique(mp_c[store.mp_valid[mp_c]])
        if len(mp_c) == 0:
            return n_in
        pos, desc, valid, ids_p = self._pad_mps(mp_c, store.n_slots)
        valid = valid.cpu().numpy()
        f = frame.feats

        def extra_pass(radius, max_dist):
            """One guided-projection pass over the frame's free slots,
            excluding points the frame already carries; returns the number
            of observations claimed."""
            free = frame.host.mask & (frame.obs < 0)
            val2 = valid & ~np.isin(ids_p, frame.obs[frame.obs >= 0])
            idx, _, _ = search.search_by_projection(
                self.cam.kind, self.cam.params, (self.cam.width, self.cam.height),
                self._t(frame.R), self._t(frame.t), pos, desc, self._t(val2, torch.bool),
                f.xy, f.desc, f.octave, self._t(free, torch.bool),
                radius=float(radius), max_dist=float(max_dist))
            idx = idx.cpu().numpy()
            new_slots = np.nonzero((idx >= 0) & free)[0]
            if len(new_slots) == 0:
                return 0
            new_ids = ids_p[idx[new_slots]]
            _, first = np.unique(new_ids, return_index=True)
            uniq = np.zeros(len(new_ids), bool)
            uniq[first] = True
            frame.obs[new_slots[uniq]] = new_ids[uniq]
            return int(uniq.sum())

        n_add = extra_pass(10.0, M.TH_HIGH)
        if n_in + n_add < cfg.min_reloc_inliers:
            return n_in
        n_in = self._pose_optimize_frame(frame, frame.R, frame.t)
        if 30 < n_in < cfg.min_reloc_inliers:
            n_add = extra_pass(3.0, M.TH_LOW)
            if n_in + n_add >= cfg.min_reloc_inliers:
                n_in = self._pose_optimize_frame(frame, frame.R, frame.t)
        return n_in

    def _pad_mps(self, mp_ids, cap, with_stats=False):
        store = self.store
        mp_ids = mp_ids[:cap]
        n = len(mp_ids)
        pos = np.zeros((cap, 3), np.float32)
        desc = np.zeros((cap, store.desc_dim), np.float32)
        valid = np.zeros(cap, bool)
        pos[:n] = store.mp_pos[mp_ids]
        desc[:n] = store.mp_desc[mp_ids]
        valid[:n] = True
        ids_p = np.full(cap, -1, np.int32)
        ids_p[:n] = mp_ids
        out = (self._t(pos), self._t(desc), self._t(valid, torch.bool), ids_p)
        if not with_stats:
            return out
        normal = np.zeros((cap, 3), np.float32)
        dmin = np.zeros(cap, np.float32)
        dmax = np.zeros(cap, np.float32)
        normal[:n] = store.mp_normal[mp_ids]
        dmin[:n] = store.mp_dmin[mp_ids]
        dmax[:n] = store.mp_dmax[mp_ids]
        return out + (self._t(normal), self._t(dmin), self._t(dmax))

    def _track_local_map(self, frame):
        """UpdateLocalMap + SearchLocalPoints + final pose opt."""
        cfg = self.cfg
        store = self.store
        matched = frame.obs[frame.obs >= 0]
        if len(matched) == 0:
            return
        kf_ids, _, _ = store.observing_slots(np.unique(matched))
        if len(kf_ids) == 0:
            return
        counts = np.bincount(kf_ids, minlength=store.k_max)
        local_kfs = np.nonzero(counts)[0]
        self.ref_kf = int(local_kfs[np.argmax(counts[local_kfs])])
        extra = []
        for k in local_kfs[np.argsort(-counts[local_kfs])][:10]:
            extra.extend(store.covisible_kfs(k, n=10, min_weight=15))
        if extra:
            local_kfs = np.unique(np.concatenate([local_kfs, np.asarray(extra, int)]))
        local_mps = store.points_seen_by(local_kfs)
        local_mps = local_mps[~np.isin(local_mps, matched)]
        if len(local_mps) > 0:
            cap = cfg.local_mp_cap
            (mp_pos, mp_desc, mp_valid, ids_p, mp_normal, mp_dmin,
             mp_dmax) = self._pad_mps(local_mps, cap, with_stats=True)
            f = frame.feats
            R_t, t_t = self._t(frame.R), self._t(frame.t)

            def run():  # inputs copied by _pad_mps; the kernel waits off the lock
                idx, _, proj_ok = search.search_by_projection(
                    self.cam.kind, self.cam.params, (self.cam.width, self.cam.height),
                    R_t, t_t, mp_pos, mp_desc, mp_valid, f.xy, f.desc, f.octave, f.mask,
                    radius=cfg.local_window, max_dist=cfg.th_high, ratio=1.0,
                    mp_normal=mp_normal, mp_dmin=mp_dmin, mp_dmax=mp_dmax)
                return idx.cpu().numpy(), proj_ok.cpu().numpy()

            idx, proj_ok = self._unlocked(run)
            vis_ids = ids_p[proj_ok[: len(ids_p)] & (ids_p >= 0)]
            store.mp_visible[vis_ids[store.mp_valid[vis_ids]]] += 1
            new = (idx >= 0) & (frame.obs < 0)
            frame.obs = self._revalidate_obs(np.where(
                new, ids_p[np.clip(idx, 0, cap - 1)], frame.obs))

        n_in = self._pose_optimize_frame(frame, frame.R, frame.t)
        self.n_inliers = n_in
        store.mp_found[frame.obs[frame.obs >= 0]] += 1
        store.mp_visible[np.unique(matched)] += 1
        if n_in < cfg.min_local_inliers and n_in < cfg.min_pose_inliers:
            frame.R = None
            frame.t = None
            return
        # motion model, re-orthonormalized (see lie.orthonormalize)
        Rl_inv, tl_inv = lie.se3_inverse(torch.from_numpy(self.last_frame.R),
                                         torch.from_numpy(self.last_frame.t))
        R_v, t_v = lie.se3_mul(torch.from_numpy(frame.R), torch.from_numpy(frame.t),
                               Rl_inv, tl_inv)
        self.velocity = (lie.orthonormalize(R_v).numpy(), t_v.numpy())

    # ------------------------------------------------------------------
    # keyframe policy (Tracking::NeedNewKeyFrame)
    # ------------------------------------------------------------------
    def _need_new_keyframe(self, frame) -> bool:
        """NeedNewKeyFrame's conditions: c1a (max frames), c1b (min frames and
        the mapper idle), c1c (depth sensors: weak tracking or close-point
        starvation), c2 (reference ratio; 0.75 with depth); with an IMU c3
        (0.5 s cadence) and, monocular-inertial only, c4 (weak tracking);
        before IMU initialization a fixed 0.25 s cadence."""
        cfg = self.cfg
        store = self.store
        self.frames_since_kf += 1
        if self.ref_kf < 0:
            return False
        vi_mode = self.vi is not None
        is_depth = frame.depth is not None
        if vi_mode and not store.imu_initialized:
            return (self._last_kf >= 0
                    and frame.timestamp - store.kf_timestamp[self._last_kf] >= 0.25)
        n_kfs = int(store.kf_valid.sum())
        min_obs = 3 if n_kfs > 2 else 2
        ref_mp = store.kf_obs[self.ref_kf]
        ref_mp = ref_mp[ref_mp >= 0]
        n_ref = int((store.mp_obs_count[ref_mp] >= min_obs).sum())
        mapper_idle = self.worker is None or self.worker.queue_size() < 2
        need_close = False
        if is_depth:
            close = (frame.depth > 0) & (frame.depth < cfg.th_depth) & frame.host.mask
            tracked_close = int((close & (frame.obs >= 0)).sum())
            need_close = tracked_close < 100 and int((close & (frame.obs < 0)).sum()) > 70
        th_ref = 0.75 if is_depth else cfg.kf_ref_ratio
        if n_kfs < 2:
            th_ref = 0.4
        if vi_mode and not is_depth:  # IMU_MONOCULAR (Tracking.cc:2476-2482)
            th_ref = 0.75 if self.n_inliers > 350 else cfg.kf_ref_ratio
        c1a = self.frames_since_kf >= cfg.max_frames_between_kf
        c1b = self.frames_since_kf >= cfg.min_frames_between_kf and mapper_idle
        c1c = is_depth and not vi_mode and (self.n_inliers < 0.25 * n_ref or need_close)
        c2 = (self.n_inliers < th_ref * n_ref or need_close) and self.n_inliers > 15
        c3 = (vi_mode and self._last_kf >= 0
              and frame.timestamp - store.kf_timestamp[self._last_kf] >= 0.5)
        c4 = vi_mode and not is_depth and 15 < self.n_inliers < 75
        if not (((c1a or c1b or c1c) and c2) or c3 or c4):
            return False
        if mapper_idle:
            return True
        if self.mapper is not None:
            self.mapper.abort_ba = True
        return self.worker is not None and self.worker.queue_size() < 3

    def _create_keyframe(self, frame):
        store = self.store
        pre = meas = None
        if self.vi is not None and self._last_kf >= 0:
            # the chain link from the previous keyframe, integrated at its
            # bias before the switch, under the lock as in the reference: the
            # frame's pose is final, and a whole-map move landing before the
            # insertion (the IMU init's rescale on the mapping worker) would
            # leave the keyframe in the old gauge
            meas = self._meas_since_kf()
            bg, ba = store.kf_bg[self._last_kf].copy(), store.kf_ba[self._last_kf].copy()
            pre = self.vi.integrate(meas, bg, ba)
        k = store.add_keyframe(frame.R, frame.t, frame.host, frame.timestamp, obs=frame.obs,
                               depth=frame.depth)
        self.ref_kf = k
        self.frames_since_kf = 0
        self._local_ids = None
        if frame.depth is not None:
            self._create_depth_points(frame, k)
        if frame.right is not None and store.has_right:
            # matched right keypoints of observed left slots become right-bank
            # observations (the reference's ToBody measurements)
            fr, ridx = frame.right
            slots_l = np.nonzero((frame.obs >= 0) & (ridx >= 0))[0]
            if len(slots_l):
                rs = ridx[slots_l]
                store.set_right_observations(k, rs, frame.obs[slots_l], fr.xy[rs],
                                             fr.octave[rs])
        if self.vi is not None:
            if pre is not None:
                self.vi.on_keyframe(k, self._last_kf, pre, meas=meas)
            if frame.v is not None:
                store.kf_vel[k] = frame.v
            self._imu_since_kf = []
            self._last_kf = k
        if self.worker is not None:
            # async pipeline: hand the keyframe to the mapping worker
            # (LocalMapping::InsertKeyFrame) and keep tracking; refinements
            # reach the tracker through the shared map under the lock
            self.worker.enqueue(store, k)
            return
        if self.mapper is not None:
            self.mapper.process_keyframe(k)
        if self.loop_closer is not None:
            # LocalMapping -> LoopClosing handoff, inline; a correction moved
            # the whole map, so the motion model restarts
            if self.loop_closer.process_keyframe(k):
                self.velocity = None
        if self.vi is not None and self.vi.maybe_initialize(frame.timestamp):
            # a stage rotated and rescaled the whole map: refresh the frame
            frame.v = store.kf_vel[k].copy()
            self.velocity = None
        if self.mapper is not None or self.loop_closer is not None or self.vi is not None:
            # tracking continues from the BA/loop-refined keyframe pose
            frame.R = store.kf_R[k].copy()
            frame.t = store.kf_t[k].copy()
            frame.obs = store.kf_obs[k].copy()

    def _create_depth_points(self, frame, k):
        """Seed close map points from depth on keyframe insertion
        (Tracking::CreateNewKeyFrame): the nearest max_depth_points_per_kf
        close points whose slot has no map point yet. The order is numpy's
        default argsort, as the reference's, so ties break alike."""
        cfg = self.cfg
        store = self.store
        free = (frame.host.mask & (store.kf_obs[k] < 0) & (frame.depth > 0)
                & (frame.depth < cfg.th_depth))
        slots = np.nonzero(free)[0]
        if len(slots) == 0:
            return
        order = np.argsort(frame.depth[slots])
        slots = slots[order[: cfg.max_depth_points_per_kf]]
        ids = store.add_points(self._unproject_depth(frame, slots), frame.host.desc[slots],
                               first_kf=k)
        store.assign_observations(k, slots, ids)
        frame.obs[slots] = ids
