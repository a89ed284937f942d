"""Map storage: fixed-capacity host arrays for keyframes, map points and
observations.

Counterpart of hfnet_slam_tpu/slam/map.py (a numpy struct-of-arrays with
validity masks, dirty-row tracking for the device mirrors, capacity growth
and .npz snapshots). The snapshot format is the reference's own, so a map
saved by either package loads in the other (see convert.py). The one
device-side step, the distinctive-descriptor selection, runs through the
port's ops.matching on the caller's device.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..device import resolve, upload


@dataclasses.dataclass
class MapStore:
    k_max: int
    m_max: int
    n_slots: int
    desc_dim: int
    gdesc_dim: int

    def __post_init__(self):
        K, M, N, D = self.k_max, self.m_max, self.n_slots, self.desc_dim
        self.kf_R = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
        self.kf_t = np.zeros((K, 3), np.float32)
        self.kf_valid = np.zeros(K, bool)
        self.kf_timestamp = np.zeros(K, np.float64)
        self.kf_xy = np.zeros((K, N, 2), np.float32)
        self.kf_desc = np.zeros((K, N, D), np.float32)
        self.kf_score = np.zeros((K, N), np.float32)
        self.kf_octave = np.zeros((K, N), np.int32)
        self.kf_mask = np.zeros((K, N), bool)
        self.kf_gdesc = np.zeros((K, self.gdesc_dim), np.float32)
        self.kf_obs = np.full((K, N), -1, np.int32)
        # spanning tree (KeyFrame::mpParent analogue): parent = best covisible
        # KF at insertion time; -1 for roots. Loop edges live beside it.
        self.kf_parent = np.full(K, -1, np.int32)
        self.loop_edges: list[tuple[int, int]] = []
        # stereo/RGB-D per-keypoint depth (mvDepth analogue; 0 = none)
        self.kf_depth = np.zeros((K, N), np.float32)
        # visual-inertial per-KF state (KeyFrame mVw/mImuBias analogue)
        self.kf_vel = np.zeros((K, 3), np.float32)
        self.kf_bg = np.zeros((K, 3), np.float32)
        self.kf_ba = np.zeros((K, 3), np.float32)
        self.kf_prev = np.full(K, -1, np.int32)  # IMU chain (mPrevKF)
        # stereo-rig right-camera observations (the reference's right
        # keypoints with ToBody edges), allocated by enable_right_bank()
        self.has_right = False
        self.kf_xy_r = None     # (K,N,2)
        self.kf_oct_r = None    # (K,N)
        self.kf_obs_r = None    # (K,N) mp id or -1
        # map-level inertial flags (Map::isImuInitialized / VIBA1 / VIBA2)
        self.imu_initialized = False
        self.viba1 = False
        self.viba2 = False

        self.mp_pos = np.zeros((M, 3), np.float32)
        self.mp_desc = np.zeros((M, D), np.float32)
        self.mp_valid = np.zeros(M, bool)
        self.mp_visible = np.zeros(M, np.int32)  # times predicted visible
        self.mp_found = np.zeros(M, np.int32)    # times matched by tracking
        self.mp_first_kf = np.full(M, -1, np.int32)
        self.mp_obs_count = np.zeros(M, np.int32)  # keyframe observations
        # viewing statistics (MapPoint::UpdateNormalAndDepth /
        # PredictScale, reference src/MapPoint.cc): mean viewing direction
        # and the scale-invariance distance band. dmax == 0 means
        # "not yet computed" and disables the gates.
        self.mp_normal = np.zeros((M, 3), np.float32)
        self.mp_dmin = np.zeros(M, np.float32)
        self.mp_dmax = np.zeros(M, np.float32)

        self.covis = np.zeros((K, K), np.int32)
        self._covis_scratch = None  # native covis_update mark buffer
        self.n_kf = 0
        self.n_mp = 0
        self._free_mp: list[int] = []
        self._free_kf: list[int] = []
        # stable keyframe identity across slot reuse, for trajectory
        # recovery via relative poses (Tracking.cc:1604-1624 records each
        # frame against its reference KF; culled KFs redirect to their
        # spanning-tree parent like KeyFrame::SetBadFlag's mTcp)
        self.kf_uid = np.full(K, -1, np.int64)
        self._next_uid = 0
        self._uid_slot: dict[int, int] = {}
        # uid -> (parent_uid, R_rel, t_rel): pose of the culled KF relative
        # to its parent at cull time (T_culled = T_rel o T_parent)
        self.cull_redirect: dict[int, tuple] = {}
        # map change counter (Map::GetMapChangeIndex analogue): bumped by
        # every geometry write-back (BA, loop correction, gravity
        # alignment) so the tracker can tell whether the map moved since
        # the last frame (chooses LastFrame vs LastKeyFrame VI anchoring,
        # Tracking.cc mbMapUpdated)
        self.map_change_idx = 0
        # whole-map moves only (loop correction, GBA propagation, inertial
        # rescale): a concurrent solve built BEFORE such a move is stale
        # and must discard its write-back (the reference pauses
        # LocalMapping around these, LoopClosing.cc:1115-1133; here the
        # solve threads self-check this counter instead)
        self.big_change_idx = 0
        # dirty tracking for the tracker's device-resident map mirror
        # (slam/fused.DeviceMap): row-level marks for point insert/update,
        # the all-dirty flag for whole-map moves (BA, loop, rescale)
        self._mp_dirty = np.zeros(M, bool)
        self._mp_dirty_all = True
        # dirty tracking for the device-resident KEYFRAME bank
        # (slam/fused.DeviceKFBank): feature rows are immutable per slot
        # (dirty on add/remove only); obs rows change with every
        # association pass (separate cheap marks)
        self._kf_feat_dirty = np.zeros(K, bool)
        self._kf_obs_dirty = np.zeros(K, bool)
        self._kf_dirty_all = True

    def enable_right_bank(self):
        """Allocate the right-camera observation tables (stereo rigs)."""
        if self.has_right:
            return
        K, N = self.k_max, self.n_slots
        self.kf_xy_r = np.zeros((K, N, 2), np.float32)
        self.kf_oct_r = np.zeros((K, N), np.int32)
        self.kf_obs_r = np.full((K, N), -1, np.int32)
        self.has_right = True

    def set_right_observations(self, kf, slots, mp_ids, xy, octave):
        """Record right-camera observations for keyframe `kf`. They do not
        count toward mp_obs_count: culling follows the left bank."""
        self.enable_right_bank()
        slots = np.asarray(slots, int)
        self.kf_obs_r[kf, slots] = np.asarray(mp_ids, np.int32)
        self.kf_xy_r[kf, slots] = np.asarray(xy, np.float32)
        self.kf_oct_r[kf, slots] = np.asarray(octave, np.int32)

    def right_observing_slots(self, mp_ids):
        """(kf, slot, mp) triples of the right bank for the given points
        (edge building for the rig BA)."""
        if not self.has_right:
            return (np.empty(0, np.int64),) * 3
        member = np.zeros(self.m_max, bool)
        member[np.asarray(mp_ids, int)] = True
        obs = self.kf_obs_r
        sel = (obs >= 0) & self.kf_valid[:, None] & member[np.clip(obs, 0, self.m_max - 1)]
        kf_e, slot_e = np.nonzero(sel)
        return kf_e, slot_e, obs[kf_e, slot_e].astype(np.int64)

    def bump_change(self, dirty_points: bool = True):
        """Signal a geometry write-back. dirty_points=False when the writer
        already row-marked exactly the points it touched (incremental
        change); True marks a whole-map move."""
        self.map_change_idx += 1
        if dirty_points:
            self._mp_dirty_all = True
            self.big_change_idx += 1

    def mark_points_dirty(self, ids):
        """Row-level dirty marks for the device map mirror."""
        if not self._mp_dirty_all:
            self._mp_dirty[np.asarray(ids, int)] = True

    def mark_kf_feat_dirty(self, k):
        """Keyframe feature row changed (add/remove/slot reuse)."""
        if not self._kf_dirty_all:
            self._kf_feat_dirty[k] = True
            self._kf_obs_dirty[k] = True

    def mark_kf_obs_dirty(self, kf):
        """Keyframe observation row(s) changed (int or index array)."""
        if not self._kf_dirty_all:
            self._kf_obs_dirty[kf] = True

    def consume_dirty_kfs(self):
        """(feat_rows, obs_rows) with None for clean, or ('all', None);
        resets the marks. Called by DeviceKFBank.sync() under the map
        lock."""
        if self._kf_dirty_all:
            self._kf_dirty_all = False
            self._kf_feat_dirty[:] = False
            self._kf_obs_dirty[:] = False
            return "all", None
        feat = obs = None
        if self._kf_feat_dirty.any():
            feat = np.nonzero(self._kf_feat_dirty)[0]
            self._kf_feat_dirty[:] = False
        if self._kf_obs_dirty.any():
            obs = np.nonzero(self._kf_obs_dirty)[0]
            self._kf_obs_dirty[:] = False
        return feat, obs

    # ------------------------------------------------------------------
    # capacity growth: a silent keyframe drop at capacity would lose map
    # coverage on long sequences. Doubling keeps the number of distinct
    # table shapes logarithmic in map size.
    # ------------------------------------------------------------------
    @staticmethod
    def _padded(arr, n_new, fill=0):
        out = np.full((n_new,) + arr.shape[1:], fill, arr.dtype)
        out[: len(arr)] = arr
        return out

    def grow_keyframes(self):
        """Double the keyframe capacity in place."""
        from ..utils.log import warn

        old = self.k_max
        self.k_max = old * 2
        warn(f"MapStore: keyframe capacity grown {old} -> {self.k_max}")
        for name in ("kf_R", "kf_t", "kf_valid", "kf_timestamp", "kf_xy",
                     "kf_desc", "kf_score", "kf_octave", "kf_mask",
                     "kf_gdesc", "kf_depth", "kf_vel", "kf_bg", "kf_ba"):
            setattr(self, name, self._padded(getattr(self, name), self.k_max))
        for name in ("kf_parent", "kf_prev", "kf_uid"):
            setattr(self, name,
                    self._padded(getattr(self, name), self.k_max, fill=-1))
        self.kf_obs = self._padded(self.kf_obs, self.k_max, fill=-1)
        if self.has_right:
            self.kf_xy_r = self._padded(self.kf_xy_r, self.k_max)
            self.kf_oct_r = self._padded(self.kf_oct_r, self.k_max)
            self.kf_obs_r = self._padded(self.kf_obs_r, self.k_max, fill=-1)
        covis = np.zeros((self.k_max, self.k_max), np.int32)
        covis[:old, :old] = self.covis
        self.covis = covis
        self._covis_scratch = None
        self._kf_feat_dirty = self._padded(self._kf_feat_dirty, self.k_max)
        self._kf_obs_dirty = self._padded(self._kf_obs_dirty, self.k_max)
        self._kf_dirty_all = True  # KF bank must re-shape + re-upload
        bank = getattr(self, "_kf_bank", None)
        if bank is not None:
            bank._upload_all()
        # KF-shaped caches keyed on the old capacity
        for attr in ("_kf_xn", "_kf_xn_uid", "_retrieval_cache"):
            if hasattr(self, attr):
                delattr(self, attr)

    def grow_points(self):
        """Double the map-point capacity in place."""
        from ..utils.log import warn

        old = self.m_max
        self.m_max = old * 2
        warn(f"MapStore: map-point capacity grown {old} -> {self.m_max}")
        for name in ("mp_pos", "mp_desc", "mp_valid", "mp_visible",
                     "mp_found", "mp_obs_count", "mp_normal", "mp_dmin",
                     "mp_dmax"):
            setattr(self, name, self._padded(getattr(self, name), self.m_max))
        self.mp_first_kf = self._padded(self.mp_first_kf, self.m_max, fill=-1)
        self._mp_dirty = self._padded(self._mp_dirty, self.m_max)
        self._mp_dirty_all = True  # device mirror must re-shape + re-upload
        dm = getattr(self, "_device_map", None)
        if dm is not None:
            dm._upload_all()

    def consume_dirty_points(self):
        """Returns None (clean), 'all', or an int array of dirty rows, and
        resets the marks. Called by DeviceMap.sync() under the map lock."""
        if self._mp_dirty_all:
            self._mp_dirty_all = False
            self._mp_dirty[:] = False
            return "all"
        if not self._mp_dirty.any():
            return None
        ids = np.nonzero(self._mp_dirty)[0]
        self._mp_dirty[:] = False
        return ids

    # ------------------------------------------------------------------
    # keyframes
    # ------------------------------------------------------------------
    def add_keyframe(self, R, t, feats, timestamp, obs=None, depth=None) -> int:
        """Insert a keyframe from a Features struct. Returns kf id."""
        if self._free_kf:
            k = self._free_kf.pop()
        else:
            k = self.n_kf
            if k >= self.k_max:
                self.grow_keyframes()  # never silently drop a keyframe
            self.n_kf += 1
        self.kf_R[k] = np.asarray(R, np.float32)
        self.kf_t[k] = np.asarray(t, np.float32)
        self.kf_xy[k] = np.asarray(feats.xy, np.float32)
        self.kf_desc[k] = np.asarray(feats.desc, np.float32)
        self.kf_score[k] = np.asarray(feats.score, np.float32)
        self.kf_octave[k] = np.asarray(feats.octave, np.int32)
        self.kf_mask[k] = np.asarray(feats.mask, bool)
        g = np.asarray(feats.global_desc, np.float32)
        self.kf_gdesc[k, : len(g)] = g[: self.gdesc_dim]
        self.kf_timestamp[k] = timestamp
        self.kf_obs[k] = -1
        self.kf_depth[k] = 0.0 if depth is None else np.asarray(depth, np.float32)
        self.kf_valid[k] = True
        self.mark_kf_feat_dirty(k)
        self.kf_uid[k] = self._next_uid
        self._uid_slot[self._next_uid] = k
        self._next_uid += 1
        if obs is not None:
            obs = np.asarray(obs, np.int32)
            self.kf_obs[k] = obs
            np.add.at(self.mp_obs_count, obs[obs >= 0], 1)
            self.update_covisibility(k)
            # spanning-tree parent: strongest covisible (UpdateConnections
            # first-connection rule, reference src/KeyFrame.cc)
            w = self.covis[k].copy()
            w[~self.kf_valid] = 0
            w[k] = 0
            if w.max() > 0:
                self.kf_parent[k] = int(np.argmax(w))
        return k

    def remove_keyframe(self, k):
        """Cull a keyframe (KeyFrameCulling analogue). Children in the
        spanning tree are re-parented to the culled KF's parent
        (SetBadFlag's parent reassignment, reference src/KeyFrame.cc).
        A redirect (pose relative to the parent at cull time, the
        reference's mTcp) is recorded so trajectory entries referencing
        this KF keep following the map through later corrections."""
        parent = int(self.kf_parent[k])
        uid = int(self.kf_uid[k])
        if uid >= 0:
            self._uid_slot.pop(uid, None)
            if parent >= 0 and self.kf_valid[parent]:
                R_rel = self.kf_R[k] @ self.kf_R[parent].T
                t_rel = self.kf_t[k] - R_rel @ self.kf_t[parent]
                self.cull_redirect[uid] = (
                    int(self.kf_uid[parent]), R_rel.copy(), t_rel.copy())
        self.kf_uid[k] = -1
        self.kf_valid[k] = False
        obs = self.kf_obs[k]
        np.subtract.at(self.mp_obs_count, obs[obs >= 0], 1)
        self.kf_obs[k] = -1
        self.mark_kf_obs_dirty(k)
        if self.has_right:
            self.kf_obs_r[k] = -1
        self.covis[k, :] = 0
        self.covis[:, k] = 0
        self.kf_parent[self.kf_parent == k] = self.kf_parent[k]
        self.kf_parent[k] = -1
        self.loop_edges = [e for e in self.loop_edges if k not in e]
        self._free_kf.append(k)

    def valid_kf_ids(self):
        return np.nonzero(self.kf_valid)[0]

    def resolve_uid(self, uid: int):
        """Resolve a keyframe uid to (slot, R_chase, t_chase): the live slot
        that now anchors it, plus the accumulated relative pose through any
        cull redirects (identity when the KF itself is alive). Returns None
        when the chain dead-ends (e.g. the root of a reset map)."""
        R_acc = None
        t_acc = None
        for _ in range(1024):  # bound: redirect chains cannot cycle
            slot = self._uid_slot.get(uid)
            if slot is not None:
                if R_acc is None:
                    return slot, np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
                return slot, R_acc, t_acc
            nxt = self.cull_redirect.get(uid)
            if nxt is None:
                return None
            p_uid, R_rel, t_rel = nxt
            if R_acc is None:
                R_acc, t_acc = R_rel.copy(), t_rel.copy()
            else:
                t_acc = R_acc @ t_rel + t_acc
                R_acc = R_acc @ R_rel
            uid = p_uid
        return None

    # ------------------------------------------------------------------
    # map points
    # ------------------------------------------------------------------
    def add_points(self, positions, descs, first_kf=-1):
        """Batch-insert map points. Returns array of assigned ids."""
        n = len(positions)
        ids = []
        for _ in range(n):
            if self._free_mp:
                ids.append(self._free_mp.pop())
            else:
                if self.n_mp >= self.m_max:
                    self.grow_points()
                ids.append(self.n_mp)
                self.n_mp += 1
        ids = np.asarray(ids, np.int32)
        self.mp_pos[ids] = np.asarray(positions, np.float32)
        self.mp_desc[ids] = np.asarray(descs, np.float32)
        self.mp_valid[ids] = True
        self.mp_visible[ids] = 1
        self.mp_found[ids] = 1
        self.mp_first_kf[ids] = first_kf
        self.mark_points_dirty(ids)
        return ids

    def remove_points(self, ids):
        ids = np.asarray(ids, int)
        if len(ids) == 0:
            return
        self.mp_valid[ids] = False
        self.mark_points_dirty(ids)
        # detach observations
        sel = np.isin(self.kf_obs, ids)
        self.mark_kf_obs_dirty(np.nonzero(sel.any(axis=1))[0])
        self.kf_obs[sel] = -1
        if self.has_right:
            self.kf_obs_r[np.isin(self.kf_obs_r, ids)] = -1
        self.mp_obs_count[ids] = 0
        self._free_mp.extend(int(i) for i in ids)

    # ------------------------------------------------------------------
    # observations / covisibility
    # ------------------------------------------------------------------
    def set_observation(self, kf, slot, mp_id):
        """One observation (-1 clears it), with obs-count upkeep."""
        old = self.kf_obs[kf, slot]
        if old >= 0:
            self.mp_obs_count[old] -= 1
        self.kf_obs[kf, slot] = mp_id
        self.mark_kf_obs_dirty(kf)
        if mp_id >= 0:
            self.mp_obs_count[mp_id] += 1

    def assign_observations(self, kf, slots, mp_ids):
        """Vectorized observation assignment with obs-count upkeep."""
        slots = np.asarray(slots, int)
        mp_ids = np.asarray(mp_ids, np.int32)
        old = self.kf_obs[kf, slots]
        dec = old[old >= 0]
        np.subtract.at(self.mp_obs_count, dec, 1)
        self.kf_obs[kf, slots] = mp_ids
        self.mark_kf_obs_dirty(kf)
        inc = mp_ids[mp_ids >= 0]
        np.add.at(self.mp_obs_count, inc, 1)

    def update_covisibility(self, k):
        """Recompute covisibility weights of keyframe k against all others
        (UpdateConnections analogue: weight = #shared map points). Runs in
        the native host library when available (native/mapcore.cpp)."""
        from .. import native

        if self._covis_scratch is None:
            self._covis_scratch = np.zeros(self.m_max, np.uint8)
        native.covis_update(self.kf_obs, self.kf_valid, self.covis, k,
                            self.m_max, self._covis_scratch)

    def covisible_kfs(self, k, n=10, min_weight=15):
        """Best covisible keyframes of k (GetBestCovisibilityKeyFrames)."""
        w = self.covis[k].copy()
        w[~self.kf_valid] = 0
        order = np.argsort(-w)
        order = order[w[order] >= max(min_weight, 1)]
        return order[:n]

    def observing_slots(self, mp_ids):
        """For BA edge building: all (kf, slot) observing the given points.
        Returns (kf_idx, slot_idx, mp_idx) arrays. Native-accelerated."""
        from .. import native

        member = np.zeros(self.m_max, np.uint8)
        member[np.asarray(mp_ids, int)] = 1
        return native.observing_slots(self.kf_obs, self.kf_valid, member)

    def update_point_stats(self, mp_ids, scale_factor=1.2, n_levels=4):
        """Recompute viewing normal + scale-invariance distance band for the
        given points (MapPoint::UpdateNormalAndDepth, src/MapPoint.cc):
        normal = mean unit vector from each observing camera center to the
        point; [dmin, dmax] from the first-observer distance and octave."""
        mp_ids = np.asarray(mp_ids, int)
        mp_ids = mp_ids[self.mp_valid[mp_ids]]
        if len(mp_ids) == 0:
            return
        kf_e, slot_e, mp_e = self.observing_slots(mp_ids)
        if len(kf_e) == 0:
            return
        centers = np.einsum("kij,kj->ki", -self.kf_R.transpose(0, 2, 1),
                            self.kf_t)  # -(R^T t) for every KF row
        vec = self.mp_pos[mp_e] - centers[kf_e]
        dist = np.maximum(np.linalg.norm(vec, axis=1), 1e-9)
        unit = vec / dist[:, None]
        nsum = np.zeros((self.m_max, 3), np.float32)
        np.add.at(nsum, mp_e, unit)
        norm = np.maximum(np.linalg.norm(nsum[mp_ids], axis=1), 1e-9)
        self.mp_normal[mp_ids] = nsum[mp_ids] / norm[:, None]
        # reference distance/octave: first observation row per point
        first = np.full(self.m_max, -1, np.int64)
        rev = np.arange(len(mp_e) - 1, -1, -1)
        first[mp_e[rev]] = rev  # earliest row wins
        rows = first[mp_ids]
        d_ref = dist[rows]
        oct_ref = self.kf_octave[kf_e[rows], slot_e[rows]].astype(np.float32)
        dmax = d_ref * scale_factor ** oct_ref
        self.mp_dmax[mp_ids] = dmax
        self.mp_dmin[mp_ids] = dmax / scale_factor ** (n_levels - 1)
        self.mark_points_dirty(mp_ids)

    def refresh_point_descriptors(self, mp_ids, max_obs=8, device=None):
        """The descriptor refresh in one call: gather_distinctive,
        distinctive_kernel on `device` (None means CUDA), apply_distinctive.
        Callers that hold the map lock use the three phases, so the kernel
        runs off the lock."""
        g = self.gather_distinctive(mp_ids, max_obs)
        if g is None:
            return
        uniq, descs, mask = g
        self.apply_distinctive(uniq, distinctive_kernel(descs, mask, device))

    def gather_distinctive(self, mp_ids, max_obs=8):
        """Phase 1 of the descriptor refresh (ComputeDistinctiveDescriptors,
        src/MapPoint.cc), under the map lock: pack each point's observed
        descriptors into (P, max_obs, D) arrays for distinctive_kernel.
        Returns (uniq_ids, descs, mask) or None."""
        mp_ids = np.asarray(mp_ids, int)
        mp_ids = mp_ids[self.mp_valid[mp_ids] & (self.mp_obs_count[mp_ids] >= 2)]
        if len(mp_ids) == 0:
            return None
        kf_e, slot_e, mp_e = self.observing_slots(mp_ids)
        if len(kf_e) == 0:
            return None
        order = np.argsort(mp_e, kind="stable")
        kf_s, slot_s, mp_s = kf_e[order], slot_e[order], mp_e[order]
        starts = np.r_[0, np.nonzero(np.diff(mp_s))[0] + 1]
        lens = np.diff(np.r_[starts, len(mp_s)])
        cum = np.arange(len(mp_s)) - np.repeat(starts, lens)
        sel = cum < max_obs
        kf_s, slot_s, mp_s, cum = kf_s[sel], slot_s[sel], mp_s[sel], cum[sel]
        uniq = np.unique(mp_s)
        loc = np.zeros(self.m_max, np.int64)
        loc[uniq] = np.arange(len(uniq))
        P = len(uniq)  # rows are independent: no padding needed in eager mode
        descs = np.zeros((P, max_obs, self.desc_dim), np.float32)
        mask = np.zeros((P, max_obs), bool)
        descs[loc[mp_s], cum] = self.kf_desc[kf_s, slot_s]
        mask[loc[mp_s], cum] = True
        return uniq, descs, mask

    def apply_distinctive(self, uniq, best):
        """Phase 3 (under the map lock): write refreshed descriptors back,
        skipping points removed while the kernel ran off the lock."""
        alive = self.mp_valid[uniq]
        uniq = uniq[alive]
        self.mp_desc[uniq] = best[: len(alive)][alive]
        self.mark_points_dirty(uniq)

    def points_seen_by(self, kf_ids):
        """Union of map-point ids observed by the given keyframes."""
        obs = self.kf_obs[np.asarray(kf_ids, int)]
        ids = np.unique(obs[obs >= 0])
        return ids[self.mp_valid[ids]]

    # ------------------------------------------------------------------
    # persistence (SaveAtlas/LoadAtlas analogue)
    # ------------------------------------------------------------------
    def save(self, path):
        np.savez_compressed(
            path,
            **{f: getattr(self, f) for f in _ARRAY_FIELDS},
            n_kf=self.n_kf,
            n_mp=self.n_mp,
            next_uid=self._next_uid,
            free_mp=np.asarray(self._free_mp, np.int64),
            free_kf=np.asarray(self._free_kf, np.int64),
            loop_edges=np.asarray(self.loop_edges, np.int64).reshape(-1, 2),
            imu_flags=np.asarray([self.imu_initialized, self.viba1, self.viba2]),
            caps=np.asarray([self.k_max, self.m_max, self.n_slots, self.desc_dim, self.gdesc_dim]),
        )

    @staticmethod
    def load(path) -> "MapStore":
        z = np.load(path)
        caps = z["caps"]
        m = MapStore(*[int(c) for c in caps])
        for f in _ARRAY_FIELDS:
            if f in z:  # forward-compatible with older snapshots
                getattr(m, f)[...] = z[f]
        m.n_kf = int(z["n_kf"])
        m.n_mp = int(z["n_mp"])
        m._free_mp = [int(i) for i in z["free_mp"]]
        m._free_kf = [int(i) for i in z["free_kf"]]
        if "loop_edges" in z:
            m.loop_edges = [(int(a), int(b)) for a, b in z["loop_edges"]]
        if "imu_flags" in z:
            m.imu_initialized, m.viba1, m.viba2 = (bool(x) for x in z["imu_flags"])
        if "next_uid" in z:
            m._next_uid = int(z["next_uid"])
        else:  # older snapshot: synthesize uids
            m.kf_uid[m.kf_valid] = np.arange(int(m.kf_valid.sum()))
            m._next_uid = int(m.kf_valid.sum())
        m._uid_slot = {int(u): int(s) for s, u in enumerate(m.kf_uid) if u >= 0}
        # cull redirects are an in-session trajectory-recovery aid; a loaded
        # snapshot starts with a fresh (empty) redirect table
        return m


def distinctive_kernel(descs, mask, device=None):
    """Phase 2 of the descriptor refresh (NO lock needed): the batched
    min-median-distance selection on the packed observation arrays, run on
    `device` (None means CUDA); returns numpy."""
    from ..ops import matching as M

    device = resolve(device)

    out = M.distinctive_descriptors(upload(descs, None, device), upload(mask, None, device))
    return out.cpu().numpy()


_ARRAY_FIELDS = [
    "kf_R", "kf_t", "kf_valid", "kf_timestamp", "kf_xy", "kf_desc",
    "kf_score", "kf_octave", "kf_mask", "kf_gdesc", "kf_obs", "kf_parent",
    "kf_depth", "kf_vel", "kf_bg", "kf_ba", "kf_prev", "kf_uid",
    "mp_pos", "mp_desc", "mp_valid", "mp_visible", "mp_found",
    "mp_first_kf", "mp_obs_count", "mp_normal", "mp_dmin", "mp_dmax",
    "covis",
]
