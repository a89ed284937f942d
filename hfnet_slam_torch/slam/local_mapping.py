"""Local mapping: new-point triangulation, fuse, local BA, culling (visual).

Counterpart of hfnet_slam_tpu/slam/local_mapping.py for the monocular visual
path: the per-keyframe pipeline MapPointCulling -> CreateNewMapPoints ->
SearchInNeighbors -> descriptor/stat refresh -> LocalBundleAdjustment ->
KeyFrameCulling runs synchronously on keyframe insertion, with every compute
block a batched kernel on the mapper's device (fused.triangulate_banked,
fused.fuse_neighbors_banked, optim.ba) and the bookkeeping in numpy.

Global BA (`run_global_ba`, loop closing's full-map solve) and its
correction propagation run here too, and on a visual-inertial map the
inertial BAs: once the IMU is initialized the window BA is
`local_inertial_ba` (LocalInertialBA), and `full_inertial_ba`
(FullInertialBA) serves the staged IMU initialization and inertial loop
closing. Observations with a keyframe depth (stereo, RGB-D) carry the
depth row (weight bf / z^2) in every BA; on a stereo rig (`cfg.rig`, the
right camera's extrinsic and intrinsics) the right bank's observations
follow the left edges as ToBody edges, within ba_edge_cap.

Past the single solver's caps, global BA goes through the distributed Schur
solver (parallel/dist_ba.py) sized to the whole map, and FullInertialBA past
fiba_max_joint keyframes through the distributed joint VI solver
(parallel/dist_vi_ba.py), both on `mesh` (SLAMSystem.install_mesh) or, with
none installed, on a one-shard mesh on the mapper's device; an installed
mesh also takes global solves of dist_min_kfs keyframes or more.

Lock discipline (the async pipeline, slam/pipeline.py): each stage gathers
its inputs under `self.lock` as copies, runs its device work without it, and
re-takes it to apply the result, which is discarded when a whole-map move
(store.big_change_idx) landed meanwhile. In the synchronous pipeline the
lock is a no-op and the checks never fire.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import device as D
from ..geometry import imu as IMU
from ..optim import ba, factors, vi_ba
from ..utils.timing import timings
from . import fused
from . import map as map_mod
from .map import MapStore
from .pipeline import NULL_LOCK


@dataclasses.dataclass
class MapperConfig:
    """The reference's MapperConfig, field for field."""

    tri_neighbors: int = 30
    tri_min_covis: int = 15
    min_baseline_depth_ratio: float = 0.01
    chi2_epi: float = 16.0
    tri_min_parallax_cos: float = 0.9998
    fuse_radius: float = 3.0
    fuse_max_dist: float = 0.6
    cull_found_ratio: float = 0.25
    cull_min_obs: int = 2
    cull_horizon_kfs: int = 3
    kf_cull_redundancy: float = 0.9
    kf_cull_min_obs: int = 3
    kf_cull_min_age: int = 3
    kf_cull_max_per_round: int = 1
    ba_kf_cap: int = 32
    ba_mp_cap: int = 4096
    ba_edge_cap: int = 16384
    ba_local_kfs: int = 12
    ba_rounds: tuple = ((5, True), (10, True))
    init_ba_rounds: tuple = ((20, True),)
    bf: float = 0.0
    iba_window: int = 10
    iba_kf_cap: int = 24
    iba_mp_cap: int = 2048
    iba_edge_cap: int = 8192
    iba_rounds: tuple = ((4, True), (6, False))
    rig: tuple = None
    fiba_kf_cap: int = 48
    fiba_max_joint: int = 256
    fiba_rounds: tuple = ((8, True), (12, False))
    fiba_dist: bool = True


class LocalMapper:
    def __init__(self, cam, store: MapStore, cfg: MapperConfig = None, device=None):
        self.device = D.resolve(device)
        self.cam = cam.to(self.device)
        self.store = store
        self.cfg = cfg or MapperConfig()
        self.lock = NULL_LOCK
        self.vim = None  # slam.vi.VIManager on a visual-inertial system
        self.abort_ba = False  # mbAbortBA: stop between LM rounds, keep results
        self.recent_points: list[tuple[int, int]] = []
        self.kf_count = 0
        self.kf_born: dict[int, int] = {}
        self.stats = {"triangulated": 0, "culled_points": 0, "culled_kfs": 0, "fused": 0}
        # global solves of dist_min_kfs keyframes or more go over an
        # installed mesh (parallel/dist_ba.py)
        self.mesh = None
        self.dist_min_kfs = 48

    def _t(self, x, dtype=torch.float32):
        """Host array -> a copy on the mapper's device (device.upload)."""
        return D.upload(x, dtype, self.device)

    # ------------------------------------------------------------------
    def initial_ba(self, kf0: int, kf1: int):
        """Two-keyframe global BA after monocular initialization (first KF
        fixed), sized to the 2-KF problem."""
        store = self.store
        with self.lock:
            n_mp = int((store.kf_obs[kf1] >= 0).sum())
        mp_cap = 1 << max(6, int(max(n_mp, 1) - 1).bit_length())
        self._run_ba([kf0, kf1], fixed_ids=[kf0], rounds=self.cfg.init_ba_rounds,
                     kf_cap=2, mp_cap=mp_cap, edge_cap=2 * mp_cap)

    def process_keyframe(self, k: int, do_ba: bool = True):
        """The per-keyframe mapping pipeline (LocalMapping::Run body). do_ba
        False (keyframes are queued behind this one) runs the association
        stages and leaves the local BA to the last queued keyframe. Spans:
        `mapping`, with one child a stage."""
        with timings.span("mapping"):
            self.abort_ba = False
            with timings.span("mapping.cull_points"), self.lock:
                self.kf_count += 1
                self.kf_born[k] = self.kf_count
                self.cull_map_points()
            with timings.span("mapping.triangulate"):
                self.create_new_points(k)
            with timings.span("mapping.fuse"):
                self.fuse_neighbors(k)
            with timings.span("mapping.distinctive"):
                with self.lock:
                    seen = self.store.kf_obs[k]
                    seen = np.unique(seen[seen >= 0])
                    g = self.store.gather_distinctive(seen)
                best = None if g is None else map_mod.distinctive_kernel(g[1], g[2],
                                                                         self.device)
                with self.lock:
                    if best is not None:
                        self.store.apply_distinctive(g[0], best)
                    self.store.update_point_stats(seen)
            if do_ba:
                with timings.span("mapping.local_ba"):
                    # an IMU-initialized map gets the visual-inertial window
                    # BA (LocalMapping.cc:168)
                    if self.vim is not None and self.store.imu_initialized:
                        self.local_inertial_ba(k, self.vim)
                    else:
                        self.local_ba(k)
            with timings.span("mapping.cull_kfs"), self.lock:
                self.cull_keyframes(k)

    # ------------------------------------------------------------------
    def cull_map_points(self):
        store = self.store
        cfg = self.cfg
        keep: list[tuple[int, int]] = []
        drop: list[int] = []
        for mp, born in self.recent_points:
            if not store.mp_valid[mp]:
                continue
            age = self.kf_count - born
            ratio = store.mp_found[mp] / max(store.mp_visible[mp], 1)
            if ratio < cfg.cull_found_ratio:
                drop.append(mp)
            elif age >= 2 and store.mp_obs_count[mp] <= cfg.cull_min_obs:
                drop.append(mp)
            elif age < cfg.cull_horizon_kfs:
                keep.append((mp, born))
        store.remove_points(drop)
        self.recent_points = keep
        self.stats["culled_points"] += len(drop)

    # ------------------------------------------------------------------
    def create_new_points(self, k: int):
        """CreateNewMapPoints: all covisible neighbors matched, triangulated
        and gated in one batched device call against the keyframe bank; the
        host assigns the surviving observations."""
        store = self.store
        cfg = self.cfg
        with self.lock:
            big0 = store.big_change_idx
            if not store.kf_valid[k]:
                return
            neighbors = store.covisible_kfs(k, n=cfg.tri_neighbors, min_weight=cfg.tri_min_covis)
            if len(neighbors) == 0:
                return
            Rk, tk = store.kf_R[k].copy(), store.kf_t[k].copy()
            f_px = self.cam.fx
            seen = store.kf_obs[k]
            seen = seen[seen >= 0]
            med_depth = float(np.median((store.mp_pos[seen] @ Rk.T + tk)[:, 2])) \
                if len(seen) > 0 else 1.0
            ck = -Rk.T @ tk
            keep = []
            for j in neighbors:  # baseline gate (LocalMapping.cc:603)
                cj = -store.kf_R[j].T @ store.kf_t[j]
                if np.linalg.norm(ck - cj) >= cfg.min_baseline_depth_ratio * med_depth:
                    keep.append(int(j))
            if not keep:
                return
            B = 1 << int(np.ceil(np.log2(max(cfg.tri_neighbors, 1))))
            nbr = np.full(B, -1, np.int64)
            R21 = np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))
            t21 = np.zeros((B, 3), np.float32)
            for bi, j in enumerate(keep):
                nbr[bi] = j
                R21[bi] = store.kf_R[j] @ Rk.T
                t21[bi] = store.kf_t[j] - R21[bi] @ tk
            bank = fused.get_kf_bank(store, self.cam, self.device)
            bank.sync()
            _, b_desc, b_oct, b_mask, b_xn, b_obs = bank.snapshot()
            nbr_t, R21_t, t21_t = self._t(nbr, torch.int64), self._t(R21), self._t(t21)

        # device work without the lock, on the snapshot
        idx, good, p1 = fused.triangulate_banked(
            int(k), nbr_t, R21_t, t21_t, b_desc, b_oct, b_mask, b_xn, b_obs, f_px,
            max_dist=0.6, chi2_epi=float(cfg.chi2_epi),
            min_parallax_cos=float(cfg.tri_min_parallax_cos))
        idx, good, p1 = idx.cpu().numpy(), good.cpu().numpy(), p1.cpu().numpy()

        with self.lock:
            if store.big_change_idx != big0 or not store.kf_valid[k]:
                return  # the whole map moved meanwhile: the geometry is stale
            n_new = 0
            # claim state read afresh: slots may have gained points meanwhile
            claimed = ~(store.kf_mask[k] & (store.kf_obs[k] < 0))
            for bi, j in enumerate(keep):
                if not store.kf_valid[j]:
                    continue
                s_k = np.nonzero(good[bi] & ~claimed)[0]
                if len(s_k) == 0:
                    continue
                s_j = idx[bi][s_k]
                still = store.kf_obs[j][s_j] < 0
                s_k, s_j = s_k[still], s_j[still]
                if len(s_k) == 0:
                    continue
                pw = (p1[bi][s_k] - tk[None, :]) @ Rk
                d = store.kf_desc[k][s_k] + store.kf_desc[j][s_j]
                d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-12)
                ids = store.add_points(pw, d, first_kf=k)
                store.assign_observations(k, s_k, ids)
                store.assign_observations(j, s_j, ids)
                self.recent_points.extend((int(i), self.kf_count) for i in ids)
                claimed[s_k] = True
                n_new += len(ids)
            if n_new:
                store.update_covisibility(k)
            self.stats["triangulated"] += n_new

    # ------------------------------------------------------------------
    def fuse_neighbors(self, k: int):
        """SearchInNeighbors: project each neighbor's points into KF k and
        k's into the neighbors in one batched device call; the host applies
        the matches with the duplicate checks."""
        store = self.store
        cfg = self.cfg
        with self.lock:
            big0 = store.big_change_idx
            if not store.kf_valid[k]:
                return
            neighbors = store.covisible_kfs(k, n=cfg.tri_neighbors, min_weight=cfg.tri_min_covis)
            if len(neighbors) == 0:
                return
            pairs = [(k, int(j)) for j in neighbors] + [(int(j), k) for j in neighbors]
            P = 1 << int(np.ceil(np.log2(max(2 * cfg.tri_neighbors, 2))))
            tgt_ids = np.full(P, -1, np.int64)
            src_ids = np.full(P, -1, np.int64)
            R_t = np.tile(np.eye(3, dtype=np.float32), (P, 1, 1))
            t_t = np.zeros((P, 3), np.float32)
            # the source point sets, to decode the returned slots afterwards
            cand_host = np.full((P, store.n_slots), -1, np.int32)
            for pi, (tgt, src) in enumerate(pairs):
                tgt_ids[pi], src_ids[pi] = tgt, src
                R_t[pi], t_t[pi] = store.kf_R[tgt], store.kf_t[tgt]
                cand_host[pi] = store.kf_obs[src]
            dm = fused.get_device_map(store, self.device)
            dm.sync()
            pos_s, desc_s, _, _, _, valid_s = dm.snapshot()
            bank = fused.get_kf_bank(store, self.cam, self.device)
            bank.sync()
            b_xy, b_desc, b_oct, b_mask, _, b_obs = bank.snapshot()
            args = (self._t(tgt_ids, torch.int64), self._t(src_ids, torch.int64),
                    self._t(R_t), self._t(t_t))

        # device work without the lock, on the snapshots
        idx = fused.fuse_neighbors_banked(
            self.cam.kind, self.cam.params, float(self.cam.width), float(self.cam.height),
            *args, b_xy, b_desc, b_oct, b_mask, b_obs, pos_s, desc_s, valid_s,
            radius=float(cfg.fuse_radius), max_dist=float(cfg.fuse_max_dist)).cpu().numpy()

        with self.lock:
            if store.big_change_idx != big0:
                return  # the whole map moved meanwhile: projections are stale
            for pi, (tgt, src) in enumerate(pairs):
                if not store.kf_valid[tgt]:
                    continue
                slots = np.nonzero(idx[pi] >= 0)[0]
                if len(slots) == 0:
                    continue
                mp_new = cand_host[pi][idx[pi][slots]]
                ok = store.mp_valid[mp_new]
                tgt_obs = store.kf_obs[tgt]
                ok &= ~np.isin(mp_new, tgt_obs[tgt_obs >= 0])
                _, first = np.unique(mp_new, return_index=True)
                uniq = np.zeros(len(mp_new), bool)
                uniq[first] = True
                ok &= uniq
                # only slots that are still free (the tracker claims too)
                ok &= store.kf_obs[tgt][slots] < 0
                if ok.any():
                    store.assign_observations(tgt, slots[ok], mp_new[ok])
                    self.stats["fused"] += int(ok.sum())
            if store.kf_valid[k]:
                store.update_covisibility(k)

    # ------------------------------------------------------------------
    def local_ba(self, k: int):
        """LocalBundleAdjustment: k's covisible window optimizes; observers
        outside it are fixed, with at least two fixed cameras to pin the
        monocular gauge (scale included). Abortable by the tracker
        (abort_ba, mbAbortBA): the completed rounds are kept."""
        store = self.store
        cfg = self.cfg
        with self.lock:
            local = store.covisible_kfs(k, n=cfg.ba_local_kfs, min_weight=1)
            local = np.unique(np.append(local, k))
            mp_ids = store.points_seen_by(local)
            if len(mp_ids) == 0:
                return
            kf_e, _, _ = store.observing_slots(mp_ids)
            all_kfs = np.unique(kf_e)
            fixed = np.setdiff1d(all_kfs, local)
            fixed_ids = set(int(i) for i in fixed) | {int(all_kfs.min())}
            for cand in sorted(int(i) for i in all_kfs):
                if len(fixed_ids) >= 2:
                    break
                fixed_ids.add(cand)
        self._run_ba(list(all_kfs), fixed_ids=fixed_ids, rounds=cfg.ba_rounds,
                     mp_ids=mp_ids, should_abort=lambda: self.abort_ba, abort_mode="keep")

    def run_global_ba(self, fixed_ids, rounds=((10, True),), kf_cap=None, mp_cap=None,
                      edge_cap=None, should_abort=None):
        """Full-map BA (GlobalBundleAdjustemnt): every valid keyframe and
        landmark optimizes. A problem past the single solver's caps goes
        through the distributed Schur solver (parallel/dist_ba.py) sized to
        the whole map, which on one device is the same math, so no keyframe
        is left on rigid propagation; an installed mesh also takes problems
        of dist_min_kfs keyframes or more. Keyframes born while a detached
        solve ran, and points outside the solve, follow their anchors
        (propagate_ba_correction).

        should_abort: polled between LM iterations (the distributed route) or
        rounds (the single solver), mbStopGBA; once it holds, the solve is
        discarded without write-back."""
        store = self.store
        cfg = self.cfg
        with self.lock:
            kf_ids = store.valid_kf_ids()
            if len(kf_ids) < 2:
                return
            pre_R = store.kf_R.copy()
            pre_t = store.kf_t.copy()
            pre_uid = store.kf_uid.copy()
            n_mp = int(store.mp_valid.sum())
            n_obs = int((store.kf_obs[kf_ids] >= 0).sum())
        use_dist = (self.mesh is not None and len(kf_ids) >= self.dist_min_kfs) \
            or len(kf_ids) > (kf_cap or cfg.ba_kf_cap) \
            or n_mp > (mp_cap or cfg.ba_mp_cap) \
            or n_obs > (edge_cap or cfg.ba_edge_cap)
        fixed = set(int(i) for i in fixed_ids)
        if use_dist:
            res = self._run_dist_gba(list(kf_ids), fixed, rounds, should_abort=should_abort)
        else:
            res = self._run_ba(list(kf_ids), fixed_ids=fixed, rounds=rounds, kf_cap=kf_cap,
                               mp_cap=mp_cap, edge_cap=edge_cap, should_abort=should_abort)
        if res is None:
            return
        with self.lock:
            # keyframes born during a detached solve keep their pose
            # relative to their anchors: their "pre" pose is the current one.
            # The store may have grown meanwhile: new slots count as born
            if len(pre_uid) < store.k_max:
                n_old = len(pre_uid)
                pre_R = np.concatenate([pre_R, store.kf_R[n_old:]], 0)
                pre_t = np.concatenate([pre_t, store.kf_t[n_old:]], 0)
                pre_uid = np.concatenate([pre_uid, np.full(store.k_max - n_old, -1, np.int64)])
            born = store.kf_valid & (store.kf_uid != pre_uid)
            pre_R[born] = store.kf_R[born]
            pre_t[born] = store.kf_t[born]
            self.propagate_ba_correction(res["kf_ids"], res["mp_ids"], pre_R, pre_t)
            store.bump_change()  # whole-map move: the device mirror re-uploads

    def _default_mesh(self):
        """One shard on the mapper's device: the route for uncapped solves
        when no mesh is installed (the distributed solver's math on one
        device, with no fixed keyframe cap)."""
        from ..parallel.multihost import Mesh

        return Mesh(self.device)

    def _run_dist_gba(self, kf_ids, fixed_ids, rounds, should_abort=None):
        """Global BA through the mesh's Schur solver (parallel/dist_ba.py):
        landmark shards over the mesh, the reduced camera system summed and
        solved replicated. Sized to the whole problem: every valid keyframe,
        point and edge takes part, with capacities computed from the problem
        and padded to powers of two. Depth rows ride along; right-camera
        (ToBody) edges are not sharded (logged per solve). Outliers are
        detached by the final reprojection chi2 (with the depth row)."""
        from ..parallel import dist_ba as DBA
        from ..utils.log import warn

        mesh = self.mesh if self.mesh is not None else self._default_mesh()
        self.stats["dist_gba"] = self.stats.get("dist_gba", 0) + 1
        store = self.store
        if store.has_right:
            warn("dist GBA: right-camera (ToBody) edges are not sharded; the global solve "
                 "uses the left bank and the depth rows only")
        with self.lock:
            big0 = store.big_change_idx
            kf_ids, mp_ids, kf_e, slot_e, mp_e = self._gather_edges(kf_ids, None, None, None,
                                                                    None)
            if len(kf_e) == 0:
                return None
            K, M = len(kf_ids), len(mp_ids)
            kf_loc = np.zeros(store.k_max, np.int64)
            kf_loc[kf_ids] = np.arange(K)
            mp_loc = np.zeros(store.m_max, np.int64)
            mp_loc[mp_ids] = np.arange(M)
            fixed = np.asarray([int(i) in fixed_ids for i in kf_ids])
            uv = store.kf_xy[kf_e, slot_e]
            inv_s2 = (1.0 / (1.2 ** (2.0 * store.kf_octave[kf_e, slot_e]))).astype(np.float32)
            if self.cfg.bf > 0:
                z_raw = store.kf_depth[kf_e, slot_e]
                z_meas = np.where(z_raw > 0, z_raw, 0.0).astype(np.float32)
                wz = np.where(z_raw > 0, self.cfg.bf / np.maximum(z_raw, 1e-3) ** 2,
                              0.0).astype(np.float32)
            else:
                z_meas = np.zeros(len(kf_e), np.float32)
                wz = np.zeros(len(kf_e), np.float32)
            n_sh = mesh.size
            # exact per-shard capacities (shard d holds the edges of the
            # landmarks whose local id is d modulo the shard count), padded
            # to powers of two to bound the shapes as the map grows; padding
            # cameras are fixed identity poses no edge references
            Ml = 1 << max(4, int(-(-M // n_sh) - 1).bit_length())
            per_dev = np.bincount(mp_loc[mp_e] % n_sh, minlength=n_sh)
            El = 1 << max(6, int(per_dev.max() - 1).bit_length())
            Kp = 1 << max(3, int(K - 1).bit_length())
            R_pad = np.tile(np.eye(3, dtype=np.float32), (Kp, 1, 1))
            t_pad = np.zeros((Kp, 3), np.float32)
            f_pad = np.ones(Kp, bool)
            R_pad[:K] = store.kf_R[kf_ids]
            t_pad[:K] = store.kf_t[kf_ids]
            f_pad[:K] = fixed
            prob, _ = DBA.partition_edges(
                n_sh, Kp, Ml, El, R_pad, t_pad, f_pad, store.mp_pos[mp_ids], kf_loc[kf_e],
                mp_loc[mp_e], uv, inv_s2, np.ones(len(kf_e), bool), z_meas=z_meas, wz=wz,
                device=mesh.device)
        if int(prob.valid.sum()) != len(kf_e):
            raise RuntimeError("partition_edges dropped edges despite exact sizing")
        out, _, costs = DBA.dist_bundle_adjust(
            self.cam.kind, self.cam.params.to(mesh.device), prob, mesh, rounds=rounds,
            should_abort=should_abort)
        R_new = out.poses_R.cpu().numpy()[:K]
        t_new = out.poses_t.cpu().numpy()[:K]
        pts = out.points.cpu().numpy()  # (D, Ml, 3)
        with self.lock:
            if should_abort is not None and should_abort():
                return None  # mbStopGBA: discard
            if store.big_change_idx != big0:
                return None  # the whole map moved under the solve: stale
            free = ~fixed & store.kf_valid[kf_ids]
            store.kf_R[kf_ids[free]] = R_new[free]
            store.kf_t[kf_ids[free]] = t_new[free]
            # the landmark shards back in map order (round-robin ownership)
            owner = np.arange(M) % pts.shape[0]
            local = np.arange(M) // pts.shape[0]
            alive = store.mp_valid[mp_ids] & (local < pts.shape[1])
            store.mp_pos[mp_ids[alive]] = pts[owner[alive], local[alive]]
            # outliers by the final reprojection chi2, with the depth row
            p_c = np.einsum("eij,ej->ei", store.kf_R[kf_e], store.mp_pos[mp_e]) + \
                store.kf_t[kf_e]
            uv_hat = self.cam.project(self._t(p_c)).cpu().numpy()
            chi2 = ((uv_hat - uv) ** 2).sum(1) * inv_s2
            chi2 = chi2 + (wz * (p_c[:, 2] - z_meas)) ** 2 * inv_s2
            th = np.where(wz > 0, factors.CHI2_STEREO, factors.CHI2_MONO)
            self._detach_outliers((chi2 < th) & (p_c[:, 2] > 0), kf_e, slot_e, mp_ids)
            store.mark_points_dirty(mp_ids)
        return {"kf_ids": kf_ids, "mp_ids": mp_ids, "costs": costs}

    def propagate_ba_correction(self, opt_kfs, opt_mps, pre_R, pre_t, scope=None):
        """Correct every valid keyframe and point NOT covered by a solve:
        an uncovered keyframe rigidly follows its nearest covered anchor
        (spanning-tree parent, then strongest covisible, then nearest in
        time), T_new = (T_old T_anc_old^-1) T_anc_new; an uncovered point
        follows its reference keyframe (RunGlobalBundleAdjustment's
        propagation, LoopClosing.cc:2440-2540). `scope` limits the keyframes
        considered (the pose graph's write-back passes the keyframes born
        during its detached solve); None means every valid keyframe."""
        store = self.store
        opt_set = set(int(i) for i in opt_kfs)
        all_kfs = store.valid_kf_ids() if scope is None else \
            np.asarray([j for j in scope if store.kf_valid[j]], int)
        pending = [int(j) for j in all_kfs if int(j) not in opt_set]
        if pending:
            covered = np.zeros(store.k_max, bool)
            covered[list(opt_set)] = True
            opt_ts = np.asarray(sorted(opt_set))
            # ascending id: parents are older, so one pass resolves chains
            for j in sorted(pending):
                anc = int(store.kf_parent[j])
                if anc < 0 or not (store.kf_valid[anc] and covered[anc]):
                    w = np.where(covered, store.covis[j], 0)
                    if w.max() > 0:
                        anc = int(np.argmax(w))
                    else:
                        dt = np.abs(store.kf_timestamp[opt_ts] - store.kf_timestamp[j])
                        anc = int(opt_ts[np.argmin(dt)])
                self._apply_delta(j, anc, pre_R, pre_t)
                covered[j] = True
        mp_all = np.nonzero(store.mp_valid)[0]
        left = np.setdiff1d(mp_all, np.asarray(opt_mps, int))
        if len(left) == 0:
            return
        ref = store.mp_first_kf[left].copy()
        bad = (ref < 0) | (~store.kf_valid[np.clip(ref, 0, store.k_max - 1)])
        if bad.any():
            kf_e, _, mp_e = store.observing_slots(left[bad])
            first = {}
            for kf_, mp_ in zip(kf_e, mp_e):
                first.setdefault(int(mp_), int(kf_))
            ref[bad] = [first.get(int(m), -1) for m in left[bad]]
        for g in np.unique(ref):
            if g < 0 or not store.kf_valid[g]:
                continue
            ids = left[ref == g]
            p_cam = store.mp_pos[ids] @ pre_R[g].T + pre_t[g]
            store.mp_pos[ids] = (p_cam - store.kf_t[g]) @ store.kf_R[g]

    def _apply_delta(self, j, anc, pre_R, pre_t):
        """T_j_new = (T_j_old T_anc_old^-1) T_anc_new."""
        store = self.store
        R_rel = pre_R[j] @ pre_R[anc].T
        t_rel = pre_t[j] - R_rel @ pre_t[anc]
        store.kf_R[j] = R_rel @ store.kf_R[anc]
        store.kf_t[j] = R_rel @ store.kf_t[anc] + t_rel

    def _gather_edges(self, kf_ids, mp_ids, kf_cap, mp_cap, edge_cap):
        """(kf, slot, mp) observation triples among the given keyframe and
        point sets, capacity-trimmed."""
        store = self.store
        kf_ids = np.asarray(sorted(int(i) for i in kf_ids), int)[:kf_cap]
        if mp_ids is None:
            mp_ids = store.points_seen_by(kf_ids)
        kf_in = np.isin(np.arange(store.k_max), kf_ids)
        kf_e, slot_e, mp_e = store.observing_slots(mp_ids)
        keep = kf_in[kf_e]
        kf_e, slot_e, mp_e = kf_e[keep], slot_e[keep], mp_e[keep]
        if len(kf_e) == 0:
            return kf_ids, np.empty(0, int), kf_e, slot_e, mp_e
        mp_ids = np.intersect1d(mp_ids, np.unique(mp_e))[:mp_cap]
        mp_keep = np.isin(mp_e, mp_ids)
        kf_e, slot_e, mp_e = kf_e[mp_keep], slot_e[mp_keep], mp_e[mp_keep]
        return kf_ids, mp_ids, kf_e[:edge_cap], slot_e[:edge_cap], mp_e[:edge_cap]

    def _edge_arrays(self, kf_ids, mp_ids, kf_e, slot_e, mp_e, E):
        """Padded fixed-shape edge arrays for a BA problem."""
        store = self.store
        kf_loc = np.zeros(store.k_max, np.int64)
        kf_loc[kf_ids] = np.arange(len(kf_ids))
        mp_loc = np.zeros(store.m_max, np.int64)
        mp_loc[mp_ids] = np.arange(len(mp_ids))
        kf_idx = np.zeros(E, np.int64)
        pt_idx = np.zeros(E, np.int64)
        uv = np.zeros((E, 2), np.float32)
        inv_s2 = np.ones(E, np.float32)
        valid = np.zeros(E, bool)
        z_meas = np.zeros(E, np.float32)
        wz = np.zeros(E, np.float32)
        n_e = len(kf_e)
        kf_idx[:n_e] = kf_loc[kf_e]
        pt_idx[:n_e] = mp_loc[mp_e]
        uv[:n_e] = store.kf_xy[kf_e, slot_e]
        inv_s2[:n_e] = 1.0 / (1.2 ** (2.0 * store.kf_octave[kf_e, slot_e]))
        valid[:n_e] = True
        if self.cfg.bf > 0:
            z = store.kf_depth[kf_e, slot_e]
            z_meas[:n_e] = np.where(z > 0, z, 0.0)
            wz[:n_e] = np.where(z > 0, self.cfg.bf / np.maximum(z, 1e-3) ** 2, 0.0)
        return kf_idx, pt_idx, uv, inv_s2, valid, z_meas, wz

    def _right_edges(self, kf_ids, mp_ids, n_e, kf_idx, pt_idx, uv, inv_s2, valid):
        """Append the right bank's observations of the problem's points by
        its keyframes after the n_e left edges, in place, as far as the edge
        capacity allows (a warning counts the dropped ones). Returns cam_sel
        and the (kf, slot) of the appended edges."""
        store = self.store
        E = len(valid)
        cam_sel = np.zeros(E, np.float32)
        rkf, rslot, rmp = store.right_observing_slots(mp_ids)
        keep = np.isin(rkf, kf_ids) & np.isin(rmp, mp_ids)
        rkf, rslot, rmp = rkf[keep], rslot[keep], rmp[keep]
        n_r = min(len(rkf), E - n_e)
        self.stats["right_edges"] = n_r
        self.stats["right_edges_dropped"] = len(rkf) - n_r
        if n_r < len(rkf):
            from ..utils.log import warn

            warn(f"local BA: {len(rkf) - n_r} right-camera edges over edge_cap dropped")
        rkf, rslot, rmp = rkf[:n_r], rslot[:n_r], rmp[:n_r]
        kf_loc = np.zeros(store.k_max, np.int64)
        kf_loc[kf_ids] = np.arange(len(kf_ids))
        mp_loc = np.zeros(store.m_max, np.int64)
        mp_loc[mp_ids] = np.arange(len(mp_ids))
        e = slice(n_e, n_e + n_r)
        kf_idx[e] = kf_loc[rkf]
        pt_idx[e] = mp_loc[rmp]
        uv[e] = store.kf_xy_r[rkf, rslot]
        inv_s2[e] = 1.0 / (1.2 ** (2.0 * store.kf_oct_r[rkf, rslot]))
        valid[e] = True
        cam_sel[e] = 1.0
        return cam_sel, rkf, rslot

    def _detach_outliers(self, out_valid, kf_e, slot_e, mp_ids):
        """Erase observations classified as outliers; kill orphaned points."""
        store = self.store
        bad = ~out_valid
        if bad.any():
            kf_b, slot_b = kf_e[bad], slot_e[bad]
            alive = store.kf_valid[kf_b]
            kf_b, slot_b = kf_b[alive], slot_b[alive]
            for kf in np.unique(kf_b):
                sel = kf_b == kf
                store.assign_observations(int(kf), slot_b[sel],
                                          np.full(int(sel.sum()), -1, np.int32))
            orphans = mp_ids[store.mp_valid[mp_ids] & (store.mp_obs_count[mp_ids] < 2)]
            store.remove_points(orphans)

    def _run_ba(self, kf_ids, fixed_ids, rounds, mp_ids=None, kf_cap=None,
                mp_cap=None, edge_cap=None, should_abort=None, abort_mode="discard"):
        """Build a fixed-capacity BAProblem from the store under the lock,
        solve it on the device without the lock, write back under it, and
        detach outlier observations. A solve that raced a whole-map move
        (store.big_change_idx) is discarded. abort_mode says what an abort
        means: "discard" (mbStopGBA, detached global solves: nothing lands)
        or "keep" (mbAbortBA, the local BA: the completed rounds land, g2o's
        forceStop)."""
        cfg = self.cfg
        K = kf_cap or cfg.ba_kf_cap
        M = mp_cap or cfg.ba_mp_cap
        E = edge_cap or cfg.ba_edge_cap
        store = self.store
        with timings.span("ba.build"), self.lock:
            big0 = store.big_change_idx
            kf_ids, mp_ids, kf_e, slot_e, mp_e = self._gather_edges(kf_ids, mp_ids, K, M, E)
            if len(kf_e) == 0:
                return None
            poses_R = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
            poses_t = np.zeros((K, 3), np.float32)
            poses_R[: len(kf_ids)] = store.kf_R[kf_ids]
            poses_t[: len(kf_ids)] = store.kf_t[kf_ids]
            fixed = np.ones(K, bool)
            fixed[: len(kf_ids)] = [int(i) in fixed_ids for i in kf_ids]
            points = np.zeros((M, 3), np.float32)
            points[: len(mp_ids)] = store.mp_pos[mp_ids]
            kf_idx, pt_idx, uv, inv_s2, valid, z_meas, wz = self._edge_arrays(
                kf_ids, mp_ids, kf_e, slot_e, mp_e, E)
            n_e = len(kf_e)
            rig = {}
            rkf = rslot = np.empty(0, np.int64)
            if cfg.rig is not None and store.has_right:
                # right-camera (ToBody) edges after the left ones
                cam_sel, rkf, rslot = self._right_edges(kf_ids, mp_ids, n_e, kf_idx, pt_idx,
                                                        uv, inv_s2, valid)
                rig = dict(cam_sel=self._t(cam_sel), rig_R=self._t(cfg.rig[0]),
                           rig_t=self._t(cfg.rig[1]), params_r=self._t(cfg.rig[2]))
            prob = ba.BAProblem(
                poses_R=self._t(poses_R), poses_t=self._t(poses_t),
                fixed=self._t(fixed, torch.bool), points=self._t(points),
                kf_idx=self._t(kf_idx, torch.int64), pt_idx=self._t(pt_idx, torch.int64),
                uv=self._t(uv), inv_sigma2=self._t(inv_s2), valid=self._t(valid, torch.bool),
                z_meas=self._t(z_meas), wz=self._t(wz), **rig)
        with timings.span("ba.solve"):
            out = ba.bundle_adjust(self.cam.kind, self.cam.params, prob, rounds=rounds,
                                   should_abort=should_abort)
        with timings.span("ba.readback"):
            R_new = out.poses_R.cpu().numpy()[: len(kf_ids)]
            t_new = out.poses_t.cpu().numpy()[: len(kf_ids)]
            pts = out.points.cpu().numpy()[: len(mp_ids)]
            out_valid = out.valid.cpu().numpy()

        with timings.span("ba.writeback"), self.lock:
            if abort_mode == "discard" and should_abort is not None and should_abort():
                return None  # mbStopGBA: discard
            if store.big_change_idx != big0:
                return None  # the whole map moved under the solve: stale
            free = ~fixed[: len(kf_ids)] & store.kf_valid[kf_ids]
            store.kf_R[kf_ids[free]] = R_new[free]
            store.kf_t[kf_ids[free]] = t_new[free]
            alive = store.mp_valid[mp_ids]
            store.mp_pos[mp_ids[alive]] = pts[alive]
            self._detach_outliers(out_valid[:n_e], kf_e, slot_e, mp_ids)
            bad_r = ~out_valid[n_e:n_e + len(rkf)]
            if bad_r.any():
                store.kf_obs_r[rkf[bad_r], rslot[bad_r]] = -1
            store.mark_points_dirty(mp_ids)
            store.bump_change(dirty_points=False)
        return {"kf_ids": kf_ids, "mp_ids": mp_ids}

    # ------------------------------------------------------------------
    def cull_keyframes(self, k: int):
        """KeyFrameCulling: remove a local covisible KF when >90% of its
        points are seen by >=3 other keyframes at the same or finer scale."""
        store = self.store
        cfg = self.cfg
        n_culled = 0
        for j in store.covisible_kfs(k, n=cfg.ba_local_kfs, min_weight=1):
            j = int(j)
            if j == k or j <= 1:  # never cull the init pair
                continue
            if self.kf_count - self.kf_born.get(j, 0) < cfg.kf_cull_min_age:
                continue
            if self.vim is not None and not self._inertial_cull_ok(j):
                continue
            slots = np.nonzero(store.kf_obs[j] >= 0)[0]
            if len(slots) == 0:
                continue
            mp = store.kf_obs[j][slots]
            oct_j = store.kf_octave[j, slots]
            kf_e, slot_e, mp_e = store.observing_slots(mp)
            other = kf_e != j
            if not other.any():
                continue
            loc = np.zeros(store.m_max, np.int64)
            loc[mp] = np.arange(len(mp))
            oct_e = store.kf_octave[kf_e[other], slot_e[other]]
            finer = oct_e <= oct_j[loc[mp_e[other]]] + 1
            counts = np.zeros(len(mp), np.int64)
            np.add.at(counts, loc[mp_e[other]][finer], 1)
            if (counts >= cfg.kf_cull_min_obs).mean() > cfg.kf_cull_redundancy:
                self._repair_imu_chain(j)
                store.remove_keyframe(j)
                self.stats["culled_kfs"] += 1
                n_culled += 1
                if n_culled >= cfg.kf_cull_max_per_round:
                    break

    # ------------------------------------------------------------------
    # visual-inertial BA (LocalInertialBA / FullInertialBA)
    # ------------------------------------------------------------------
    def local_inertial_ba(self, k: int, vim):
        """Temporal-window VI-BA (LocalInertialBA): the last iba_window chain
        keyframes optimize with their landmarks; the chain predecessor and
        the other observers are fixed anchors (the most recent ones, up to
        iba_kf_cap in all). Abortable like local_ba; completed rounds land."""
        store = self.store
        cfg = self.cfg
        with self.lock:
            window = [k]
            while len(window) < cfg.iba_window:
                p = int(store.kf_prev[window[-1]])
                if p < 0 or not store.kf_valid[p]:
                    break
                window.append(p)
            window = window[::-1]
            if len(window) < 2:
                return
            mp_ids = store.points_seen_by(np.asarray(window))
            if len(mp_ids) == 0:
                return
            kf_e, _, _ = store.observing_slots(mp_ids)
            anchors = np.setdiff1d(np.unique(kf_e), window)
            p0 = int(store.kf_prev[window[0]])
            if p0 >= 0 and store.kf_valid[p0]:
                anchors = np.union1d(anchors, [p0])
            anchors = anchors[-max(cfg.iba_kf_cap - len(window), 1):]
        self._run_inertial_ba(opt_ids=window, fixed_ids=[int(a) for a in anchors], vim=vim,
                              mp_ids=mp_ids, rounds=cfg.iba_rounds, kf_cap=cfg.iba_kf_cap,
                              should_abort=lambda: self.abort_ba, abort_mode="keep")

    def full_inertial_ba(self, vim, prior_g=0.0, prior_a=0.0, rounds=None, should_abort=None):
        """Whole-map VI-BA (FullInertialBA): every keyframe's 15-d state in
        one problem, for the staged IMU initialization and inertial loop
        closing. Up to fiba_max_joint keyframes the solve is joint, with
        capacities sized to the map (powers of two). Past that, fiba_dist=True
        solves the same joint problem through the distributed VI solver
        (parallel/dist_vi_ba.py) on the mesh, and fiba_dist=False sweeps
        overlapping chunks of fiba_kf_cap keyframes (Gauss-Seidel). Keyframes
        and points outside the solve follow their anchors
        (propagate_ba_correction).

        should_abort: polled between chunks and LM iterations (mbStopGBA); on
        True the rest is skipped and nothing more is written back."""
        from ..utils.log import warn

        store = self.store
        cfg = self.cfg
        with self.lock:
            kf_ids = store.valid_kf_ids()
            kf_ids = [int(i) for i in kf_ids[np.argsort(store.kf_timestamp[kf_ids])]]
            if len(kf_ids) < 3:
                return
            pre_R = store.kf_R.copy()
            pre_t = store.kf_t.copy()
            pre_uid = store.kf_uid.copy()
            n_mp = int(store.mp_valid.sum())
            n_obs = int((store.kf_obs[kf_ids] >= 0).sum())
        rounds = rounds or cfg.fiba_rounds
        opt_all, mp_all = [], []
        n_chunks = 0
        if len(kf_ids) <= cfg.fiba_max_joint or cfg.fiba_dist:
            use_dist = len(kf_ids) > cfg.fiba_max_joint
            if use_dist:
                warn(f"full_inertial_ba: {len(kf_ids)} KFs > fiba_max_joint="
                     f"{cfg.fiba_max_joint}; distributed joint solve")
            Kp = 1 << max(3, int(len(kf_ids) - 1).bit_length())
            Mp = 1 << max(6, int(max(n_mp, 1) - 1).bit_length())
            Ep = 1 << max(8, int(max(n_obs, 1) - 1).bit_length())
            res = self._run_inertial_ba(opt_ids=kf_ids, fixed_ids=[], vim=vim, mp_ids=None,
                                        rounds=rounds, kf_cap=Kp, mp_cap=Mp, edge_cap=Ep,
                                        prior_g=prior_g, prior_a=prior_a,
                                        should_abort=should_abort, use_dist=use_dist)
            if res is None:
                return
            if res:
                opt_all.extend(int(i) for i in res["kf_ids"])
                mp_all.extend(int(i) for i in res["mp_ids"])
        else:
            W = cfg.fiba_kf_cap
            overlap = min(8, max(2, W // 4))
            warn(f"full_inertial_ba: {len(kf_ids)} KFs > fiba_max_joint={cfg.fiba_max_joint}; "
                 f"chunked Gauss-Seidel sweep (window {W}, overlap {overlap})")
            for sweep in range(2):
                start = 0
                while start < len(kf_ids):
                    if should_abort is not None and should_abort():
                        return
                    if start == 0:
                        opt, anchors = kf_ids[:W], []
                    else:
                        anchors = kf_ids[start - overlap:start]
                        opt = kf_ids[start:start + (W - overlap)]
                    if not opt:
                        break
                    first = sweep == 0 and start == 0
                    res = self._run_inertial_ba(
                        opt_ids=opt, fixed_ids=anchors, vim=vim, mp_ids=None, rounds=rounds,
                        kf_cap=W, prior_g=prior_g if first else 0.0,
                        prior_a=prior_a if first else 0.0, should_abort=should_abort)
                    if res is None:
                        return
                    if res:
                        opt_all.extend(int(i) for i in res["kf_ids"])
                        mp_all.extend(int(i) for i in res["mp_ids"])
                    start += len(opt) if start == 0 else (W - overlap)
                    n_chunks += 1
            self.stats["fiba_chunks"] = self.stats.get("fiba_chunks", 0) + n_chunks
        if not opt_all:
            return
        with self.lock:
            if len(pre_uid) < store.k_max:
                n_old = len(pre_uid)
                pre_R = np.concatenate([pre_R, store.kf_R[n_old:]], 0)
                pre_t = np.concatenate([pre_t, store.kf_t[n_old:]], 0)
                pre_uid = np.concatenate([pre_uid, np.full(store.k_max - n_old, -1, np.int64)])
            born = store.kf_valid & (store.kf_uid != pre_uid)
            pre_R[born] = store.kf_R[born]
            pre_t[born] = store.kf_t[born]
            self.propagate_ba_correction(np.unique(opt_all), np.unique(mp_all), pre_R, pre_t)
            store.bump_change()

    def _run_inertial_ba(self, opt_ids, fixed_ids, vim, mp_ids, rounds, kf_cap, prior_g=0.0,
                         prior_a=0.0, should_abort=None, mp_cap=None, edge_cap=None,
                         abort_mode="discard", use_dist=False):
        """Build a VIBAProblem under the lock, solve it without the lock (on
        the mesh with use_dist), write the body states and landmarks back
        under it. Returns the solved id sets, {} when there was nothing to
        solve, or None when the solve went stale or was aborted and was
        discarded."""
        store = self.store
        with self.lock:
            big0 = store.big_change_idx
            built = self._build_inertial_problem(opt_ids, fixed_ids, vim, mp_ids, kf_cap,
                                                 prior_g, prior_a, mp_cap=mp_cap,
                                                 edge_cap=edge_cap)
        if built is None:
            return {}
        prob, kf_ids, mp_ids, fixed, fix_pose_only, kf_e, slot_e, n_e = built
        if use_dist:
            from ..parallel import dist_vi_ba

            mesh = self.mesh if self.mesh is not None else self._default_mesh()
            self.stats["dist_fiba"] = self.stats.get("dist_fiba", 0) + 1
            out = dist_vi_ba.dist_vi_bundle_adjust(self.cam.kind, self.cam.params, prob, mesh,
                                                   rounds=rounds, should_abort=should_abort)
        else:
            out = vi_ba.vi_bundle_adjust(self.cam.kind, self.cam.params, prob, rounds=rounds,
                                         should_abort=should_abort)
        out = {k: getattr(out, k).cpu().numpy()
               for k in ("R_wb", "p_wb", "v", "bg", "ba", "points", "valid")}
        with self.lock:
            if abort_mode == "discard" and should_abort is not None and should_abort():
                return None
            if store.big_change_idx != big0:
                return None
            return self._write_back_inertial(out, kf_ids, mp_ids, fixed, fix_pose_only, vim,
                                             kf_e, slot_e, n_e)

    def _build_inertial_problem(self, opt_ids, fixed_ids, vim, mp_ids, kf_cap, prior_g,
                                prior_a, mp_cap=None, edge_cap=None):
        store = self.store
        cfg = self.cfg
        K = kf_cap
        M = mp_cap or cfg.iba_mp_cap
        E = edge_cap or cfg.iba_edge_cap
        fixed_set = set(int(i) for i in fixed_ids)
        all_ids = sorted(set(int(i) for i in opt_ids) | fixed_set)
        kf_ids, mp_ids, kf_e, slot_e, mp_e = self._gather_edges(all_ids, mp_ids, K, M, E)
        if len(kf_e) == 0:
            return None
        nk = len(kf_ids)
        kf_loc = {int(kf): i for i, kf in enumerate(kf_ids)}
        R_wb = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
        p_wb = np.zeros((K, 3), np.float32)
        for i, kf in enumerate(kf_ids):
            R_wb[i], p_wb[i] = vim.cam_to_body(store.kf_R[kf], store.kf_t[kf])
        v = np.zeros((K, 3), np.float32)
        bg = np.zeros((K, 3), np.float32)
        ba_ = np.zeros((K, 3), np.float32)
        v[:nk] = store.kf_vel[kf_ids]
        bg[:nk] = store.kf_bg[kf_ids]
        ba_[:nk] = store.kf_ba[kf_ids]
        fixed = np.ones(K, bool)
        fixed[:nk] = [int(i) in fixed_set for i in kf_ids]
        # gauge: with nothing fixed (FullInertialBA) the oldest pose is held,
        # its velocity and biases stay in the chain
        fix_pose_only = np.zeros(K, bool)
        if not fixed[:nk].any():
            fix_pose_only[int(np.argmin(store.kf_timestamp[kf_ids]))] = True
        points = np.zeros((M, 3), np.float32)
        points[: len(mp_ids)] = store.mp_pos[mp_ids]
        kf_idx, pt_idx, uv, inv_s2, valid, z_meas, wz = self._edge_arrays(
            kf_ids, mp_ids, kf_e, slot_e, mp_e, E)
        n_e = len(kf_e)
        # inertial links: consecutive chain pairs with both ends in the set
        li = np.zeros(K, np.int64)
        lj = np.zeros(K, np.int64)
        lvalid = np.zeros(K, bool)
        pres = []
        for kf in kf_ids:
            p = int(store.kf_prev[kf])
            if p in kf_loc and int(kf) in vim.kf_pre and len(pres) < K:
                li[len(pres)] = kf_loc[p]
                lj[len(pres)] = kf_loc[int(kf)]
                lvalid[len(pres)] = True
                pres.append(vim.kf_pre[int(kf)].to(self.device))
        if len(pres) < 2:
            return None  # no usable chain; the visual BA covers it
        empty = IMU.empty_preintegrated(device=self.device)
        pres.extend([empty] * (K - len(pres)))
        prob = vi_ba.VIBAProblem(
            R_wb=self._t(R_wb), p_wb=self._t(p_wb), v=self._t(v), bg=self._t(bg),
            ba=self._t(ba_), fixed=self._t(fixed, torch.bool),
            fix_pose_only=self._t(fix_pose_only, torch.bool), points=self._t(points),
            Tbc_R=self._t(vim.calib.Tbc_R), Tbc_t=self._t(vim.calib.Tbc_t),
            kf_idx=self._t(kf_idx, torch.int64), pt_idx=self._t(pt_idx, torch.int64),
            uv=self._t(uv), inv_sigma2=self._t(inv_s2), valid=self._t(valid, torch.bool),
            z_meas=self._t(z_meas), wz=self._t(wz), li=self._t(li, torch.int64),
            lj=self._t(lj, torch.int64), pre=IMU.stack(pres),
            lvalid=self._t(lvalid, torch.bool), prior_g=self._t(float(prior_g)),
            prior_a=self._t(float(prior_a)))
        return prob, kf_ids, mp_ids, fixed, fix_pose_only, kf_e, slot_e, n_e

    def _write_back_inertial(self, out, kf_ids, mp_ids, fixed, fix_pose_only, vim, kf_e,
                             slot_e, n_e):
        store = self.store
        nk = len(kf_ids)
        free = ~fixed[:nk]
        for i, kf in enumerate(kf_ids):
            if not free[i]:
                continue
            if not fix_pose_only[i]:
                store.kf_R[kf], store.kf_t[kf] = vim.body_to_cam(out["R_wb"][i], out["p_wb"][i])
            store.kf_vel[kf] = out["v"][i]
            store.kf_bg[kf] = out["bg"][i]
            store.kf_ba[kf] = out["ba"][i]
        store.mp_pos[mp_ids] = out["points"][: len(mp_ids)]
        store.mark_points_dirty(mp_ids)
        self._detach_outliers(out["valid"][:n_e], kf_e, slot_e, mp_ids)
        vim.reintegrate_chain()
        # an incremental change: big_change_idx is for whole-map moves
        store.bump_change(dirty_points=False)
        return {"kf_ids": kf_ids, "mp_ids": mp_ids}

    def _inertial_cull_ok(self, j: int) -> bool:
        """Inertial culling gates (LocalMapping.cc:1195-1229): keep the map
        above 21 keyframes, and splice a chain link out only when the span it
        leaves is short (< 3 s once the IMU is initialized, else < 0.5 s)."""
        store = self.store
        if store.kf_valid.sum() <= 21:
            return False
        prev = int(store.kf_prev[j])
        succ = [s for s in np.nonzero(store.kf_prev == j)[0] if store.kf_valid[s]]
        if prev < 0 or not store.kf_valid[prev] or not succ:
            return False
        t = float(store.kf_timestamp[succ[0]] - store.kf_timestamp[prev])
        return (store.imu_initialized and t < 3.0) or (t < 0.5)

    def _repair_imu_chain(self, j: int):
        """Splice keyframe j out of the IMU chain before it is culled: its
        successor's preintegration absorbs j's (MergePrevious)."""
        if self.vim is None:
            return
        store = self.store
        vim = self.vim
        prev = int(store.kf_prev[j])
        for s in np.nonzero(store.kf_prev == j)[0]:
            s = int(s)
            store.kf_prev[s] = prev
            if s in vim.kf_pre and j in vim.kf_pre:
                vim.kf_pre[s] = IMU.compose(vim.kf_pre[j], vim.kf_pre[s])
                if s in vim.kf_meas and j in vim.kf_meas:
                    vim.kf_meas[s] = np.concatenate([vim.kf_meas[j], vim.kf_meas[s]], axis=0)
                else:
                    vim.kf_meas.pop(s, None)
            else:
                vim.kf_pre.pop(s, None)
                vim.kf_meas.pop(s, None)
        vim.kf_pre.pop(j, None)
        vim.kf_meas.pop(j, None)
