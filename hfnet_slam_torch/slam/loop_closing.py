"""Loop closing: place recognition, Sim3 estimation, loop correction, merges.

Counterpart of hfnet_slam_tpu/slam/loop_closing.py. LoopCloser.process_keyframe
runs inline on keyframe insertion in the synchronous pipeline, on the loop
worker's thread in the async one (slam/pipeline.py):

  detect (NewDetectCommonRegions): skip small maps; retrieval candidates
    (slam/retrieval.py); per candidate, the current keyframe's descriptors
    against the candidate window's map points by mutual brute force
    (search.search_brute_force: the row_top2 kernel on CUDA, forward and
    swapped), Sim3 RANSAC + OptimizeSim3 (optim/sim3.py), the guided
    projection gate, and the temporal consistency counter with the Sim3
    refinement from the last keyframe (DetectAndReffineSim3FromLastKF);
  correct (CorrectLoop): Sim3-propagate the current window and its points,
    fuse the loop landmarks (fused.fuse_targets_banked), optimize the
    essential graph (optim/pose_graph.py), global BA
    (LocalMapper.run_global_ba);
  merge: a hit in another map of the atlas welds the active map into it
    (SLAMSystem.execute_merge / weld_after_merge, slam/merging.py).

Kept from the reference's correctness fixes: the refractory window after a
correction, pending endpoints pinned by keyframe uid, and the refusal of
self-loops and covisible loops. The reference's NumPy generator for the
RANSAC keys becomes a seeded torch.Generator drawing the Sim3 picks.

Locking (the reference never pauses tracking for a correction): detection
runs off the map lock on copies of what it reads, and every decision is
checked again under the lock before anything is written. A correction pauses
the mapping worker, holds the lock for the window propagation and the fuse's
host work (the fuse kernel runs without it), solves the essential graph off
the lock on a snapshot whose write-back is discarded when the map moved, and
hands global BA to the detached GBA worker. On an IMU-initialized map a hit
passes the gravity gate first, the essential graph is the 4-DoF one and the
global solve is FullInertialBA (LocalMapper.full_inertial_ba).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import device as D
from .. import lie
from ..optim import pnp
from ..optim import pose_graph as pg
from ..optim import sim3 as sim3_mod
from ..utils.timing import timings
from . import fused, retrieval, search
from .map import MapStore
from .pipeline import NULL_LOCK


@dataclasses.dataclass
class LoopCloserConfig:
    """The reference's LoopCloserConfig, field for field."""

    min_kfs_in_map: int = 12
    n_candidates: int = 3
    n_covis_window: int = 10
    min_pair_matches: int = 150
    min_sim3_inliers: int = 35
    min_proj_matches: int = 50
    consistency_hits: int = 3
    ransac_hyps: int = 512
    ransac_chi2: float = 9.21
    proj_radius: float = 8.0
    fix_scale: bool = False
    covis_edge_min_weight: int = 100
    pg_iters: int = 15
    run_gba: bool = True
    gba_rounds: tuple = ((10, True), (8, False))
    gba_kf_cap: int = 64
    gba_mp_cap: int = 8192
    gba_edge_cap: int = 32768
    pair_cap: int = 512
    window_mp_cap: int = 4096


class LoopCloser:
    def __init__(self, cam, store: MapStore, cfg: LoopCloserConfig = None, mapper=None,
                 rng_seed: int = 7, device=None):
        self.device = D.resolve(device)
        self.cam = cam.to(self.device)
        self.store = store
        self.cfg = cfg or LoopCloserConfig()
        self.mapper = mapper
        self.system = None  # set by SLAMSystem; enables cross-map merges
        self._gen = torch.Generator().manual_seed(rng_seed)
        self.lock = NULL_LOCK  # the map lock (the shared RLock in async mode)
        # async wiring, set by SLAMSystem: the detached GBA worker (None runs
        # global BA inline) and the mapping worker a correction pauses
        self.gba_worker = None
        self.mapping_worker = None
        # on an IMU-initialized map: hits the gravity gate refused, the last
        # essential graph's mode ("sim3" or "4dof"), FullInertialBA requests
        self.gravity_rejected = 0
        self.last_pg_mode = None
        self.inertial_gba_requests = 0
        self.consistent_hits = 0
        self.last_candidate = -1
        self._pending = None  # dict(cand, R_cw, t_cw, s_cw, last_kf, loop_mps, miss, uids)
        self.stats = {"detected": 0, "corrected": 0, "checked": 0, "merged": 0, "refined": 0}
        self.last_loop = None  # (kf, cand) of the last corrected loop
        # refractory window: no detection until 10 keyframes past the last
        # correction (mLastLoopKFid + 10)
        self._kf_seq = 0
        self._last_loop_seq = -10**9
        self.loop_refractory_kfs = 10

    def _t(self, x, dtype=torch.float32):
        """Host array -> a copy on the loop closer's device (device.upload)."""
        return D.upload(x, dtype, self.device)

    # ------------------------------------------------------------------
    def process_keyframe(self, k: int) -> bool:
        """Detect and, when confirmed, correct a loop ending at keyframe k,
        or merge the active map into a matched stored map. True when a
        correction or a merge ran. Spans: `loop.detect`, `loop.correct`."""
        with timings.span("loop.detect"):
            act = self._process_keyframe(k)
        if isinstance(act, tuple):
            with timings.span("loop.correct"):
                self._correct_loop(k, *act)
            return True
        return bool(act)

    def _process_keyframe(self, k: int):
        store = self.store
        cfg = self.cfg
        self._kf_seq += 1
        if self._kf_seq - self._last_loop_seq < self.loop_refractory_kfs:
            return False
        if store.kf_valid.sum() < cfg.min_kfs_in_map:
            return self._try_merge(k)

        # temporal refinement of the pending candidate before fresh
        # retrieval; two consecutive misses reset it
        if self._pending is not None and self.consistent_hits > 0:
            hit = self._refine_from_last_kf(k)
            if hit is not None:
                self.stats["refined"] += 1
                self.consistent_hits += 1
                if self.consistent_hits >= cfg.consistency_hits:
                    return self._confirm_and_correct(k, self._pending["cand"], hit)
                return False
            self._pending["miss"] += 1
            if self._pending["miss"] >= 2:
                self._reset_pending()

        exclude = set(int(j) for j in store.covisible_kfs(k, n=64, min_weight=1))
        exclude.add(int(k))
        cands = retrieval.detect_n_best_candidates(store, store.kf_gdesc[k], exclude,
                                                   n=cfg.n_candidates, device=self.device)
        self.stats["checked"] += 1
        for cand in cands:
            hit = self._match_candidate(k, cand)
            if hit is None:
                continue
            if cand == self.last_candidate or self._near(cand, self.last_candidate):
                self.consistent_hits += 1
            else:
                self.consistent_hits = 1
            self.last_candidate = cand
            self._remember_pending(k, cand, *hit)
            if self.consistent_hits >= cfg.consistency_hits:
                return self._confirm_and_correct(k, cand, hit)
            return False
        return self._try_merge(k)

    def _confirm_and_correct(self, k, cand, hit):
        """The correction parameters (cand, R_cm, t_cm, s_cm, loop_mps), or
        False when an IMU-initialized map's gravity gate refuses the hit
        (BAD LOOP, LoopClosing.cc:262)."""
        if self.store.imu_initialized:
            hit = self._gravity_gate(k, cand, *hit)
            if hit is None:
                self.gravity_rejected += 1
                self._reset_pending()
                return False
        self.stats["detected"] += 1
        self._reset_pending()
        return (cand,) + tuple(hit)

    def _reset_pending(self):
        self.consistent_hits = 0
        self.last_candidate = -1
        self._pending = None

    def _remember_pending(self, k, cand, R_cm, t_cm, s_cm, loop_mps):
        """The candidate's world Sim3 S_cw = S_cm T_mw for the next
        keyframe's refinement. Slot ids are reused after culling, so the
        endpoints are pinned by keyframe uid."""
        store = self.store
        Rc, tc = store.kf_R[cand], store.kf_t[cand]
        self._pending = {
            "cand": int(cand), "R_cw": R_cm @ Rc, "t_cw": s_cm * (R_cm @ tc) + t_cm,
            "s_cw": float(s_cm), "last_kf": int(k), "loop_mps": np.asarray(loop_mps),
            "miss": 0, "cand_uid": int(store.kf_uid[cand]), "last_uid": int(store.kf_uid[k]),
        }

    def _project_count(self, k, R, t, s, pos, desc, mvalid):
        """search_by_projection of window points into keyframe k under
        S = (R, t, s); returns the slot -> window index array."""
        store = self.store
        cam = self.cam
        idx, _, _ = search.search_by_projection(
            cam.kind, cam.params, (cam.width, cam.height), self._t(R * s), self._t(t),
            self._t(pos), self._t(desc), self._t(mvalid, torch.bool),
            self._t(store.kf_xy[k]), self._t(store.kf_desc[k]),
            self._t(store.kf_octave[k], torch.int32), self._t(store.kf_mask[k], torch.bool),
            radius=self.cfg.proj_radius, max_dist=0.75)
        return idx.cpu().numpy()

    def _pairs(self, k, slots, mp_a, cand, mp_b, store_b=None):
        """Padded 3D-3D pair arrays for the Sim3 stage: keyframe k's own
        points in k's camera, the window's points in the candidate's camera,
        their pixels and k's inverse octave variances."""
        store = self.store
        store_b = store_b if store_b is not None else store
        Rk, tk = store.kf_R[k], store.kf_t[k]
        Rc, tc = store_b.kf_R[cand], store_b.kf_t[cand]
        p1 = store.mp_pos[mp_a] @ Rk.T + tk
        p2 = store_b.mp_pos[mp_b] @ Rc.T + tc
        uv2 = self.cam.project(self._t(p2)).cpu().numpy()
        s2_1 = (1.2 ** (2.0 * store.kf_octave[k][slots])).astype(np.float32)
        cap = max(self.cfg.pair_cap, 1)
        n = min(len(slots), cap)
        P1 = np.zeros((cap, 3), np.float32); P1[:n] = p1[:n]
        P2 = np.zeros((cap, 3), np.float32); P2[:n] = p2[:n]
        U1 = np.zeros((cap, 2), np.float32); U1[:n] = store.kf_xy[k][slots][:n]
        U2 = np.zeros((cap, 2), np.float32); U2[:n] = uv2[:n]
        IS1 = np.ones(cap, np.float32); IS1[:n] = 1.0 / s2_1[:n]
        valid = np.zeros(cap, bool); valid[:n] = True
        return [self._t(x) for x in (P1, P2, U1, U2, IS1, IS1)] + [self._t(valid, torch.bool)]

    def _refine_from_last_kf(self, k: int):
        """Propagate the pending Sim3 to keyframe k through the relative
        pose (scale 1), re-verify by guided projection, refine it with
        OptimizeSim3 on the co-observed pairs, re-verify again. Returns
        (R_cm, t_cm, s_cm, loop_mps) or None."""
        store = self.store
        cfg = self.cfg
        pend = self._pending
        last, cand = pend["last_kf"], pend["cand"]
        if not (store.kf_valid[last] and store.kf_valid[cand] and store.kf_valid[k]):
            return None
        if (int(store.kf_uid[cand]) != pend["cand_uid"]
                or int(store.kf_uid[last]) != pend["last_uid"]):
            return None
        Rl, tl = store.kf_R[last], store.kf_t[last]
        R_kl = store.kf_R[k] @ Rl.T
        t_kl = store.kf_t[k] - R_kl @ tl
        R_cw = R_kl @ pend["R_cw"]
        t_cw = R_kl @ pend["t_cw"] + t_kl
        s_cw = pend["s_cw"]

        loop_mps = pend["loop_mps"]
        loop_mps = loop_mps[store.mp_valid[loop_mps]]
        n_gate = max(int(0.6 * cfg.min_proj_matches), 5)
        if len(loop_mps) < n_gate:
            return None
        wcap = cfg.window_mp_cap
        loop_mps = loop_mps[:wcap]
        pos = np.zeros((wcap, 3), np.float32)
        desc = np.zeros((wcap, store.desc_dim), np.float32)
        mvalid = np.zeros(wcap, bool)
        pos[: len(loop_mps)] = store.mp_pos[loop_mps]
        desc[: len(loop_mps)] = store.mp_desc[loop_mps]
        mvalid[: len(loop_mps)] = True

        idx = self._project_count(k, R_cw, t_cw, s_cw, pos, desc, mvalid)
        slots = np.nonzero(idx >= 0)[0]
        if len(slots) < n_gate:
            return None

        own = store.kf_obs[k][slots]
        sel = (own >= 0) & store.mp_valid[np.clip(own, 0, store.m_max - 1)]
        s_ref, mp_a = slots[sel], own[sel]
        mp_b = loop_mps[idx[s_ref]]
        Rc, tc = store.kf_R[cand], store.kf_t[cand]
        R_cm = R_cw @ Rc.T
        t_cm = t_cw - s_cw * (R_cm @ tc)
        s_cm = s_cw
        if len(s_ref) >= max(cfg.min_sim3_inliers // 2, 5):
            P1, P2, U1, U2, IS1, IS2, val = self._pairs(k, s_ref, mp_a, cand, mp_b)
            opt = sim3_mod.optimize_sim3(self.cam.kind, self.cam.params, self._t(R_cm),
                                         self._t(t_cm), self._t(s_cm), P1, P2, U1, U2,
                                         IS1, IS2, val, fix_scale=cfg.fix_scale)
            if int(opt["n_inliers"]) >= max(cfg.min_sim3_inliers // 2, 5):
                R_cm = opt["R12"].cpu().numpy()
                t_cm = opt["t12"].cpu().numpy()
                s_cm = float(opt["s12"])
                R_cw = R_cm @ Rc
                t_cw = s_cm * (R_cm @ tc) + t_cm
                s_cw = s_cm

        idx2 = self._project_count(k, R_cw, t_cw, s_cw, pos, desc, mvalid)
        if int((idx2 >= 0).sum()) < cfg.min_proj_matches:
            return None
        pend.update(R_cw=R_cw, t_cw=t_cw, s_cw=float(s_cw), last_kf=int(k), miss=0)
        return R_cm, t_cm, s_cm, pend["loop_mps"]

    def _gravity_gate(self, k, cand, R_cm, t_cm, s_cm, loop_mps):
        """An inertial loop must not bend the horizon: the world-frame
        correction S_ww = T_kw^-1 S_cw must be near pure yaw (|roll|,
        |pitch| < 0.016 rad, their sum < 0.024, |yaw| < 0.349;
        LoopClosing.cc:242-264). After VIBA2 roll and pitch are zeroed and
        the scale forced to 1. Returns the (possibly corrected) hit, or None."""
        store = self.store
        Rk, tk = store.kf_R[k], store.kf_t[k]
        Rc, tc = store.kf_R[cand], store.kf_t[cand]
        R_cw = R_cm @ Rc
        t_cw = s_cm * (R_cm @ tc) + t_cm
        R_ww = Rk.T @ R_cw
        t_ww = Rk.T @ (t_cw - tk)
        phi = lie.so3_log(torch.as_tensor(np.asarray(R_ww, np.float32))).numpy()
        if not (abs(phi[0]) < 0.016 and abs(phi[1]) < 0.016
                and abs(phi[0]) + abs(phi[1]) < 0.024 and abs(phi[2]) < 0.349):
            return None
        if store.viba2:
            phi = np.array([0.0, 0.0, phi[2]], np.float32)
            R_ww = lie.so3_exp(torch.as_tensor(phi)).numpy()
            R_cw = Rk @ R_ww
            t_cw = Rk @ t_ww + tk
            R_cm = R_cw @ Rc.T
            t_cm = t_cw - R_cm @ tc
            s_cm = 1.0
        return R_cm, t_cm, s_cm, loop_mps

    # ------------------------------------------------------------------
    # cross-map merge detection
    # ------------------------------------------------------------------
    def _try_merge(self, k: int) -> bool:
        sys_ = self.system
        if sys_ is None or sys_.atlas.n_maps() < 2:
            return False
        store = self.store
        if int((store.kf_obs[k] >= 0).sum()) < self.cfg.min_pair_matches:
            return False
        for idx, m in enumerate(sys_.atlas.maps):
            if m is store or m.kf_valid.sum() < 3:
                continue
            cands = retrieval.detect_n_best_candidates(m, store.kf_gdesc[k], exclude=set(),
                                                       n=self.cfg.n_candidates,
                                                       device=self.device)
            for cand in cands:
                hit = self._match_candidate(k, cand, store_b=m)
                if hit is None:
                    continue
                # the weld mutates both maps and the tracker: under the map
                # lock, with mapping paused (MergeLocal's RequestStop); the
                # welding passes run off the surgery lock
                mw = self.mapping_worker
                if mw is not None:
                    mw.request_pause()
                try:
                    with self.lock:
                        k_new = sys_.execute_merge(idx, k, cand, *hit)
                    if k_new is not False:
                        sys_.weld_after_merge(int(k_new), hit[-1])
                finally:
                    if mw is not None:
                        mw.resume()
                if k_new is not False:
                    self.stats["merged"] += 1
                    return True
        return False

    def _near(self, a, b):
        if a < 0 or b < 0:
            return False
        return self.store.covis[a, b] > 0

    # ------------------------------------------------------------------
    # detection
    # ------------------------------------------------------------------
    def _match_candidate(self, k: int, cand: int, store_b: MapStore = None):
        """3D-3D association and Sim3 between keyframe k (active map) and
        the candidate's window (in store_b: another map for merges, the
        active map for loops). Returns (R_cm, t_cm, s_cm, window point ids)
        or None; S_cm maps candidate-camera into current-camera coordinates."""
        store = self.store
        cfg = self.cfg
        store_b = store_b if store_b is not None else store

        window = [cand] + [int(j) for j in store_b.covisible_kfs(cand, n=cfg.n_covis_window,
                                                                  min_weight=1)]
        win_mps = store_b.points_seen_by(window)
        if len(win_mps) == 0:
            return None
        slots = np.nonzero((store.kf_obs[k] >= 0) & store.kf_mask[k])[0]
        if len(slots) < cfg.min_pair_matches:
            return None

        # k's keypoints against the window's points: mutual brute force, on
        # CUDA the row_top2 kernel at (n_slots, window_mp_cap, D) and swapped
        wcap = cfg.window_mp_cap
        win_mps = win_mps[:wcap]
        mp_desc = np.zeros((wcap, store.desc_dim), np.float32)
        mp_desc[: len(win_mps)] = store_b.mp_desc[win_mps]
        mp_valid = np.zeros(wcap, bool)
        mp_valid[: len(win_mps)] = True
        kf_sel = np.zeros(store.n_slots, bool)
        kf_sel[slots] = True
        idx, _ = search.search_brute_force(
            self._t(store.kf_desc[k]), self._t(kf_sel, torch.bool), self._t(mp_desc),
            self._t(mp_valid, torch.bool), max_dist=0.75, ratio=1.0)
        idx = idx.cpu().numpy()
        mslots = np.nonzero(idx >= 0)[0]
        if len(mslots) < cfg.min_pair_matches:
            return None

        mp_a = store.kf_obs[k][mslots]
        mp_b = win_mps[idx[mslots]]
        P1, P2, U1, U2, IS1, IS2, valid = self._pairs(k, mslots, mp_a, cand, mp_b, store_b)
        picks = pnp.draw_picks(valid, cfg.ransac_hyps, 3, self._gen)
        res = sim3_mod.sim3_ransac(self.cam.kind, self.cam.params, P1, P2, U1, U2, IS1, IS2,
                                   valid, picks, chi2_th=cfg.ransac_chi2,
                                   fix_scale=cfg.fix_scale)
        if int(res["n_inliers"]) < cfg.min_sim3_inliers:
            return None
        opt = sim3_mod.optimize_sim3(self.cam.kind, self.cam.params, res["R12"], res["t12"],
                                     res["s12"], P1, P2, U1, U2, IS1, IS2, res["inliers"],
                                     fix_scale=cfg.fix_scale)
        if int(opt["n_inliers"]) < cfg.min_sim3_inliers:
            return None
        R_cm = opt["R12"].cpu().numpy()
        t_cm = opt["t12"].cpu().numpy()
        s_cm = float(opt["s12"])

        # guided projection under S_cw = S_cm T_mw
        Rc, tc = store_b.kf_R[cand], store_b.kf_t[cand]
        pos = np.zeros((wcap, 3), np.float32)
        pos[: len(win_mps)] = store_b.mp_pos[win_mps]
        idx2 = self._project_count(k, R_cm @ Rc, s_cm * (R_cm @ tc) + t_cm, s_cm, pos, mp_desc,
                                   mp_valid)
        if int((idx2 >= 0).sum()) < cfg.min_proj_matches:
            return None
        return R_cm, t_cm, s_cm, win_mps

    # ------------------------------------------------------------------
    # correction
    # ------------------------------------------------------------------
    def _correct_loop(self, k: int, cand: int, R_cm, t_cm, s_cm, loop_mps):
        """CorrectLoop: Sim3-propagate the current window, fuse duplicates,
        optimize the essential graph, global BA. Mapping is paused for the
        correction (its row-level writes bump no big_change_idx, so the
        staleness guard alone cannot see them); tracking never is."""
        store = self.store
        cfg = self.cfg
        mw = self.mapping_worker
        if mw is not None:
            mw.request_pause()
        try:
            with self.lock:
                # detection ran while mapping worked: an endpoint may be gone
                if not (store.kf_valid[k] and store.kf_valid[cand]):
                    return
                # a self- or covisible "loop" has no drift to absorb;
                # correcting along it would warp the map by the Sim3 scale
                if int(cand) == int(k) or store.covis[k, cand] > 0:
                    return
                kf_ids = store.valid_kf_ids()
                pre_R = store.kf_R.copy()
                pre_t = store.kf_t.copy()
                _, window = self.propagate_window_correction(k, cand, R_cm, t_cm, s_cm)
                store.loop_edges.append((int(cand), int(k)))
                # a whole-map move: concurrent solves discard, the mirror
                # re-uploads, the tracker restarts its motion model
                store.bump_change()
                self._fuse_loop_points(window, loop_mps)
                big0 = store.big_change_idx
                built = self._build_essential_graph(kf_ids, pre_R, pre_t, k, cand,
                                                    (R_cm, t_cm, s_cm))
            if built is not None:
                prob, meta = built
                # the solve runs off the lock on the snapshot (tracking goes
                # on; mapping is paused, so only born keyframes can appear)
                # an IMU-initialized map keeps gravity: the 4-DoF graph
                mode = "4dof" if store.imu_initialized else "sim3"
                self.last_pg_mode = mode
                out, _ = pg.optimize_pose_graph(prob, n_iters=cfg.pg_iters,
                                                fix_scale=cfg.fix_scale, mode=mode)
                out = (out.R.cpu().numpy(), out.t.cpu().numpy(), out.s.cpu().numpy())
                with self.lock:
                    if store.big_change_idx == big0:
                        self._apply_pose_graph(meta, out)
                        store.bump_change()
                    else:
                        from ..utils.log import warn

                        warn("loop: essential-graph solve discarded (the map moved during "
                             "the detached solve)")
        finally:
            if mw is not None:
                mw.resume()

        # global BA: detached on the GBA worker in async mode (a newer loop
        # aborts a solve in flight), inline otherwise; an inertial map gets
        # FullInertialBA (LoopClosing.cc:2408)
        if cfg.run_gba and self.mapper is not None and store.imu_initialized \
                and self.mapper.vim is not None:
            rounds = ((3, True), (4, False))
            if self.gba_worker is not None:
                self.gba_worker.request("inertial", rounds=rounds)
            else:
                self.mapper.full_inertial_ba(self.mapper.vim, rounds=rounds)
            self.inertial_gba_requests += 1
        elif cfg.run_gba and self.mapper is not None:
            kwargs = dict(fixed_ids=[int(cand)], rounds=cfg.gba_rounds, kf_cap=cfg.gba_kf_cap,
                          mp_cap=cfg.gba_mp_cap, edge_cap=cfg.gba_edge_cap)
            if self.gba_worker is not None:
                self.gba_worker.request("visual", **kwargs)
            else:
                self.mapper.run_global_ba(**kwargs)
        self.stats["corrected"] += 1
        self.last_loop = (int(k), int(cand))
        self._last_loop_seq = self._kf_seq

    def propagate_window_correction(self, k, cand, R_cm, t_cm, s_cm):
        """Sim3-propagate the correction through the current keyframe's
        covisible window and its map points (CorrectLoop :1185-1251).
        Returns (S_cw, window)."""
        store = self.store
        pre_R = store.kf_R.copy()
        pre_t = store.kf_t.copy()
        Rc, tc = store.kf_R[cand], store.kf_t[cand]
        S_cw = (R_cm @ Rc, s_cm * (R_cm @ tc) + t_cm, s_cm)

        # k + 31 covisibles: the fuse batch keeps one padded shape (32)
        window = [int(k)] + [int(j) for j in store.covisible_kfs(k, n=31, min_weight=1)]
        window = [w for w in window if store.kf_valid[w]]
        corr_R, corr_t, corr_s = {}, {}, {}
        Rk, tk = store.kf_R[k], store.kf_t[k]
        for i in window:
            if i == k:
                corr_R[i], corr_t[i], corr_s[i] = S_cw
                continue
            # S_iw_corr = S_ik S_cw with S_ik of scale 1: the translation is
            # R_ik t_cw + t_ik, the loop scale is already inside t_cw
            R_ik = store.kf_R[i] @ Rk.T
            t_ik = store.kf_t[i] - R_ik @ tk
            corr_R[i], corr_t[i], corr_s[i] = R_ik @ S_cw[0], R_ik @ S_cw[1] + t_ik, S_cw[2]

        # window points: p' = S_corr^-1(T_old(p)) through the first window
        # keyframe (in window order) observing each point
        win_mps = store.points_seen_by(window)
        if len(win_mps):
            prio = np.full(store.k_max, len(window), np.int64)
            for n, i in enumerate(window):
                prio[i] = min(prio[i], n)
            kf_e, _, mp_e = store.observing_slots(win_mps)
            in_win = prio[kf_e] < len(window)
            kf_e, mp_e = kf_e[in_win], mp_e[in_win]
            loc = np.zeros(store.m_max, np.int64)
            loc[win_mps] = np.arange(len(win_mps))
            best = np.full(len(win_mps), len(window), np.int64)
            np.minimum.at(best, loc[mp_e], prio[kf_e])
            ok = best < len(window)
            ids = win_mps[ok]
            gi = np.asarray(window)[best[ok]]
            Rn = np.stack([corr_R[i] for i in window])[best[ok]]
            tn = np.stack([corr_t[i] for i in window])[best[ok]]
            sn = np.asarray([corr_s[i] for i in window])[best[ok]]
            p_cam = np.einsum("mij,mj->mi", pre_R[gi], store.mp_pos[ids]) + pre_t[gi]
            store.mp_pos[ids] = np.einsum("mi,mij->mj", p_cam - tn, Rn) / sn[:, None]

        # corrected window poses as SE3, scale folded in: [R, t/s]
        for i in window:
            store.kf_R[i] = corr_R[i]
            store.kf_t[i] = corr_t[i] / corr_s[i]
        return S_cw, window

    def _fuse_loop_points(self, window, loop_mps):
        """Project the loop points into every corrected window keyframe in
        one batched call (fused.fuse_targets_banked) and replace the window
        keyframes' conflicting observations by the (older) loop points.
        Called under the map lock; the kernel runs with it released, on the
        snapshots and copies taken under it."""
        store = self.store
        loop_mps = loop_mps[store.mp_valid[loop_mps]]
        if len(loop_mps) == 0:
            return
        cap = self.cfg.window_mp_cap
        loop_mps = loop_mps[:cap]
        window = [int(i) for i in window if store.kf_valid[i]]
        if not window:
            return
        P = 32  # one padded batch shape: the window is k + 31 covisibles
        R_t = np.tile(np.eye(3, dtype=np.float32), (P, 1, 1))
        t_t = np.zeros((P, 3), np.float32)
        tgt_ids = np.full(P, -1, np.int64)
        cand = np.full((P, cap), -1, np.int64)
        for pi, i in enumerate(window):
            tgt_ids[pi] = i
            R_t[pi], t_t[pi] = store.kf_R[i], store.kf_t[i]
            cand[pi, : len(loop_mps)] = loop_mps

        dm = fused.get_device_map(store, self.device)
        dm.sync()
        pos_s, desc_s, _, _, _, valid_s = dm.snapshot()
        bank = fused.get_kf_bank(store, self.cam, self.device)
        bank.sync()
        b_xy, b_desc, b_oct, b_mask, _, _ = bank.snapshot()
        args = (self._t(tgt_ids, torch.int64), self._t(cand, torch.int64), self._t(R_t),
                self._t(t_t))
        self.lock.release()
        try:
            idx = fused.fuse_targets_banked(
                self.cam.kind, self.cam.params, float(self.cam.width), float(self.cam.height),
                *args, b_xy, b_desc, b_oct, b_mask, pos_s, desc_s, valid_s,
                radius=float(self.cfg.proj_radius), max_dist=0.75).cpu().numpy()
        finally:
            self.lock.acquire()

        for pi, i in enumerate(window):
            # a merge fuses with mapping running: a window keyframe may have
            # been culled while the kernel ran
            if not store.kf_valid[i]:
                continue
            slots = np.nonzero(idx[pi] >= 0)[0]
            if len(slots) == 0:
                continue
            new_ids = loop_mps[idx[pi][slots]]
            old_ids = store.kf_obs[i][slots]
            # duplicates die in favour of the loop point, empty slots gain
            # an observation; drop same-point matches, points removed
            # meanwhile, and a second claim of one loop point in this keyframe
            keep = (old_ids != new_ids) & store.mp_valid[new_ids]
            _, first = np.unique(new_ids, return_index=True)
            uniq = np.zeros(len(new_ids), bool)
            uniq[first] = True
            keep &= uniq
            if not keep.any():
                continue
            s_k, old_k, new_k = slots[keep], old_ids[keep], new_ids[keep]
            store.assign_observations(i, s_k, new_k)
            dead = old_k[(old_k >= 0) & (store.mp_obs_count[np.clip(old_k, 0, store.m_max - 1)] == 0)]
            if len(dead):
                store.remove_points(np.unique(dead))
            store.update_covisibility(int(i))

    def _build_essential_graph(self, kf_ids, pre_R, pre_t, k, cand, S_cm):
        """The padded Sim3 pose-graph problem: spanning-tree, earlier loop
        and strong-covisibility edges measured on the pre-correction poses,
        plus the new loop edge carrying the measured Sim3. K and E are padded
        to powers of two (padding vertices fixed identities, padding edges
        invalid). Returns (prob, meta) or None."""
        store = self.store
        kf_ids = np.asarray(kf_ids, int)
        K = len(kf_ids)
        loc = {int(g): n for n, g in enumerate(kf_ids)}
        pairs, weights, seen = [], [], set()

        def add_edge(a, b, w):
            a, b = int(a), int(b)
            if a == b or (a, b) in seen or (b, a) in seen or a not in loc or b not in loc:
                return
            seen.add((a, b))
            pairs.append((loc[a], loc[b]))
            weights.append(w)

        for g in kf_ids:
            p = int(store.kf_parent[g])
            if p >= 0 and store.kf_valid[p]:
                add_edge(p, g, 1.0)
        for a, b in store.loop_edges:
            if store.kf_valid[a] and store.kf_valid[b]:
                add_edge(a, b, 1.0)
        sub = store.covis[np.ix_(kf_ids, kf_ids)]
        for a_l, b_l in np.argwhere(sub >= self.cfg.covis_edge_min_weight):
            if a_l < b_l:
                add_edge(kf_ids[a_l], kf_ids[b_l], 1.0)
        if not pairs:
            return None

        pairs.append((loc[int(cand)], loc[int(k)]))  # the loop edge, slot E-1
        weights.append(1.0)
        E = len(pairs)
        Kp = 1 << max(3, int(K - 1).bit_length())
        Ep = 1 << max(4, int(E - 1).bit_length())
        e_ij = np.zeros((Ep, 2), np.int64)
        e_ij[:E] = pairs
        e_w = np.zeros(Ep, np.float32)
        e_w[:E] = weights
        e_R, e_t, e_s, _ = pg.make_edges_from_poses(
            pre_R[kf_ids], pre_t[kf_ids], np.ones(K, np.float32), e_ij, e_w)
        # the loop edge (i = cand, j = k) measures S_km = S_cm
        e_R[E - 1] = S_cm[0]
        e_t[E - 1] = S_cm[1]
        e_s[E - 1] = float(S_cm[2])

        # vertices: the corrected window, pre-correction poses elsewhere,
        # every scale 1 so the graph redistributes the remaining drift
        V_R = np.tile(np.eye(3, dtype=np.float32), (Kp, 1, 1))
        V_t = np.zeros((Kp, 3), np.float32)
        V_R[:K] = store.kf_R[kf_ids]
        V_t[:K] = store.kf_t[kf_ids]
        fixed = np.ones(Kp, bool)
        fixed[:K] = False
        fixed[loc[int(cand)]] = True
        prob = pg.PoseGraphProblem(
            R=self._t(V_R), t=self._t(V_t), s=self._t(np.ones(Kp, np.float32)),
            fixed=self._t(fixed, torch.bool), e_i=self._t(e_ij[:, 0], torch.int64),
            e_j=self._t(e_ij[:, 1], torch.int64), e_R=self._t(e_R), e_t=self._t(e_t),
            e_s=self._t(e_s), e_w=self._t(e_w), e_valid=self._t(np.arange(Ep) < E, torch.bool))
        return prob, {"kf_ids": kf_ids, "V_R": V_R[:K].copy(), "V_t": V_t[:K].copy()}

    def _apply_pose_graph(self, meta, out):
        """Write the pose-graph solution back (under the map lock, after the
        staleness check): every map point through its reference keyframe,
        p' = S_new^-1(S_old(p)), the keyframe poses as [R, t/s], and the
        keyframes born during the detached solve after their anchors."""
        store = self.store
        kf_ids = meta["kf_ids"]
        K = len(kf_ids)
        V_R, V_t = meta["V_R"], meta["V_t"]
        R_new, t_new, s_new = out[0][:K], out[1][:K], out[2][:K]
        # every keyframe's pose before this write-back, for the born ones
        pre_all_R = store.kf_R.copy()
        pre_all_t = store.kf_t.copy()

        mp_ids = np.nonzero(store.mp_valid)[0]
        if len(mp_ids):
            ref = store.mp_first_kf[mp_ids].copy()
            bad = (ref < 0) | (~store.kf_valid[np.clip(ref, 0, store.k_max - 1)])
            if bad.any():  # fall back to any current observer
                kf_e, _, mp_e = store.observing_slots(mp_ids[bad])
                first = {}
                for kf_, mp_ in zip(kf_e, mp_e):
                    first.setdefault(int(mp_), int(kf_))
                ref[bad] = [first.get(int(m), -1) for m in mp_ids[bad]]
            loc = np.full(store.k_max, -1, np.int64)
            loc[kf_ids] = np.arange(K)
            gi = loc[np.clip(ref, 0, store.k_max - 1)]
            gi[ref < 0] = -1
            ok = gi >= 0
            ids, g = mp_ids[ok], gi[ok]
            p_cam = np.einsum("mij,mj->mi", V_R[g], store.mp_pos[ids]) + V_t[g]
            store.mp_pos[ids] = np.einsum("mi,mij->mj", p_cam - t_new[g], R_new[g]) \
                / s_new[g, None]

        alive = store.kf_valid[kf_ids]
        store.kf_R[kf_ids[alive]] = R_new[alive]
        store.kf_t[kf_ids[alive]] = (t_new / s_new[:, None])[alive]

        if self.mapper is not None:
            born = np.nonzero(store.kf_valid)[0]
            born = born[~np.isin(born, kf_ids)]
            if len(born):
                self.mapper.propagate_ba_correction(kf_ids[alive], mp_ids, pre_all_R,
                                                    pre_all_t, scope=born)
