"""Visual-inertial manager: IMU plumbing, staged initialization, alignment.

Counterpart of hfnet_slam_tpu/slam/vi.py: the IMU side of Tracking
(PreintegrateIMU / PredictStateIMU) and LocalMapping's staged
initialization (InitializeIMU -> InertialOptimization -> ApplyScaledRotation
-> FullInertialBA, staged at init / VIBA1 / VIBA2, then periodic scale
refinement). Each stage runs optim/inertial.inertial_init with the poses
fixed, aligns the map to gravity at metric scale and polishes it with the
mapper's full_inertial_ba.

Preintegrations live on the manager's device (the tracker's); the raw (N,7)
blocks behind each chain link stay on the host so a large bias update can
re-run the scan exactly. MapStore poses stay world->camera; this module
converts to and from body states at the boundary.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import device as D
from ..geometry import imu as IMU
from ..optim import inertial as VI
from .map import MapStore


@dataclasses.dataclass
class VIConfig:
    """The reference's VIConfig, field for field."""

    t_init: float = 2.0
    t_viba1: float = 5.0
    t_viba2: float = 15.0
    prior_g_init: float = 1e2
    prior_a_init: float = 1e10
    prior_g_viba1: float = 1.0
    prior_a_viba1: float = 1e5
    min_kfs_for_init: int = 8
    min_scale: float = 1e-1
    chain_cap: int = 64
    meas_cap: int = 256
    scale_refine_interval: float = 10.0
    scale_refine_tol: float = 0.002
    reint_bg_tol: float = 1e-3
    reint_ba_tol: float = 1e-2
    min_motion_init: float = 0.03
    min_motion_run: float = 0.02
    motion_window_t: float = 10.0


class VIManager:
    """Owns the IMU calib, the per-keyframe chain preintegrations and the
    staged initialization state of the active map."""

    def __init__(self, calib: IMU.ImuCalib, store: MapStore, cfg: VIConfig = None, device=None):
        self.device = D.resolve(device)
        self.calib = calib
        self.store = store
        self.cfg = cfg or VIConfig()
        self._Tbc_R = np.asarray(calib.Tbc_R, np.float32)
        self._Tbc_t = np.asarray(calib.Tbc_t, np.float32)
        self.Tbc_R = torch.tensor(self._Tbc_R, device=self.device)
        self.Tbc_t = torch.tensor(self._Tbc_t, device=self.device)
        self.kf_pre: dict[int, IMU.Preintegrated] = {}
        self.kf_meas: dict[int, np.ndarray] = {}
        self.first_kf_ts: float = None
        self.stage = 0  # 0 visual only, 1 initialized, 2 VIBA1, 3 VIBA2
        self.mapper = None  # LocalMapper (set by SLAMSystem): runs FullInertialBA
        self._last_refine_ts: float = None
        self.bad_imu = False
        self._dist_filtered: float = None
        self._t_moving = 0.0
        # wall seconds of each init stage's inertial solve, by stage (read by
        # the chip smoke test)
        self.stage_seconds: dict = {}

    def reset(self, store: MapStore):
        """Forget the chain and the init state: a fresh map."""
        self.store = store
        self.kf_pre.clear()
        self.kf_meas.clear()
        self.first_kf_ts = None
        self.stage = 0
        self.bad_imu = False
        self._dist_filtered = None
        self._t_moving = 0.0
        self._last_refine_ts = None

    def _t(self, x):
        return D.upload(x, torch.float32, self.device)

    # ------------------------------------------------------------------
    def integrate(self, meas: np.ndarray, bg=None, ba=None) -> IMU.Preintegrated:
        """Preintegrate an (N,7) [ax ay az wx wy wz dt] block on the device
        (every row valid)."""
        m = self._t(np.asarray(meas, np.float32).reshape(-1, 7))
        mask = torch.ones(m.shape[0], dtype=torch.bool, device=self.device)
        z3 = np.zeros(3, np.float32)
        return IMU.integrate(m, mask, self.calib, self._t(z3 if bg is None else bg),
                             self._t(z3 if ba is None else ba))

    def cam_to_body(self, R_cw, t_cw):
        """World->camera -> body state (R_wb, p_wb): T_wb = T_wc o T_bc^-1."""
        R_wc = np.asarray(R_cw).T
        c_w = -R_wc @ np.asarray(t_cw)
        R_wb = R_wc @ self._Tbc_R.T
        p_wb = c_w - R_wb @ self._Tbc_t
        return R_wb, p_wb

    def body_to_cam(self, R_wb, p_wb):
        R_cb = self._Tbc_R.T
        R_cw = R_cb @ np.asarray(R_wb).T
        t_cw = -R_cw @ np.asarray(p_wb) - R_cb @ self._Tbc_t
        return R_cw.astype(np.float32), t_cw.astype(np.float32)

    # ------------------------------------------------------------------
    def on_keyframe(self, k: int, prev_kf: int, pre: IMU.Preintegrated, meas=None):
        """Record the chain preintegration prev_kf -> k and, on an
        initialized map, hand the predecessor's state on."""
        store = self.store
        store.kf_prev[k] = prev_kf
        self.kf_pre[k] = pre
        if meas is not None:
            self.kf_meas[k] = np.asarray(meas, np.float32)
        if self.first_kf_ts is None:
            self.first_kf_ts = float(store.kf_timestamp[k])
        if prev_kf >= 0 and store.imu_initialized:
            if not np.any(store.kf_vel[k]):
                store.kf_vel[k] = store.kf_vel[prev_kf]
            store.kf_bg[k] = store.kf_bg[prev_kf]
            store.kf_ba[k] = store.kf_ba[prev_kf]

    def chain(self):
        """Ordered (prev, kf, pre) triples along the IMU chain."""
        store = self.store
        ids = store.valid_kf_ids()
        ids = [int(i) for i in ids[np.argsort(store.kf_timestamp[ids])]]
        out = []
        for k in ids:
            p = int(store.kf_prev[k])
            if p >= 0 and store.kf_valid[p] and k in self.kf_pre:
                out.append((p, k, self.kf_pre[k]))
        return out

    # ------------------------------------------------------------------
    def check_motion_gates(self):
        """IMU init failure gates (LocalMapping.cc:150-210): too little
        motion before init (single link < min_motion_init once enough
        keyframes exist), or a low-pass-filtered two-link distance below
        min_motion_run inside the first motion window after it, sets
        bad_imu; the tracker then resets the active map."""
        store = self.store
        cfg = self.cfg
        links = self.chain()
        if not links:
            return

        def link_dist(a, b):
            ca = -store.kf_R[a].T @ store.kf_t[a]
            cb = -store.kf_R[b].T @ store.kf_t[b]
            return float(np.linalg.norm(cb - ca))

        p, k, _ = links[-1]
        d1 = link_dist(p, k)
        d = d1
        if len(links) >= 2:
            p2, k2, _ = links[-2]
            d += link_dist(p2, k2)
        if self.stage == 0:
            if len(links) + 1 >= cfg.min_kfs_for_init and d1 < cfg.min_motion_init:
                self.bad_imu = True
        elif not store.viba2:
            self._dist_filtered = (d if self._dist_filtered is None
                                   else 0.5 * d + 0.5 * self._dist_filtered)
            if d > 0.05:
                self._t_moving += float(store.kf_timestamp[k] - store.kf_timestamp[p])
            if self._t_moving < cfg.motion_window_t and self._dist_filtered < cfg.min_motion_run:
                self.bad_imu = True
                self._dist_filtered = None

    def maybe_initialize(self, now_ts: float) -> bool:
        """Run the stage that is due; True when one ran."""
        cfg = self.cfg
        if self.first_kf_ts is None:
            return False
        self.check_motion_gates()
        if self.bad_imu:
            return False
        elapsed = now_ts - self.first_kf_ts
        if self.stage == 0 and elapsed >= cfg.t_init:
            return self._run_stage(cfg.prior_g_init, cfg.prior_a_init, fix_scale=False, stage=1)
        if self.stage == 1 and elapsed >= cfg.t_viba1:
            return self._run_stage(cfg.prior_g_viba1, cfg.prior_a_viba1, fix_scale=False,
                                   stage=2)
        if self.stage == 2 and elapsed >= cfg.t_viba2:
            ran = self._run_stage(0.0, 0.0, fix_scale=False, stage=3)
            if ran:
                self._last_refine_ts = now_ts
            return ran
        if self.stage == 3:
            if self._last_refine_ts is None:
                self._last_refine_ts = now_ts
            elif now_ts - self._last_refine_ts >= cfg.scale_refine_interval:
                self._last_refine_ts = now_ts
                return self._scale_refinement()
        return False

    def _chain_problem(self):
        """(kf_ids, R_wb, p_wb, stacked pres) of the last chain_cap links, or
        None when the chain is too short or broken by culling."""
        links = self.chain()
        if len(links) + 1 < self.cfg.min_kfs_for_init:
            return None
        links = links[-self.cfg.chain_cap:]
        kf_ids = [links[0][0]] + [k for _, k, _ in links]
        for n in range(1, len(links)):
            if links[n][0] != links[n - 1][1]:
                return None
        R_wb = np.zeros((len(kf_ids), 3, 3), np.float32)
        p_wb = np.zeros((len(kf_ids), 3), np.float32)
        for n, k in enumerate(kf_ids):
            R_wb[n], p_wb[n] = self.cam_to_body(self.store.kf_R[k], self.store.kf_t[k])
        return kf_ids, self._t(R_wb), self._t(p_wb), IMU.stack([p for _, _, p in links])

    def _scale_refinement(self) -> bool:
        """Periodic scale / gravity-direction refinement (ScaleRefinement):
        inertial-only solve with the biases pinned; the map is re-aligned
        only when the scale drifted beyond scale_refine_tol."""
        prob = self._chain_problem()
        if prob is None:
            return False
        kf_ids, R_wb, p_wb, pres = prob
        res = VI.inertial_init(R_wb, p_wb, pres, prior_g=1e10, prior_a=1e10, fix_scale=False)
        s = float(res["scale"])
        if not np.isfinite(s) or s < self.cfg.min_scale:
            return False
        if abs(s - 1.0) <= self.cfg.scale_refine_tol:
            return False
        Rwg = res["Rwg"].cpu().numpy()
        self.apply_scaled_rotation(Rwg.T, s)
        v = res["v"].cpu().numpy() @ Rwg
        for n, k in enumerate(kf_ids):
            self.store.kf_vel[k] = v[n]
        return True

    def _run_stage(self, prior_g, prior_a, fix_scale, stage) -> bool:
        import time

        store = self.store
        prob = self._chain_problem()
        if prob is None:
            return False
        kf_ids, R_wb, p_wb, pres = prob
        t0 = time.perf_counter()
        res = VI.inertial_init(R_wb, p_wb, pres, prior_g=max(prior_g, 1e-3),
                               prior_a=max(prior_a, 1e-3), fix_scale=fix_scale)
        res = {k: v.cpu().numpy() for k, v in res.items()}
        self.stage_seconds[stage] = time.perf_counter() - t0
        s = float(res["scale"])
        if not np.isfinite(s) or s < self.cfg.min_scale:
            return False
        Rwg = res["Rwg"]
        self.apply_scaled_rotation(Rwg.T, s)
        v = res["v"] @ Rwg
        for n, k in enumerate(kf_ids):
            store.kf_vel[k] = v[n]
            store.kf_bg[k] = res["bg"]
            store.kf_ba[k] = res["ba"]
        self.reintegrate_chain()
        store.imu_initialized = True
        store.viba1 = stage >= 2
        store.viba2 = stage >= 3
        self.stage = stage
        if self.mapper is not None:
            self.mapper.full_inertial_ba(self, prior_g=prior_g, prior_a=prior_a)
        return True

    def reintegrate_chain(self) -> int:
        """Re-run the scan for every chain preintegration whose linearization
        bias drifted beyond tolerance from its predecessor's current bias
        (Preintegrated::Reintegrate). Returns how many were recomputed."""
        store = self.store
        cfg = self.cfg
        n = 0
        for k, pre in list(self.kf_pre.items()):
            meas = self.kf_meas.get(k)
            p = int(store.kf_prev[k])
            if meas is None or p < 0 or not store.kf_valid[p]:
                continue
            bg, ba = store.kf_bg[p], store.kf_ba[p]
            dbg = np.linalg.norm(pre.bg0.cpu().numpy() - bg)
            dba = np.linalg.norm(pre.ba0.cpu().numpy() - ba)
            if dbg <= cfg.reint_bg_tol and dba <= cfg.reint_ba_tol:
                continue
            self.kf_pre[k] = self.integrate(meas, bg, ba)
            n += 1
        return n

    def apply_scaled_rotation(self, Rgw: np.ndarray, s: float):
        """Rotate the world so gravity is -z and rescale to metric units
        (Map::ApplyScaledRotation): R_cw' = R_cw Rgw^T, t_cw' = s t_cw,
        points p' = s Rgw p, velocities v' = s Rgw v."""
        store = self.store
        ids = store.valid_kf_ids()
        for k in ids:
            store.kf_R[k] = store.kf_R[k] @ Rgw.T
            store.kf_t[k] = s * store.kf_t[k]
        sel = store.mp_valid
        store.mp_pos[sel] = s * (store.mp_pos[sel] @ Rgw.T)
        store.kf_vel[ids] = s * (store.kf_vel[ids] @ Rgw.T)
        store.bump_change()

    # ------------------------------------------------------------------
    def predict(self, k_or_state, pre: IMU.Preintegrated):
        """PredictStateIMU from a keyframe id or an explicit body state."""
        store = self.store
        if isinstance(k_or_state, (int, np.integer)):
            k = int(k_or_state)
            R_wb, p_wb = self.cam_to_body(store.kf_R[k], store.kf_t[k])
            v, bg, ba = store.kf_vel[k], store.kf_bg[k], store.kf_ba[k]
        else:
            R_wb, p_wb, v, bg, ba = k_or_state
        out = IMU.predict_state(*(self._t(x) for x in (R_wb, p_wb, v, bg, ba)), pre)
        return tuple(x.cpu().numpy() for x in out)
