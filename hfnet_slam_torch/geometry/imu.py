"""IMU preintegration on manifold, on torch tensors.

Counterpart of hfnet_slam_tpu/geometry/imu.py (IMU::Preintegrated): delta
rotation/velocity/position between keyframes, the 15x15 covariance ordered
[dR dV dP bg ba], and the bias Jacobians (JRg, JVg, JVa, JPg, JPa) that
correct the deltas for a new bias without re-integration.

The reference integrates a padded (N,7) block [acc(3), gyro(3), dt] with one
masked `lax.scan`, where a masked row returns its input. Here the unmasked
rows are picked out first and stepped through in a Python loop, in their
order: the same sequence of states, since a masked step is the identity.
The per-row quantities that do not depend on the state (bias-corrected
measurements, Exp(w dt), J_r(w dt)) are computed for every row at once
before the loop. Everything stays on the device of `meas`; a step costs a
few dozen small launches, which a CUDA graph or a fused scan would remove.

`rows_integrated` counts the rows stepped through (all calls, all threads),
so a caller can tell how many steps a frame cost.
"""
from __future__ import annotations

import threading
from typing import NamedTuple

import numpy as np
import torch

from .. import lie

GRAVITY = 9.81
GRAVITY_VEC = (0.0, 0.0, -GRAVITY)

rows_integrated = 0
calls = 0
_count_lock = threading.Lock()


def gravity_vec(like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(GRAVITY_VEC, dtype=like.dtype, device=like.device)


class ImuCalib(NamedTuple):
    """Noise densities in discrete form and the camera-to-body extrinsic
    (x_b = Tbc_R x_c + Tbc_t). Host floats and numpy arrays: every consumer
    moves them to its own device."""

    sigma_g: float
    sigma_a: float
    sigma_gw: float
    sigma_aw: float
    Tbc_R: np.ndarray
    Tbc_t: np.ndarray


def default_calib(sigma_g=1.7e-4, sigma_a=2.0e-3, sigma_gw=1.9e-5, sigma_aw=3.0e-3,
                  freq=200.0) -> ImuCalib:
    """Continuous densities scaled by sqrt(freq) (Tracking.cc:705-706)."""
    sf = float(np.sqrt(freq))
    return ImuCalib(sigma_g=float(np.float32(sigma_g * sf)), sigma_a=float(np.float32(sigma_a * sf)),
                    sigma_gw=float(np.float32(sigma_gw / sf)),
                    sigma_aw=float(np.float32(sigma_aw / sf)),
                    Tbc_R=np.eye(3, dtype=np.float32), Tbc_t=np.zeros(3, np.float32))


class Preintegrated(NamedTuple):
    """Preintegrated deltas over an interval, at linearization bias (bg0,
    ba0). A batch of intervals stacks every field on a leading axis."""

    dT: torch.Tensor   # scalar
    dR: torch.Tensor   # (3,3)
    dV: torch.Tensor   # (3,)
    dP: torch.Tensor   # (3,)
    C: torch.Tensor    # (15,15)
    JRg: torch.Tensor
    JVg: torch.Tensor
    JVa: torch.Tensor
    JPg: torch.Tensor
    JPa: torch.Tensor
    bg0: torch.Tensor  # (3,)
    ba0: torch.Tensor  # (3,)

    def to(self, device):
        return Preintegrated(*(x.to(device) for x in self))


def stack(pres) -> Preintegrated:
    """A batch (leading axis) of preintegrations."""
    return Preintegrated(*(torch.stack(xs) for xs in zip(*pres)))


def index(pre: Preintegrated, i) -> Preintegrated:
    return Preintegrated(*(x[i] for x in pre))


def empty_preintegrated(bg0=None, ba0=None, device="cpu", dtype=torch.float32) -> Preintegrated:
    z3 = torch.zeros(3, dtype=dtype, device=device)
    z33 = torch.zeros((3, 3), dtype=dtype, device=device)
    return Preintegrated(
        dT=torch.zeros((), dtype=dtype, device=device),
        dR=torch.eye(3, dtype=dtype, device=device), dV=z3, dP=z3,
        C=torch.zeros((15, 15), dtype=dtype, device=device),
        JRg=z33, JVg=z33, JVa=z33, JPg=z33, JPa=z33,
        bg0=z3 if bg0 is None else torch.as_tensor(bg0, dtype=dtype, device=device),
        ba0=z3 if ba0 is None else torch.as_tensor(ba0, dtype=dtype, device=device))


def _count(n_rows):
    global rows_integrated, calls
    with _count_lock:
        rows_integrated += n_rows
        calls += 1


def integrate(meas: torch.Tensor, mask: torch.Tensor, calib: ImuCalib, bg0, ba0) -> Preintegrated:
    """Integrate a padded measurement block (IntegrateNewMeasurement per
    row): position and velocity first with the pre-update dR, the covariance
    through the (A, B) transition, the bias Jacobians, then the rotation
    update with normalize_rotation.

    meas: (N,7) rows [ax ay az wx wy wz dt]; mask: (N,) bool, False rows
    are skipped; bg0, ba0: (3,) linearization biases."""
    dev, dt_ = meas.device, meas.dtype
    bg0 = torch.as_tensor(bg0, dtype=dt_, device=dev)
    ba0 = torch.as_tensor(ba0, dtype=dt_, device=dev)
    rows = meas[mask.to(torch.bool)]
    n = int(rows.shape[0])
    _count(n)
    st = empty_preintegrated(bg0, ba0, dev, dt_)
    if n == 0:
        return st
    eye3 = torch.eye(3, dtype=dt_, device=dev)
    z3 = torch.zeros((3, 3), dtype=dt_, device=dev)
    # squared in float32, as the reference squares its float32 sigmas
    nga = torch.tensor([calib.sigma_g] * 3 + [calib.sigma_a] * 3, dtype=dt_, device=dev) ** 2
    walk = torch.diag(torch.tensor([calib.sigma_gw] * 3 + [calib.sigma_aw] * 3, dtype=dt_,
                                   device=dev) ** 2)
    # state-independent per-row terms, all rows at once
    a_all = rows[:, :3] - ba0
    w_all = rows[:, 3:6] - bg0
    dt_all = rows[:, 6]
    ahat_all = lie.hat(a_all)
    phi = w_all * dt_all[:, None]
    dRi_all = lie.so3_exp(phi)
    Jr_all = lie.so3_right_jacobian(phi)

    dT, dR, dV, dP, C = st.dT, st.dR, st.dV, st.dP, st.C
    JRg, JVg, JVa, JPg, JPa = st.JRg, st.JVg, st.JVa, st.JPg, st.JPa
    for i in range(n):
        a, dt, ahat, dRi, Jr = a_all[i], dt_all[i], ahat_all[i], dRi_all[i], Jr_all[i]
        dt2 = dt * dt
        dRa = dR @ a
        dP = dP + dV * dt + 0.5 * dRa * dt2
        dV = dV + dRa * dt
        dRah = dR @ ahat
        A = torch.cat([
            torch.cat([dRi.T, z3, z3], 1),
            torch.cat([-dRah * dt, eye3, z3], 1),
            torch.cat([-0.5 * dRah * dt2, eye3 * dt, eye3], 1)], 0)
        B = torch.cat([
            torch.cat([Jr * dt, z3], 1),
            torch.cat([z3, dR * dt], 1),
            torch.cat([z3, 0.5 * dR * dt2], 1)], 0)
        dRahJ = dRah @ JRg
        JPa = JPa + JVa * dt - 0.5 * dR * dt2
        JPg = JPg + JVg * dt - 0.5 * dRahJ * dt2
        JVa = JVa - dR * dt
        JVg = JVg - dRahJ * dt
        C9 = A @ C[:9, :9] @ A.T + (B * nga) @ B.T
        C = torch.cat([torch.cat([C9, C[:9, 9:]], 1),
                       torch.cat([C[9:, :9], C[9:, 9:] + walk], 1)], 0)
        dR = lie.normalize_rotation(dR @ dRi)
        JRg = dRi.T @ JRg - Jr * dt
        dT = dT + dt
    return Preintegrated(dT=dT, dR=dR, dV=dV, dP=dP, C=C, JRg=JRg, JVg=JVg, JVa=JVa,
                         JPg=JPg, JPa=JPa, bg0=bg0, ba0=ba0)


# ---------------------------------------------------------------------------
# bias-corrected getters (GetDelta{Rotation,Velocity,Position}); they
# broadcast over a leading batch axis of `pre`
# ---------------------------------------------------------------------------

def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def delta_rotation(pre: Preintegrated, bg):
    return pre.dR @ lie.so3_exp(_mv(pre.JRg, bg - pre.bg0))


def delta_velocity(pre: Preintegrated, bg, ba):
    return pre.dV + _mv(pre.JVg, bg - pre.bg0) + _mv(pre.JVa, ba - pre.ba0)


def delta_position(pre: Preintegrated, bg, ba):
    return pre.dP + _mv(pre.JPg, bg - pre.bg0) + _mv(pre.JPa, ba - pre.ba0)


def predict_state(R_wb, p_wb, v_w, bg, ba, pre: Preintegrated):
    """Propagate a body state through a preintegrated interval
    (PredictStateIMU). Returns (R_wb', p_wb', v_w')."""
    t = pre.dT
    g = gravity_vec(p_wb)
    R2 = lie.normalize_rotation(R_wb @ delta_rotation(pre, bg))
    v2 = v_w + g * t + _mv(R_wb, delta_velocity(pre, bg, ba))
    p2 = p_wb + v_w * t + 0.5 * g * t * t + _mv(R_wb, delta_position(pre, bg, ba))
    return R2, p2, v2


def inertial_residual(R1, p1, v1, bg1, ba1, R2, p2, v2, pre: Preintegrated):
    """9-d residual [eR eV eP] between consecutive body states (EdgeInertial);
    broadcasts over a leading batch axis."""
    t = pre.dT[..., None]
    g = gravity_vec(p1)
    dR = delta_rotation(pre, bg1)
    dV = delta_velocity(pre, bg1, ba1)
    dP = delta_position(pre, bg1, ba1)
    R1t = R1.transpose(-1, -2)
    eR = lie.so3_log(dR.transpose(-1, -2) @ R1t @ R2)
    eV = _mv(R1t, v2 - v1 - g * t) - dV
    eP = _mv(R1t, p2 - p1 - v1 * t - 0.5 * g * t * t) - dP
    return torch.cat([eR, eV, eP], -1)


def information_9(pre: Preintegrated):
    """inv(C[:9,:9]) symmetrized and floored (EdgeInertial's constructor).
    A singular block gives inf/NaN, as jnp.linalg.inv does, not an error."""
    C9 = pre.C[..., :9, :9]
    eye = torch.eye(9, dtype=C9.dtype, device=C9.device)
    C = 0.5 * (C9 + C9.transpose(-1, -2)) + 1e-12 * eye
    inv, _ = torch.linalg.inv_ex(C)
    return inv


def merge(pre1: Preintegrated, meas, mask, calib: ImuCalib) -> Preintegrated:
    """Append measurements to an existing preintegration."""
    return compose(pre1, integrate(meas, mask, calib, pre1.bg0, pre1.ba0))


def compose(a: Preintegrated, b: Preintegrated) -> Preintegrated:
    """Chain two preintegrated intervals (same linearization bias), with
    first-order Jacobian composition and the covariances summed."""
    dR = a.dR @ b.dR
    dV = a.dV + _mv(a.dR, b.dV)
    dP = a.dP + a.dV * b.dT + _mv(a.dR, b.dP)
    JRg = b.dR.T @ a.JRg + b.JRg
    JVg = a.JVg + a.dR @ b.JVg - a.dR @ lie.hat(b.dV) @ a.JRg
    JVa = a.JVa + a.dR @ b.JVa
    JPg = a.JPg + a.JVg * b.dT + a.dR @ b.JPg - a.dR @ lie.hat(b.dP) @ a.JRg
    JPa = a.JPa + a.JVa * b.dT + a.dR @ b.JPa
    return Preintegrated(dT=a.dT + b.dT, dR=lie.normalize_rotation(dR), dV=dV, dP=dP,
                         C=a.C + b.C, JRg=JRg, JVg=JVg, JVa=JVa, JPg=JPg, JPa=JPa,
                         bg0=a.bg0, ba0=a.ba0)
