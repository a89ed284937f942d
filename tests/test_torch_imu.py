"""Parity of the port's IMU preintegration and visual-inertial optimizers
(hfnet_slam_torch/geometry/imu.py, optim/inertial.py) with the JAX reference,
on tests/test_imu.py's synthetic trajectories and on seeded random inputs.

Tolerances: preintegration fields, deltas, residuals and information at 1e-5
relative to each field's largest entry (float32, the same operations in the
same order); inertial_init's scale, gravity and biases within 1e-4 (float32
Gauss-Newton, 40 steps); per-frame VI poses within 1e-4 and inlier masks
exactly; closed-form Jacobians against torch.func.jacfwd in float64 at 1e-6
relative."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from hfnet_slam_tpu import lie as Jlie
from hfnet_slam_tpu.geometry import cameras as Jcam
from hfnet_slam_tpu.geometry import imu as Jimu
from hfnet_slam_tpu.optim import inertial as Jin

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from hfnet_slam_torch import convert  # noqa: E402
from hfnet_slam_torch import lie as Tlie  # noqa: E402
from hfnet_slam_torch.geometry import cameras as Tcam  # noqa: E402
from hfnet_slam_torch.geometry import imu as Timu  # noqa: E402
from hfnet_slam_torch.optim import inertial as Tin  # noqa: E402

GRAV = np.asarray(Jimu.GRAVITY_VEC)
CAM_J = Jcam.pinhole(450., 450., 320., 240., 640, 480)
CAM_T = Tcam.pinhole(450., 450., 320., 240., 640, 480, device="cpu")


def T(x, dtype=torch.float32):
    return torch.tensor(np.array(x), dtype=dtype)


def close(port, ref, rel=1e-5, what=""):
    port = port.detach().cpu().numpy() if torch.is_tensor(port) else np.asarray(port)
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(port - ref).max()) if ref.size else 0.0
    assert err <= rel * scale, f"{what}: max |port - ref| {err:.3g} > {rel} x {scale:.3g}"


def simulate(n_steps, dt, w_fn, a_fn, g=GRAV, bg=np.zeros(3), ba=np.zeros(3), R0=np.eye(3),
             p0=np.zeros(3), v0=np.zeros(3)):
    """tests/test_imu.py's body simulator: (meas (N,7), R, p, v final)."""
    R, p, v = R0.copy(), p0.copy(), v0.copy()
    meas = np.zeros((n_steps, 7), np.float32)
    for i in range(n_steps):
        t = i * dt
        w, a_w = w_fn(t), a_fn(t)
        meas[i, :3] = R.T @ (a_w - g) + ba
        meas[i, 3:6] = w + bg
        meas[i, 6] = dt
        p = p + v * dt + 0.5 * a_w * dt * dt
        v = v + a_w * dt
        R = R @ np.asarray(Jlie.so3_exp(jnp.asarray(w * dt)))
    return meas, R, p, v


def both_integrate(meas, mask, bg=np.zeros(3, np.float32), ba=np.zeros(3, np.float32)):
    cj = Jimu.default_calib()
    pj = Jimu.integrate(jnp.asarray(meas), jnp.asarray(mask), cj, jnp.asarray(bg),
                        jnp.asarray(ba))
    pt = Timu.integrate(T(meas), T(mask, torch.bool), convert.imu_calib_from_reference(cj),
                        T(bg), T(ba))
    return pj, pt


def _random_block(seed, n=80, p_mask=0.3):
    rng = np.random.default_rng(seed)
    meas = np.zeros((n, 7), np.float32)
    meas[:, :3] = rng.normal(0, 2.0, (n, 3))
    meas[:, 3:6] = rng.normal(0, 0.6, (n, 3))
    meas[:, 6] = rng.uniform(0.004, 0.006, n)
    mask = rng.random(n) > p_mask
    mask[-5:] = False  # padded tail as well as interleaved holes
    return meas, mask


# ---------------------------------------------------------------------------
# preintegration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_integrate_with_interleaved_masked_rows(seed):
    meas, mask = _random_block(seed)
    assert (~mask[:-5]).any() and mask[:-5].any()
    bg = np.array([0.01, -0.02, 0.005], np.float32)
    ba = np.array([0.1, 0.0, -0.05], np.float32)
    pj, pt = both_integrate(meas, mask, bg, ba)
    for f in Jimu.Preintegrated._fields:
        close(getattr(pt, f), getattr(pj, f), what=f)


def test_masked_rows_leave_the_state_untouched():
    """A masked row, whatever it holds, is the identity step: the port gives
    bit-identical records with garbage in the masked rows."""
    meas, mask = _random_block(3)
    junk = meas.copy()
    junk[~mask] = 99.0
    a = Timu.integrate(T(meas), T(mask, torch.bool), Timu.default_calib(), T(np.zeros(3)),
                       T(np.zeros(3)))
    b = Timu.integrate(T(junk), T(mask, torch.bool), Timu.default_calib(), T(np.zeros(3)),
                       T(np.zeros(3)))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_merge_compose_and_bias_corrected_deltas():
    meas, mask = _random_block(4)
    more, mask2 = _random_block(5, n=40)
    pj, pt = both_integrate(meas, mask)
    cj = Jimu.default_calib()
    mj = Jimu.merge(pj, jnp.asarray(more), jnp.asarray(mask2), cj)
    mt = Timu.merge(pt, T(more), T(mask2, torch.bool), convert.imu_calib_from_reference(cj))
    for f in Jimu.Preintegrated._fields:
        close(getattr(mt, f), getattr(mj, f), what=f"merge.{f}")
    bg = np.array([0.02, -0.01, 0.03], np.float32)
    ba = np.array([-0.05, 0.08, 0.02], np.float32)
    close(Timu.delta_rotation(pt, T(bg)), Jimu.delta_rotation(pj, jnp.asarray(bg)), what="dR")
    close(Timu.delta_velocity(pt, T(bg), T(ba)),
          Jimu.delta_velocity(pj, jnp.asarray(bg), jnp.asarray(ba)), what="dV")
    close(Timu.delta_position(pt, T(bg), T(ba)),
          Jimu.delta_position(pj, jnp.asarray(bg), jnp.asarray(ba)), what="dP")


def test_predict_state_residual_and_information():
    meas, R2, p2, v2 = simulate(100, 0.005, lambda t: np.array([0.3, -0.2, 0.5]),
                                lambda t: np.array([1.0, 0.5, -0.3]))
    mask = np.ones(100, bool)
    pj, pt = both_integrate(meas, mask)
    R1 = np.asarray(Jlie.so3_exp(jnp.asarray([0.1, -0.2, 0.3])))
    p1 = np.array([0.5, -0.2, 0.1], np.float32)
    v1 = np.array([0.2, 0.1, -0.3], np.float32)
    bg = np.array([0.002, -0.001, 0.003], np.float32)
    ba = np.array([0.01, 0.02, -0.01], np.float32)
    sj = Jimu.predict_state(*(jnp.asarray(x) for x in (R1, p1, v1, bg, ba)), pj)
    st = Timu.predict_state(*(T(x) for x in (R1, p1, v1, bg, ba)), pt)
    for a, b, n in zip(st, sj, "Rpv"):
        close(a, b, what=f"predict {n}")
    rj = Jimu.inertial_residual(*(jnp.asarray(x) for x in (R1, p1, v1, bg, ba, R2, p2, v2)),
                                pj)
    rt = Timu.inertial_residual(*(T(x) for x in (R1, p1, v1, bg, ba, R2, p2, v2)), pt)
    close(rt, rj, rel=1e-4, what="residual")  # differences of O(1) terms
    close(Timu.information_9(pt), Jimu.information_9(pj), rel=1e-4, what="information_9")


# ---------------------------------------------------------------------------
# inertial initialization
# ---------------------------------------------------------------------------

def _init_chain():
    """TestInertialInit's chain: 12 keyframes, tilted gravity, gyro bias,
    true scale 2."""
    theta_g = np.array([0.08, -0.05, 0.0], np.float32)
    g_true = np.asarray(Jlie.so3_exp(jnp.asarray(theta_g))) @ GRAV
    bg_true = np.array([0.004, -0.003, 0.002], np.float32)
    dt, K, spk = 0.005, 12, 60
    R, p, v = np.eye(3), np.zeros(3), np.zeros(3)
    Rs, ps, blocks = [R.copy()], [p.copy()], []
    for k in range(K - 1):
        meas = np.zeros((spk, 7), np.float32)
        for i in range(spk):
            t = (k * spk + i) * dt
            w = np.array([0.8 * np.sin(2 * t), 0.5, -0.6 * np.cos(1.5 * t)])
            a_w = np.array([2.0 * np.cos(3 * t), 1.5 * np.sin(4 * t), 0.8 * np.sin(2 * t)])
            meas[i, :3] = R.T @ (a_w - g_true)
            meas[i, 3:6] = w + bg_true
            meas[i, 6] = dt
            p = p + v * dt + 0.5 * a_w * dt * dt
            v = v + a_w * dt
            R = R @ np.asarray(Jlie.so3_exp(jnp.asarray(w * dt)))
        Rs.append(R.copy())
        ps.append(p.copy())
        blocks.append(meas)
    return (np.stack(Rs).astype(np.float32), (np.stack(ps) / 2.0).astype(np.float32), blocks,
            g_true, bg_true)


@pytest.fixture(scope="module")
def init_chain():
    R, p, blocks, g_true, bg_true = _init_chain()
    ones = np.ones(blocks[0].shape[0], bool)
    pres_j = [both_integrate(b, ones)[0] for b in blocks]
    pre_j = jax.tree.map(lambda *xs: jnp.stack(xs), *pres_j)
    return R, p, pre_j, convert.preintegrated_from_reference(pre_j), g_true, bg_true


@pytest.mark.parametrize("fix_scale", [False, True])
def test_inertial_init_matches_reference(init_chain, fix_scale):
    R, p, pre_j, pre_t, g_true, bg_true = init_chain
    rj = Jin.inertial_init(jnp.asarray(R), jnp.asarray(p), pre_j, prior_g=1e2, prior_a=1e10,
                           n_iters=60, fix_scale=fix_scale)
    rt = Tin.inertial_init(T(R), T(p), pre_t, prior_g=1e2, prior_a=1e10, n_iters=60,
                           fix_scale=fix_scale)
    assert abs(float(rt["scale"]) - float(rj["scale"])) <= 1e-4
    np.testing.assert_allclose(rt["bg"].numpy(), np.asarray(rj["bg"]), atol=1e-4)
    np.testing.assert_allclose(rt["ba"].numpy(), np.asarray(rj["ba"]), atol=1e-4)
    gj = np.asarray(rj["Rwg"]) @ GRAV
    gt = rt["Rwg"].numpy() @ GRAV
    np.testing.assert_allclose(gt, gj, atol=1e-4 * 9.81)
    if not fix_scale:  # the reference's own acceptance (tests/test_imu.py)
        assert abs(float(rt["scale"]) - 2.0) < 0.02
        assert np.abs(rt["bg"].numpy() - bg_true).max() < 1e-3


def test_lstsq_min_norm_on_a_rank_deficient_system():
    """Constant velocity, no rotation: the alignment's velocity and gravity
    columns are dependent. jnp.linalg.lstsq gives the minimum-norm solution;
    so does the port's SVD replacement (torch.linalg.lstsq's CUDA driver
    assumes full rank)."""
    rng = np.random.default_rng(0)
    A = rng.normal(size=(30, 8)).astype(np.float32)
    A[:, 5] = A[:, 1] + A[:, 2]   # rank 6
    A[:, 7] = 2.0 * A[:, 3]
    b = rng.normal(size=30).astype(np.float32)
    uj = np.asarray(jnp.linalg.lstsq(jnp.asarray(A), jnp.asarray(b))[0])
    ut = Tin.lstsq_min_norm(T(A), T(b)[:, None])[:, 0].numpy()
    np.testing.assert_allclose(ut, uj, atol=1e-4)
    assert np.linalg.norm(ut) <= np.linalg.norm(np.linalg.lstsq(A, b, rcond=None)[0]) + 1e-4


def test_inertial_init_constant_velocity_no_rotation():
    """A rank-deficient alignment (no rotation, constant velocity) through
    both packages: the same finite or non-finite answer."""
    calib = Jimu.default_calib()
    K, spk, dt = 6, 40, 0.005
    v0 = np.array([0.5, 0.0, 0.0])
    blocks, Rs, ps = [], [], []
    for k in range(K):
        Rs.append(np.eye(3, dtype=np.float32))
        ps.append(v0 * k * spk * dt)
    for k in range(K - 1):
        meas, *_ = simulate(spk, dt, lambda t: np.zeros(3), lambda t: np.zeros(3), v0=v0)
        blocks.append(meas)
    ones = np.ones(spk, bool)
    pj = [Jimu.integrate(jnp.asarray(m), jnp.asarray(ones), calib, jnp.zeros(3), jnp.zeros(3))
          for m in blocks]
    pre_j = jax.tree.map(lambda *xs: jnp.stack(xs), *pj)
    R, p = np.stack(Rs), np.stack(ps).astype(np.float32)
    rj = Jin.inertial_init(jnp.asarray(R), jnp.asarray(p), pre_j, n_iters=20)
    rt = Tin.inertial_init(T(R), T(p), convert.preintegrated_from_reference(pre_j), n_iters=20)
    for k in ("scale", "bg", "ba", "v"):
        a, b = rt[k].numpy(), np.asarray(rj[k])
        assert np.array_equal(np.isfinite(a), np.isfinite(b)), k
        np.testing.assert_allclose(a[np.isfinite(a)], b[np.isfinite(b)], atol=1e-3, rtol=1e-3)


def test_degenerate_cholesky_gives_nan_not_an_error():
    """A preintegration whose covariance is not positive definite: JAX's
    Cholesky returns NaN and the solvers refuse every step; the port does
    the same instead of raising."""
    meas, mask = _random_block(6, n=20, p_mask=0.0)
    pj, _ = both_integrate(meas, mask)
    pj = pj._replace(C=-jnp.eye(15))
    pt = convert.preintegrated_from_reference(pj)
    Lj = np.asarray(jnp.linalg.cholesky(Jimu.information_9(pj) + 1e-9 * jnp.eye(9)))
    Lt = Tin.chol(Timu.information_9(pt) + 1e-9 * torch.eye(9)).numpy()
    assert not np.isfinite(Lj).all() and not np.isfinite(Lt).all()
    args = _pose_args(7)
    rj = Jin.pose_inertial_optimize(CAM_J.kind, CAM_J.params, jnp.eye(3), jnp.zeros(3),
                                    *(jnp.asarray(x) for x in args["anchor"]), pj,
                                    *(jnp.asarray(x) for x in args["guess"]),
                                    *(jnp.asarray(x) for x in args["obs"]))
    rt = Tin.pose_inertial_optimize(CAM_T.kind, CAM_T.params, torch.eye(3), torch.zeros(3),
                                    *(T(x) for x in args["anchor"]), pt,
                                    *(T(x) for x in args["guess"]),
                                    *_obs_t(args["obs"]))
    # every step refused: both return the initial guess, and a NaN posterior
    np.testing.assert_allclose(rt["p"].numpy(), np.asarray(rj["p"]), atol=1e-6)
    np.testing.assert_allclose(rt["p"].numpy(), args["guess"][1], atol=1e-6)
    assert not np.isfinite(np.asarray(rj["H"])).all() and not torch.isfinite(rt["H"]).all()
    assert np.array_equal(rt["inlier"].numpy(), np.asarray(rj["inlier"]))


# ---------------------------------------------------------------------------
# per-frame VI solvers
# ---------------------------------------------------------------------------

def _pose_args(seed, n_out=20):
    """tests/test_imu.py's TestPoseInertial scene with outliers: anchor
    state, perturbed guess, 256 observations."""
    rng = np.random.default_rng(seed)
    R1 = np.asarray(Jlie.so3_exp(jnp.asarray([0.05, -0.1, 0.2])))
    p1 = np.array([0.3, -0.1, 0.0], np.float32)
    v1 = np.array([0.4, 0.1, -0.2], np.float32)
    meas, R2t, p2t, v2t = simulate(10, 0.005, lambda t: np.array([0.3, -0.2, 0.5]),
                                   lambda t: np.array([1.0, 0.5, -0.3]), R0=R1, p0=p1, v0=v1)
    M = 256
    pts = (rng.uniform(-4, 4, (M, 3)) + np.array([0, 0, 8])).astype(np.float32)
    R_cw, t_cw = Jin.body_to_cam(jnp.asarray(R2t), jnp.asarray(p2t), jnp.eye(3), jnp.zeros(3))
    uv = np.array(CAM_J.project(jnp.asarray(pts) @ np.asarray(R_cw).T + np.asarray(t_cw)))
    uv = (uv + rng.normal(0, 0.3, uv.shape)).astype(np.float32)
    uv[:n_out] += rng.uniform(15, 40, (n_out, 2)).astype(np.float32)
    valid = np.ones(M, bool)
    valid[-10:] = False
    inv_s2 = (1.0 / 1.2 ** (2 * rng.integers(0, 3, M))).astype(np.float32)
    z3 = np.zeros(3, np.float32)
    guess = (R2t @ np.asarray(Jlie.so3_exp(jnp.asarray([0.02, -0.01, 0.03]))),
             (p2t + np.array([0.05, -0.03, 0.02])).astype(np.float32),
             (v2t + 0.1).astype(np.float32))
    return {"meas": meas, "anchor": (R1, p1, v1, z3, z3), "guess": guess,
            "obs": (pts, uv, inv_s2, valid), "truth": (R2t, p2t, v2t)}


def _obs_t(obs):
    pts, uv, inv_s2, valid = obs
    return T(pts), T(uv), T(inv_s2), T(valid, torch.bool)


@pytest.mark.parametrize("seed", [1, 2])
def test_pose_inertial_optimize_matches_reference(seed):
    a = _pose_args(seed)
    pj, pt = both_integrate(a["meas"], np.ones(10, bool))
    rj = Jin.pose_inertial_optimize(CAM_J.kind, CAM_J.params, jnp.eye(3), jnp.zeros(3),
                                    *(jnp.asarray(x) for x in a["anchor"]), pj,
                                    *(jnp.asarray(x) for x in a["guess"]),
                                    *(jnp.asarray(x) for x in a["obs"]))
    rt = Tin.pose_inertial_optimize(CAM_T.kind, CAM_T.params, torch.eye(3), torch.zeros(3),
                                    *(T(x) for x in a["anchor"]), pt,
                                    *(T(x) for x in a["guess"]), *_obs_t(a["obs"]))
    assert np.array_equal(rt["inlier"].numpy(), np.asarray(rj["inlier"]))
    for k in ("R", "p", "v", "bg", "ba"):
        np.testing.assert_allclose(rt[k].numpy(), np.asarray(rj[k]), atol=1e-4, err_msg=k)
    close(rt["H"], rj["H"], rel=1e-3, what="posterior H")
    assert np.linalg.norm(rt["p"].numpy() - a["truth"][1]) < 5e-3


@pytest.mark.parametrize("seed", [1, 2])
def test_pose_inertial_optimize_marg_matches_reference(seed):
    a = _pose_args(seed)
    pj, pt = both_integrate(a["meas"], np.ones(10, bool))
    # the prior a first KF-anchored solve hands over (its posterior H)
    H = np.asarray(Jin.pose_inertial_optimize(
        CAM_J.kind, CAM_J.params, jnp.eye(3), jnp.zeros(3),
        *(jnp.asarray(x) for x in a["anchor"]), pj, *(jnp.asarray(x) for x in a["guess"]),
        *(jnp.asarray(x) for x in a["obs"]))["H"])
    rj = Jin.pose_inertial_optimize_marg(
        CAM_J.kind, CAM_J.params, jnp.eye(3), jnp.zeros(3),
        *(jnp.asarray(x) for x in a["anchor"]), jnp.asarray(H), pj,
        *(jnp.asarray(x) for x in a["guess"]), *(jnp.asarray(x) for x in a["obs"]))
    rt = Tin.pose_inertial_optimize_marg(
        CAM_T.kind, CAM_T.params, torch.eye(3), torch.zeros(3),
        *(T(x) for x in a["anchor"]), T(H), pt, *(T(x) for x in a["guess"]),
        *_obs_t(a["obs"]))
    assert np.array_equal(rt["inlier"].numpy(), np.asarray(rj["inlier"]))
    for k in ("R", "p", "v", "bg", "ba"):
        np.testing.assert_allclose(rt[k].numpy(), np.asarray(rj[k]), atol=1e-4, err_msg=k)
    close(rt["prior_info_out"], rj["prior_info_out"], rel=1e-3, what="prior_info_out")


# ---------------------------------------------------------------------------
# closed-form Jacobians against forward-mode autodiff (float64)
# ---------------------------------------------------------------------------

def _rand_pre(rng, n=30):
    meas, mask = _random_block(int(rng.integers(1 << 30)), n=n, p_mask=0.0)
    pre = Timu.integrate(T(meas, torch.float64), T(mask, torch.bool), Timu.default_calib(),
                         T(rng.normal(0, 0.01, 3), torch.float64),
                         T(rng.normal(0, 0.05, 3), torch.float64))
    return pre


def _rand_rot(rng):
    return Tlie.so3_exp(T(rng.normal(0, 0.8, 3), torch.float64))


def _jac_close(Jc, Ja, what):
    Jc, Ja = Jc.detach().numpy(), Ja.detach().numpy()
    err = np.abs(Jc - Ja).max()
    assert err <= 1e-6 * max(np.abs(Ja).max(), 1.0), f"{what}: {err:.3g}"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_inertial_jacobian_is_the_derivative(seed):
    rng = np.random.default_rng(seed)
    pre = _rand_pre(rng)
    R1, R2 = _rand_rot(rng), _rand_rot(rng)
    p1, v1, p2, v2, bg, ba, g = (T(rng.normal(0, 1, 3), torch.float64) for _ in range(7))
    bg = bg * 0.02
    ba = ba * 0.1

    def f(x):
        return Tin.inertial_residual_jac(R1 @ Tlie.so3_exp(x[0:3]), p1 + x[3:6], v1 + x[6:9],
                                         R2 @ Tlie.so3_exp(x[9:12]), p2 + x[12:15],
                                         v2 + x[15:18], bg + x[18:21], ba + x[21:24], pre,
                                         g=g)[0]

    Ja = torch.func.jacfwd(f)(torch.zeros(24, dtype=torch.float64))
    _, J = Tin.inertial_residual_jac(R1, p1, v1, R2, p2, v2, bg, ba, pre, g=g)
    for i, k in enumerate(("phi1", "p1", "v1", "phi2", "p2", "v2", "bg", "ba")):
        _jac_close(J[k], Ja[:, 3 * i:3 * i + 3], k)
    # the residual is imu.inertial_residual's
    r = Tin.inertial_residual_jac(R1, p1, v1, R2, p2, v2, bg, ba, pre)[0]
    np.testing.assert_allclose(r.numpy(), Timu.inertial_residual(
        R1, p1, v1, bg, ba, R2, p2, v2, pre).numpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("seed", [0, 1])
def test_visual_jacobian_is_the_derivative(seed):
    rng = np.random.default_rng(seed)
    R = _rand_rot(rng) * 1.0
    p = T(rng.normal(0, 0.3, 3), torch.float64)
    Tbc_R = Tlie.so3_exp(T(rng.normal(0, 0.2, 3), torch.float64))
    Tbc_t = T(rng.normal(0, 0.05, 3), torch.float64)
    cam = Tcam.pinhole(450., 450., 320., 240., 640, 480, device="cpu")
    params = cam.params.double()
    R_cw, t_cw = Tin.body_to_cam(R, p, Tbc_R, Tbc_t)
    pc = torch.tensor(rng.uniform(-2, 2, (20, 3)) + [0, 0, 6], dtype=torch.float64)
    pts = (pc - t_cw) @ R_cw      # world points in front of the camera
    uv = T(rng.uniform(0, 600, (20, 2)), torch.float64)

    def f(x):
        return Tin.visual_residual_jac(cam.kind, params, R @ Tlie.so3_exp(x[:3]), p + x[3:],
                                       Tbc_R, Tbc_t, pts, uv)[0]

    Ja = torch.func.jacfwd(f)(torch.zeros(6, dtype=torch.float64))
    _, _, J = Tin.visual_residual_jac(cam.kind, params, R, p, Tbc_R, Tbc_t, pts, uv)
    _jac_close(J, Ja, "visual")


def test_inertial_init_jacobian_is_the_derivative(init_chain):
    """The init's closed-form Jacobian, reached through its Gauss-Newton
    residual at a random x, against jacfwd (float64)."""
    R, p, pre_j, pre_t, _, _ = init_chain
    pre64 = Timu.Preintegrated(*(x.double() for x in pre_t))
    K = R.shape[0]
    rng = np.random.default_rng(3)
    x = T(rng.normal(0, 0.05, 9 + 3 * K), torch.float64)
    res = {}

    def grab(x_):
        out = Tin._init_residuals(T(R, torch.float64), T(p, torch.float64), pre64, x_,
                                  1e2, 1e10, False, with_jac=False)[0]
        return out

    Ja = torch.func.jacfwd(grab)(x)
    res = Tin._init_residuals(T(R, torch.float64), T(p, torch.float64), pre64, x, 1e2, 1e10,
                              False, with_jac=True)
    _jac_close(res[1], Ja, "inertial_init")


def test_reintegrate_chain_on_a_large_bias_jump():
    """VIManager.reintegrate_chain relinearizes a chain link at the new
    bias exactly once the bias moved past tolerance, in both packages, and
    the records agree."""
    from hfnet_slam_tpu.slam.map import MapStore as JStore
    from hfnet_slam_tpu.slam.vi import VIConfig as JCfg
    from hfnet_slam_tpu.slam.vi import VIManager as JVim
    from hfnet_slam_torch.slam.map import MapStore as TStore
    from hfnet_slam_torch.slam.vi import VIConfig as TCfg
    from hfnet_slam_torch.slam.vi import VIManager as TVim

    bg_true = np.array([0.02, -0.015, 0.01], np.float32)
    meas, *_ = simulate(40, 0.0125, lambda t: np.array([0.3, -0.2, 0.5]),
                        lambda t: np.array([1.0, 0.5, -0.3]), bg=bg_true)
    out = {}
    for name, Store, Vim, Cfg, calib in (
            ("ref", JStore, JVim, JCfg, Jimu.default_calib()),
            ("port", TStore, TVim, TCfg, Timu.default_calib())):
        store = Store(k_max=4, m_max=16, n_slots=8, desc_dim=8, gdesc_dim=8)
        store.kf_valid[:2] = True
        store.kf_timestamp[:2] = [0.0, 0.5]
        kw = {"device": "cpu"} if name == "port" else {}
        vim = Vim(calib, store, Cfg(meas_cap=64), **kw)
        pre0 = vim.integrate(meas)
        vim.on_keyframe(1, 0, pre0, meas=meas)
        assert vim.reintegrate_chain() == 0  # within tolerance: untouched
        store.kf_bg[0] = bg_true
        assert vim.reintegrate_chain() == 1
        pre1 = vim.kf_pre[1]
        direct = vim.integrate(meas, bg=bg_true)
        np.testing.assert_allclose(np.asarray(pre1.bg0), bg_true, atol=1e-6)
        np.testing.assert_allclose(np.asarray(pre1.dR), np.asarray(direct.dR), atol=1e-6)
        out[name] = pre1
    for f in Jimu.Preintegrated._fields:
        close(getattr(out["port"], f), getattr(out["ref"], f), what=f)
    corr = Timu.delta_rotation(convert.preintegrated_from_reference(
        both_integrate(meas, np.ones(40, bool))[0]), T(bg_true))
    assert np.linalg.norm(out["port"].dR.numpy() - corr.numpy()) < 5e-3
