"""Parity of the port's pose LM and Schur BA with the JAX reference, on the
problems of tests/test_optim.py (drawn with the same jax keys).

Tolerances: pose LM results 1e-4 (float32 LM, 40 steps; accept decisions
compare summed cost differences); BA results 1e-3 relative (segment sums
land in another order); inlier / edge-validity masks exactly."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from hfnet_slam_tpu import lie as Jlie
from hfnet_slam_tpu.geometry import cameras as Jcam
from hfnet_slam_tpu.optim import ba as Jba
from hfnet_slam_tpu.optim import pose_opt as Jpo

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from hfnet_slam_torch.geometry import cameras as Tcam  # noqa: E402
from hfnet_slam_torch.optim import ba as Tba  # noqa: E402
from hfnet_slam_torch.optim import pose_opt as Tpo  # noqa: E402

CAM_J = Jcam.pinhole(458.0, 457.0, 367.0, 248.0, 752, 480)
CAM_T = Tcam.pinhole(458.0, 457.0, 367.0, 248.0, 752, 480, device="cpu")


def T(x):
    return torch.from_numpy(np.array(x))


def make_world(key, m=300):
    return jax.random.uniform(key, (m, 3), minval=-4, maxval=4) + jnp.array([0, 0, 8.0])


def _pose_problem(case):
    key = {"perturbed": 0, "noise_free": 7, "outliers": 1, "masked": 2}[case]
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(key), 3)
    n = 300
    pts = make_world(k1, n)
    R_gt = Jlie.so3_exp(jnp.array([0.04, -0.1, 0.06]))
    t_gt = jnp.array([0.3, -0.2, 0.5])
    uv = CAM_J.project(pts @ R_gt.T + t_gt)
    uv = uv + jax.random.normal(k2, uv.shape) * (0.0 if case == "noise_free" else 0.5)
    valid = jnp.ones(n, bool)
    if case == "outliers":
        uv = uv.at[:75].add(jax.random.uniform(k3, (75, 2), minval=30, maxval=120))
        xi = 0.05 * jnp.ones(6)
    elif case == "noise_free":
        xi = jnp.array([0.1, -0.08, 0.12, 0.03, 0.02, -0.04])
    elif case == "masked":
        xi = jnp.zeros(6)
        valid = jnp.arange(n) < 150
    else:
        xi = jnp.array([0.05, -0.05, 0.1, 0.02, 0.03, -0.02])
    dR, dt = Jlie.se3_exp(xi)
    R0, t0 = Jlie.se3_mul(dR, dt, R_gt, t_gt)
    return [np.asarray(a) for a in (R0, t0, pts, uv, jnp.ones(n), valid)]


@pytest.mark.parametrize("case", ["perturbed", "noise_free", "outliers", "masked"])
def test_pose_optimize_core(case):
    R0, t0, pts, uv, w, valid = _pose_problem(case)
    rj = Jpo.pose_optimize(CAM_J.kind, CAM_J.params, R0, t0, pts, uv, w, valid)
    rt = Tpo.pose_optimize_core(CAM_T.kind, CAM_T.params, T(R0), T(t0), T(pts), T(uv), T(w),
                                T(valid))
    np.testing.assert_allclose(rt["R"].numpy(), np.asarray(rj["R"]), atol=1e-4)
    np.testing.assert_allclose(rt["t"].numpy(), np.asarray(rj["t"]), atol=1e-4)
    np.testing.assert_array_equal(rt["inlier"].numpy(), np.asarray(rj["inlier"]))
    assert int(rt["n_inliers"]) == int(rj["n_inliers"])


def _ba_problem(key, K=6, M=250, noise_px=0.5, outliers=False):
    """tests/test_optim.py TestBundleAdjust._make_problem."""
    kp, kn, kq = jax.random.split(key, 3)
    pts_gt = make_world(kp, M)
    Rs, ts = [], []
    for i in range(K):
        R, t = Jlie.se3_exp(jnp.array([0.4 * i, 0.02 * i, 0.0, 0.0, 0.03 * i, 0.0]))
        Rs.append(R)
        ts.append(t)
    poses_R, poses_t = jnp.stack(Rs), jnp.stack(ts)
    kf_idx = jnp.repeat(jnp.arange(K), M).astype(jnp.int32)
    pt_idx = jnp.tile(jnp.arange(M), K).astype(jnp.int32)
    pc = jnp.einsum("kij,mj->kmi", poses_R, pts_gt) + poses_t[:, None, :]
    uv = CAM_J.project(pc.reshape(-1, 3)) + jax.random.normal(kn, (K * M, 2)) * noise_px
    if outliers:
        uv = uv.at[:100].add(80.0)
    xi_noise = (jax.random.normal(kq, (K, 6)) * 0.01).at[:2].set(0.0)
    R0, t0 = jax.vmap(Jlie.se3_retract)(poses_R, poses_t, xi_noise)
    p0 = pts_gt + jax.random.normal(kq, (M, 3)) * 0.05
    return dict(poses_R=R0, poses_t=t0, fixed=jnp.arange(K) < 2, points=p0, kf_idx=kf_idx,
                pt_idx=pt_idx, uv=uv, inv_sigma2=jnp.ones(K * M), valid=jnp.ones(K * M, bool))


def _to_port(d):
    out = {k: T(np.asarray(v)) for k, v in d.items()}
    out["kf_idx"] = out["kf_idx"].long()
    out["pt_idx"] = out["pt_idx"].long()
    return Tba.BAProblem(**out)


@pytest.mark.parametrize("robust", [True, False])
def test_ba_iterate(robust):
    d = _ba_problem(jax.random.PRNGKey(3))
    pj, cj = Jba.ba_iterate(CAM_J.kind, CAM_J.params, Jba.BAProblem(**d), 5, robust, 5.991)
    pt, ct = Tba.ba_iterate(CAM_T.kind, CAM_T.params, _to_port(d), 5, robust, 5.991)
    np.testing.assert_allclose(pt.poses_R.numpy(), np.asarray(pj.poses_R), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(pt.poses_t.numpy(), np.asarray(pj.poses_t), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(pt.points.numpy(), np.asarray(pj.points), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-3)


@pytest.mark.parametrize("case", ["converges", "noise_free", "outlier_edges"])
def test_bundle_adjust(case):
    key = {"converges": 3, "noise_free": 5, "outlier_edges": 4}[case]
    d = _ba_problem(jax.random.PRNGKey(key), noise_px=0.0 if case == "noise_free" else 0.5,
                    outliers=case == "outlier_edges")
    oj = Jba.bundle_adjust(CAM_J.kind, CAM_J.params, Jba.BAProblem(**d))
    ot = Tba.bundle_adjust(CAM_T.kind, CAM_T.params, _to_port(d))
    np.testing.assert_allclose(ot.poses_R.numpy(), np.asarray(oj.poses_R), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(ot.poses_t.numpy(), np.asarray(oj.poses_t), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(ot.points.numpy(), np.asarray(oj.points), rtol=1e-3, atol=1e-4)
    np.testing.assert_array_equal(ot.valid.numpy(), np.asarray(oj.valid))
    # fixed poses stay bit-identical to their input
    np.testing.assert_array_equal(ot.poses_R[:2].numpy(), np.asarray(d["poses_R"])[:2])


def test_bundle_adjust_should_abort_keeps_input():
    d = _ba_problem(jax.random.PRNGKey(3))
    prob = _to_port(d)
    out = Tba.bundle_adjust(CAM_T.kind, CAM_T.params, prob, should_abort=lambda: True)
    assert torch.equal(out.poses_R, prob.poses_R) and torch.equal(out.points, prob.points)
