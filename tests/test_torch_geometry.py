"""Parity of the port's lie / cameras / triangulation / twoview with the JAX
reference on the same numpy inputs (port on the CPU).

Tolerances: float32 closed-form maps agree to 1e-5 (rotations, bearings,
tangent vectors) and 1e-3 px for pixels and Jacobians of ~450 px focal
length; boolean masks and model choices exactly."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from hfnet_slam_tpu import lie as Jlie
from hfnet_slam_tpu.geometry import cameras as Jcam
from hfnet_slam_tpu.geometry import triangulation as Jtri
from hfnet_slam_tpu.geometry import twoview as Jtv

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from hfnet_slam_torch import lie as Tlie  # noqa: E402
from hfnet_slam_torch.geometry import cameras as Tcam  # noqa: E402
from hfnet_slam_torch.geometry import triangulation as Ttri  # noqa: E402
from hfnet_slam_torch.geometry import twoview as Ttv  # noqa: E402


def T(x):
    return torch.from_numpy(np.asarray(x))


def _tangents(seed, n=64, scale=1.0):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, 3)).astype(np.float32) * scale
    v[0] = 0.0                         # identity
    v[1] = [1e-6, -2e-6, 3e-7]         # small-angle branch
    v[2] = [np.pi - 1e-3, 0.0, 0.0]    # near pi
    return v


# ---------------------------------------------------------------- lie -----
@pytest.mark.parametrize("scale", [1e-3, 0.3, 1.5])
def test_so3_exp_log(scale):
    phi = _tangents(1, scale=scale)
    R_j, R_t = np.asarray(Jlie.so3_exp(phi)), Tlie.so3_exp(T(phi)).numpy()
    np.testing.assert_allclose(R_t, R_j, atol=1e-5)
    np.testing.assert_allclose(Tlie.so3_log(T(R_j)).numpy(), np.asarray(Jlie.so3_log(R_j)),
                               atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_se3_exp_log_retract(seed):
    rng = np.random.default_rng(seed)
    xi = np.concatenate([rng.standard_normal((32, 3)), _tangents(seed, 32, 0.5)],
                        1).astype(np.float32)
    R_j, t_j = Jlie.se3_exp(xi)
    R_t, t_t = Tlie.se3_exp(T(xi))
    np.testing.assert_allclose(R_t.numpy(), np.asarray(R_j), atol=1e-5)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), atol=1e-5)
    np.testing.assert_allclose(Tlie.se3_log(R_t, t_t).numpy(),
                               np.asarray(Jlie.se3_log(R_j, t_j)), atol=1e-4)
    d = (0.05 * rng.standard_normal((32, 6))).astype(np.float32)
    Rr_j, tr_j = jax.vmap(Jlie.se3_retract)(R_j, t_j, d)
    Rr_t, tr_t = Tlie.se3_retract(R_t, t_t, T(d))
    np.testing.assert_allclose(Rr_t.numpy(), np.asarray(Rr_j), atol=1e-5)
    np.testing.assert_allclose(tr_t.numpy(), np.asarray(tr_j), atol=1e-5)


def test_quaternion_pivots_and_orthonormalize():
    # rotations near each Shepperd pivot branch, slightly non-orthonormal
    rng = np.random.default_rng(3)
    axes = np.array([[0, 0, 0.1], [np.pi - 0.05, 0, 0], [0, np.pi - 0.05, 0],
                     [0, 0, np.pi - 0.05]], np.float32)
    R = np.asarray(Jlie.so3_exp(axes)) + 1e-4 * rng.standard_normal((4, 3, 3)).astype(np.float32)
    np.testing.assert_allclose(Tlie.rot_to_quat(T(R)).numpy(),
                               np.asarray(Jlie.rot_to_quat(R)), atol=1e-5)
    np.testing.assert_allclose(Tlie.orthonormalize(T(R)).numpy(),
                               np.asarray(Jlie.orthonormalize(R)), atol=1e-5)


# ------------------------------------------------------------ cameras -----
CAMS = {
    "pinhole": ((458.0, 457.0, 367.0, 248.0, 752, 480), "pinhole"),
    "kb8": ((190.97, 190.97, 254.93, 256.89, 0.0034, 0.0007, -0.0020, 0.0002, 512, 512), "kb8"),
}


@pytest.mark.parametrize("name", sorted(CAMS))
def test_camera_project_unproject_jacobian(name):
    args, ctor = CAMS[name]
    cj, ct = getattr(Jcam, ctor)(*args), getattr(Tcam, ctor)(*args, device="cpu")
    rng = np.random.default_rng(7)
    pc = (rng.uniform(-1, 1, (200, 3)) + [0, 0, 3.0]).astype(np.float32)
    uv_j = np.asarray(cj.project(pc))
    np.testing.assert_allclose(ct.project(T(pc)).numpy(), uv_j, atol=1e-3)
    np.testing.assert_allclose(ct.project_jac(T(pc)).numpy(), np.asarray(cj.project_jac(pc)),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(ct.unproject(T(uv_j)).numpy(), np.asarray(cj.unproject(uv_j)),
                               atol=1e-5)


def test_radtan_undistort():
    args = (458.654, 457.296, 367.215, 248.375, 752, 480)
    dist = (-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05)
    cj, ct = Jcam.pinhole(*args, dist=dist), Tcam.pinhole(*args, dist=dist, device="cpu")
    rng = np.random.default_rng(2)
    uv = rng.uniform([50, 40], [700, 440], (300, 2)).astype(np.float32)
    raw_j = np.asarray(Jcam.distort_points(cj.params, cj.dist, uv))
    np.testing.assert_allclose(Tcam.distort_points(ct.params, ct.dist, T(uv)).numpy(), raw_j,
                               atol=1e-3)
    np.testing.assert_allclose(ct.undistort(T(raw_j)).numpy(), np.asarray(cj.undistort(raw_j)),
                               atol=1e-3)


# ------------------------------------------------------- triangulation -----
def _two_view(seed, n=300, noise=0.0):
    rng = np.random.default_rng(seed)
    p1 = (rng.uniform(-3, 3, (n, 3)) + [0, 0, 7.0]).astype(np.float32)
    R21 = np.asarray(Jlie.so3_exp(np.array([0.03, -0.15, 0.02], np.float32)))
    t21 = np.array([1.0, 0.1, 0.05], np.float32)
    p2 = p1 @ R21.T + t21
    x1 = (p1[:, :2] / p1[:, 2:] + noise * rng.standard_normal((n, 2))).astype(np.float32)
    x2 = (p2[:, :2] / p2[:, 2:] + noise * rng.standard_normal((n, 2))).astype(np.float32)
    return x1, x2, R21, t21


@pytest.mark.parametrize("noise", [0.0, 1.0 / 458.0])
def test_triangulate_and_gates(noise):
    x1, x2, R21, t21 = _two_view(0, noise=noise)
    p_j = np.asarray(Jtri.triangulate_dlt(x1, x2, R21, t21))
    p_t = Ttri.triangulate_dlt(T(x1), T(x2), T(R21), T(t21)).numpy()
    np.testing.assert_allclose(p_t, p_j, rtol=1e-4, atol=1e-4)
    th2 = 4.0 / 458.0 ** 2
    g_j, c_j = Jtri.cheirality_and_error(p_j, x1, x2, R21, t21, th2)
    g_t, c_t = Ttri.cheirality_and_error(T(p_j), T(x1), T(x2), T(R21), T(t21), th2)
    np.testing.assert_array_equal(g_t.numpy(), np.asarray(g_j))
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=1e-6)


def test_triangulate_batched_poses_match_per_pair():
    """The port's explicit neighbor batch equals the reference's per-pair
    (vmapped) calls."""
    pairs = [_two_view(s, n=100, noise=1.0 / 458.0) for s in range(3)]
    x1 = pairs[0][0]
    x2 = np.stack([p[1] for p in pairs])
    R = np.stack([p[2] for p in pairs])
    t = np.stack([p[3] for p in pairs])
    p_t = Ttri.triangulate_dlt(T(x1), T(x2), T(R), T(t)).numpy()
    for b in range(3):
        p_j = np.asarray(Jtri.triangulate_dlt(x1, x2[b], R[b], t[b]))
        np.testing.assert_allclose(p_t[b], p_j, rtol=1e-4, atol=1e-4)


# -------------------------------------------------------------- twoview -----
def _scene(key, n=300, planar=False, noise_px=0.5, f=458.0):
    """tests/test_geometry.py's scenes, drawn with the same jax keys."""
    k1, k2, k3 = jax.random.split(key, 3)
    if planar:
        xy = jax.random.uniform(k1, (n, 2), minval=-3, maxval=3)
        p1 = jnp.concatenate([xy, jnp.full((n, 1), 6.0)], axis=1)
    else:
        p1 = jax.random.uniform(k1, (n, 3), minval=-3, maxval=3) + jnp.array([0, 0, 7.0])
    R21 = Jlie.so3_exp(jnp.array([0.03, -0.15, 0.02]))
    t21 = jnp.array([1.0, 0.1, 0.05])
    p2 = p1 @ R21.T + t21
    x1 = p1[:, :2] / p1[:, 2:] + jax.random.normal(k2, (n, 2)) * noise_px / f
    x2 = p2[:, :2] / p2[:, 2:] + jax.random.normal(k3, (n, 2)) * noise_px / f
    return x1, x2


def _case(name):
    if name == "general":
        x1, x2 = _scene(jax.random.PRNGKey(3))
        return x1, x2, jnp.ones(300, bool), jax.random.PRNGKey(4)
    if name == "planar":
        x1, x2 = _scene(jax.random.PRNGKey(5), planar=True)
        return x1, x2, jnp.ones(300, bool), jax.random.PRNGKey(6)
    if name == "outliers_padded":
        x1, x2 = _scene(jax.random.PRNGKey(7), n=250)
        x2 = x2.at[:50].set(jax.random.uniform(jax.random.PRNGKey(8), (50, 2),
                                               minval=-0.5, maxval=0.5))
        x1 = jnp.concatenate([x1, jnp.zeros((262, 2))])
        x2 = jnp.concatenate([x2, jnp.zeros((262, 2))])
        return x1, x2, jnp.arange(512) < 250, jax.random.PRNGKey(9)
    x1, x2 = _scene(jax.random.PRNGKey(10), noise_px=0.1)
    return x1, x2, jnp.ones(300, bool), jax.random.PRNGKey(11)


@pytest.mark.parametrize("name", ["general", "planar", "outliers_padded", "low_noise"])
def test_two_view_reconstruction(name):
    """Same RANSAC samples in both packages: the reference draws them inside
    reconstruct_two_views with jax.random.categorical(key, ...); the test
    makes the identical draw and hands it to the port's core. Model choice,
    acceptance and the good-point mask agree exactly; the recovered motion
    to 1e-3 (SVDs of different libraries, float32)."""
    x1, x2, mask, key = _case(name)
    res_j = {k: np.asarray(v) for k, v in
             Jtv.reconstruct_two_views(x1, x2, mask, key, 1.0 / 458.0).items()}
    logits = jnp.where(mask, 0.0, -jnp.inf)
    idx = np.asarray(jax.random.categorical(key, logits[None, :], shape=(200, 8)))
    res_t = {k: v.numpy() for k, v in Ttv.reconstruct_two_views(
        T(np.asarray(x1)), T(np.asarray(x2)), T(np.asarray(mask)), T(idx.astype(np.int64)),
        1.0 / 458.0).items()}
    assert bool(res_j["ok"]) and bool(res_t["ok"])
    assert bool(res_t["used_H"]) == bool(res_j["used_H"])
    np.testing.assert_allclose(res_t["R21"], res_j["R21"], atol=1e-3)
    np.testing.assert_allclose(res_t["t21"], res_j["t21"], atol=1e-3)
    np.testing.assert_array_equal(res_t["good"], res_j["good"])
    assert int(res_t["n_good"]) == int(res_j["n_good"])
    good = res_j["good"]
    np.testing.assert_allclose(res_t["points"][good], res_j["points"][good], rtol=1e-3,
                               atol=1e-3)


def test_draw_samples_only_valid_rows():
    mask = torch.arange(512) < 250
    idx = Ttv.draw_samples(mask, 200, torch.Generator().manual_seed(0))
    assert idx.shape == (200, 8) and int(idx.max()) < 250 and int(idx.min()) >= 0
