"""Parity of the port's synthetic RGB-D world (hfnet_slam_torch/models/synth.py)
with the JAX reference's (hfnet_slam_tpu/models/synth.py), on the CPU.

  * texture, blob corners, ray grid, images and depths: bit-equal (the same
    float64 numpy on both sides);
  * correspondences and corner_cells project through each package's camera
    (float32 torch against float32 jnp): uv within TOL_UV px; ok-masks and
    cell classes equal except for points within TOL_EDGE px of a margin or a
    cell edge, which may land on the other side and are counted;
  * tests/test_selftrain.py's three world checks on the port's world.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from hfnet_slam_tpu.geometry import cameras as JC  # noqa: E402
from hfnet_slam_tpu.models.synth import CylinderWorld as JWorld  # noqa: E402
from hfnet_slam_torch.geometry import cameras as TC  # noqa: E402
from hfnet_slam_torch.models.synth import CylinderWorld as TWorld  # noqa: E402

TOL_UV = 1e-4    # px: float32 projection evaluated in another order
TOL_EDGE = 1e-3  # px: a point this close to a boundary may fall either way
CAM = (112.0, 112.0, 80.0, 64.0, 160, 128)  # tests/test_selftrain.py's camera


@pytest.fixture(scope="module")
def worlds():
    return (JWorld(JC.pinhole(*CAM), n_blobs=900, seed=5),
            TWorld(TC.pinhole(*CAM, device="cpu"), n_blobs=900, seed=5))


def _bits_equal(a, b):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


def test_texture_corners_and_rays_are_bit_equal(worlds):
    ref, port = worlds
    _bits_equal(ref.tex, port.tex)
    _bits_equal(ref.corners3d, port.corners3d)
    _bits_equal(ref._rays, port._rays)


@pytest.mark.parametrize("i", [0, 7, 41, 120])
def test_renders_and_poses_are_bit_equal(worlds, i):
    ref, port = worlds
    for a, b in zip(ref.orbit_pose(i), port.orbit_pose(i)):
        _bits_equal(a, b)
    for a, b in zip(ref.render_rgbd(*ref.orbit_pose(i)), port.render_rgbd(*port.orbit_pose(i))):
        _bits_equal(a, b)


def _edge_dist(x, lo, hi):
    return np.minimum(np.abs(x - lo), np.abs(x - hi))


@pytest.mark.parametrize("pair", [(0, 4), (3, 9), (20, 22)])
def test_correspondences_match_within_tolerance(worlds, pair):
    ref, port = worlds
    ia, ib = pair
    pa, pb = ref.orbit_pose(ia), ref.orbit_pose(ib)
    _, da = ref.render_rgbd(*pa)
    ua_r, ub_r = ref.correspondences(pa, pb, da, 400, np.random.default_rng(ia))
    ua_p, ub_p = port.correspondences(pa, pb, da, 400, np.random.default_rng(ia))
    key_r = {tuple(u): v for u, v in zip(ua_r.tolist(), ub_r)}
    key_p = {tuple(u): v for u, v in zip(ua_p.tolist(), ub_p)}
    common = key_r.keys() & key_p.keys()
    assert len(common) > 200
    err = max(float(np.abs(key_r[k] - key_p[k]).max()) for k in common)
    assert err <= TOL_UV, err
    # a point kept by one package only must sit on the margin's edge
    H, W = da.shape
    flips = [key_r.get(k, key_p.get(k)) for k in key_r.keys() ^ key_p.keys()]
    for uv in flips:
        d = min(_edge_dist(uv[0], 16, W - 16), _edge_dist(uv[1], 16, H - 16))
        assert d <= TOL_EDGE, (uv, d)
    print(f"pair {pair}: {len(common)} shared, {len(flips)} on a margin edge, max err {err}")


@pytest.mark.parametrize("i", [0, 3, 17, 60])
def test_corner_cells_match_within_tolerance(worlds, i):
    ref, port = worlds
    R, t = ref.orbit_pose(i)
    tgt_r, tgt_p = ref.corner_cells(R, t), port.corner_cells(R, t)
    pc = ref.corners3d @ np.asarray(R).T + np.asarray(t)
    uv_r = np.array(ref.cam.project(jnp.asarray(pc)))
    uv_p = port._project(pc)
    vis = pc[:, 2] > 0.5
    assert np.abs(uv_r[vis] - uv_p[vis]).max() <= TOL_UV
    differ = np.argwhere(tgt_r != tgt_p)
    # every differing cell holds a corner within TOL_EDGE of a cell or image edge
    near = np.minimum(np.abs(uv_p - np.round(uv_p / 8) * 8).min(1), 1e9)
    for cy, cx in differ:
        inside = vis & (np.floor(uv_p[:, 0] / 8) == cx) & (np.floor(uv_p[:, 1] / 8) == cy)
        inside |= vis & (np.floor(uv_r[:, 0] / 8) == cx) & (np.floor(uv_r[:, 1] / 8) == cy)
        assert inside.any() and near[inside].min() <= TOL_EDGE, (cy, cx)
    print(f"frame {i}: {int((tgt_p < 64).sum())} corner cells, {len(differ)} on an edge")


# -- tests/test_selftrain.py's world checks, on the port ----------------------

def test_port_depth_is_exact(worlds):
    port = worlds[1]
    img, dep = port.render_rgbd(*port.orbit_pose(7))
    assert img.shape == (128, 160) and dep.shape == (128, 160)
    assert np.all(dep > 0.5) and np.all(dep < 40.0)
    px = port.cam.params.numpy()
    u, v = 83.0, 61.0
    z = dep[int(v), int(u)]
    pc = np.array([(u - px[2]) / px[0] * z, (v - px[3]) / px[1] * z, z], np.float32)
    np.testing.assert_allclose(port._project(pc[None])[0], [u, v], atol=1e-3)


def test_port_correspondences_are_consistent(worlds):
    port = worlds[1]
    pa, pb = port.orbit_pose(0), port.orbit_pose(4)
    ia, da = port.render_rgbd(*pa)
    ib, _ = port.render_rgbd(*pb)
    ua, ub = port.correspondences(pa, pb, da, 200, np.random.default_rng(0))
    assert len(ua) > 120
    va = ia[ua[:, 1].astype(int), ua[:, 0].astype(int)]
    vb = ib[ub[:, 1].astype(int), ub[:, 0].astype(int)]
    assert np.median(np.abs(va - vb)) < 12.0


def test_port_corner_cells_shape_and_hits(worlds):
    port = worlds[1]
    tgt = port.corner_cells(*port.orbit_pose(3))
    assert tgt.shape == (128 // 8, 160 // 8)
    assert 5 < int((tgt < 64).sum()) < tgt.size
