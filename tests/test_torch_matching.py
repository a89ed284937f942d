"""Parity of the port's matchers with the JAX reference (port on the CPU),
and the CPU routing of the brute-force matcher.

Tolerances: match indices and masks exactly; similarities and distances
1e-5 (float32 over <= 256 unit-norm terms summed in another order)."""
import numpy as np
import pytest

import jax.numpy as jnp

from hfnet_slam_tpu.ops import matching as JM
from hfnet_slam_tpu.ops import pallas_match as JPM
from hfnet_slam_tpu.slam import search as JS

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from hfnet_slam_torch.ops import bf_match as TB  # noqa: E402
from hfnet_slam_torch.ops import matching as TM  # noqa: E402
from hfnet_slam_torch.slam import search as TS  # noqa: E402


def T(x):
    return torch.from_numpy(np.array(x))


def _problem(seed=0, NA=256, NB=512, D=128, dup=100, noise=0.02):
    """tests/test_pallas_match.py's problem: A rows with noisy copies in B."""
    rng = np.random.default_rng(seed)
    dA = rng.standard_normal((NA, D)).astype(np.float32)
    dA /= np.linalg.norm(dA, axis=1, keepdims=True)
    dB = rng.standard_normal((NB, D)).astype(np.float32)
    dup = min(dup, NA, NB)
    dB[:dup] = dA[:dup] + noise * rng.standard_normal((dup, D))
    dB /= np.linalg.norm(dB, axis=1, keepdims=True)
    maskA = np.ones(NA, bool)
    maskA[-16:] = False
    maskB = np.ones(NB, bool)
    maskB[10:20] = False
    return dA, maskA, dB, maskB


def _kp(seed, n):
    rng = np.random.default_rng(seed)
    xy = rng.uniform([0, 0], [640, 480], (n, 2)).astype(np.float32)
    octv = rng.integers(0, 4, n).astype(np.int32)
    return xy, octv


# ------------------------------------------------------ match_descriptors ---
@pytest.mark.parametrize("helper", ["none", "window", "radius", "octave"])
@pytest.mark.parametrize("ratio", [1.0, 0.9])
def test_match_descriptors_with_allowed(helper, ratio):
    dA, maskA, dB, maskB = _problem(1, NA=300, NB=300, D=64, dup=250, noise=0.05)
    xyA, oA = _kp(2, 300)
    xyB = xyA + np.random.default_rng(3).normal(0, 8, xyA.shape).astype(np.float32)
    oB = oA.copy()
    oB[::7] += 2
    if helper == "none":
        a_j = a_t = None
    elif helper == "window":
        a_j, a_t = JM.window_allowed(xyA, xyB, 15.0), TM.window_allowed(T(xyA), T(xyB), 15.0)
    elif helper == "radius":
        r = np.full(300, 12.0, np.float32) * 1.2 ** oA
        a_j, a_t = JM.radius_allowed(xyA, xyB, r), TM.radius_allowed(T(xyA), T(xyB), T(r))
    else:
        a_j, a_t = JM.octave_allowed(oA, oB), TM.octave_allowed(T(oA), T(oB))
    if a_j is not None:
        np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    i_j, d_j = JM.match_descriptors(dA, maskA, dB, maskB, max_dist=0.6, ratio=ratio,
                                    mutual=True, allowed=a_j)
    i_t, d_t = TM.match_descriptors(T(dA), T(maskA), T(dB), T(maskB), max_dist=0.6,
                                    ratio=ratio, mutual=True, allowed=a_t)
    assert int((np.asarray(i_j) >= 0).sum()) > 20
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-5)


def test_distinctive_descriptors():
    rng = np.random.default_rng(4)
    descs = rng.standard_normal((64, 8, 32)).astype(np.float32)
    descs /= np.linalg.norm(descs, axis=2, keepdims=True)
    mask = rng.uniform(size=(64, 8)) > 0.3
    mask[0] = False  # a point with no valid observation
    np.testing.assert_array_equal(TM.distinctive_descriptors(T(descs), T(mask)).numpy(),
                                  np.asarray(JM.distinctive_descriptors(descs, mask)))


def test_argmax_ties_take_the_first_index():
    """The tie rule every matcher relies on (jnp.argmax and torch.argmax both
    return the first maximal index)."""
    S = np.array([[0.5, 0.9, 0.9, 0.1], [0.3, 0.3, 0.3, 0.3]], np.float32)
    assert torch.argmax(T(S), 1).tolist() == np.asarray(jnp.argmax(S, 1)).tolist() == [1, 0]
    best_idx, best, second = TM._top2(T(S))
    assert best_idx.tolist() == [1, 0]
    np.testing.assert_array_equal(second.numpy(), best.numpy())  # exact tie: second == best


# ------------------------------------------- brute-force kernel, plain path ---
def test_row_top2_plain_matches_pallas_dense():
    dA, maskA, dB, maskB = _problem()
    b_j, s_j, i_j = JPM.row_top2(jnp.asarray(dA), jnp.asarray(dB), jnp.asarray(maskB),
                                 interpret=True)
    b_t, s_t, i_t = TB.row_top2_reference(T(dA), T(dB), T(maskB))
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), atol=1e-5)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=1e-5)


def test_fused_plain_matches_pallas_and_xla():
    dA, maskA, dB, maskB = _problem()
    i_x, d_x = JM.match_descriptors(dA, maskA, dB, maskB, max_dist=0.6, ratio=0.9, mutual=True)
    i_p, d_p = JPM.match_descriptors_fused(jnp.asarray(dA), jnp.asarray(maskA), jnp.asarray(dB),
                                           jnp.asarray(maskB), max_dist=0.6, ratio=0.9,
                                           interpret=True)
    i_t, d_t = TB.match_descriptors_fused(T(dA), T(maskA), T(dB), T(maskB), max_dist=0.6,
                                          ratio=0.9)
    assert (i_t.numpy() >= 0).sum() > 50
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_p))
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_x))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_p), atol=1e-5)


def test_all_masked_B_yields_no_matches():
    dA, maskA, dB, _ = _problem()
    i_t, _ = TB.match_descriptors_fused(T(dA), T(maskA), T(dB), torch.zeros(len(dB), dtype=torch.bool))
    assert (i_t.numpy() == -1).all()
    best, second, idx = TB.row_top2(T(dA), T(dB), torch.zeros(len(dB), dtype=torch.bool))
    assert (best.numpy() == -1e9).all() and (second.numpy() == -1e9).all()
    assert (idx.numpy() == 0).all()


@pytest.mark.parametrize("shape", [(1000, 777, 256), (130, 409, 64), (37, 1, 16), (5, 3, 256)])
def test_plain_matches_reference_at_unaligned_shapes(shape):
    NA, NB, D = shape
    dA, maskA, dB, maskB = _problem(5, NA=NA, NB=NB, D=D, dup=min(NA, NB) // 2)
    i_j, d_j = JM.match_descriptors(dA, maskA, dB, maskB, max_dist=0.6, ratio=0.9, mutual=True)
    i_t, d_t = TB.match_descriptors_fused(T(dA), T(maskA), T(dB), T(maskB), max_dist=0.6,
                                          ratio=0.9)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-5)
    b_t, s_t, ix_t = TB.row_top2_reference(T(dA), T(dB), T(maskB))
    S = np.where(maskB[None, :], dA @ dB.T, -1e9)
    np.testing.assert_array_equal(ix_t.numpy(), S.argmax(1))
    np.testing.assert_allclose(b_t.numpy(), S.max(1), atol=1e-5)


def test_plain_matches_reference_on_exact_ties():
    """Duplicate B rows give exact similarity ties: the lowest index wins
    and second == best, in both packages."""
    dA, maskA, dB, maskB = _problem(6, NA=64, NB=200, D=64, dup=40)
    dB[150] = dB[3]
    dB[170] = dB[3]
    dA[0] = dB[3]
    maskB[:] = True
    b_j, s_j, i_j = JPM.row_top2(jnp.asarray(np.pad(dA, ((0, 64), (0, 64)))),
                                 jnp.asarray(np.pad(dB, ((0, 56), (0, 64)))),
                                 jnp.asarray(np.pad(maskB, (0, 56))), interpret=True)
    b_t, s_t, i_t = TB.row_top2(T(dA), T(dB), T(maskB))
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j)[:64])
    assert int(i_t[0]) == 3 and float(s_t[0]) == float(b_t[0])
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j)[:64], atol=1e-5)
    i_x, _ = JM.match_descriptors(dA, maskA, dB, maskB, max_dist=0.6, ratio=1.0, mutual=True)
    i_f, _ = TB.match_descriptors_fused(T(dA), T(maskA), T(dB), T(maskB), max_dist=0.6)
    np.testing.assert_array_equal(i_f.numpy(), np.asarray(i_x))


def test_search_brute_force_routes_cpu_tensors_to_the_plain_version():
    dA, maskA, dB, maskB = _problem(7)
    before = TB.launches
    i_t, d_t = TS.search_brute_force(T(dA), T(maskA), T(dB), T(maskB), max_dist=0.6, ratio=0.9)
    assert TB.launches == before  # no kernel launch for a CPU tensor
    i_j, d_j = JS.search_brute_force(jnp.asarray(dA), jnp.asarray(maskA), jnp.asarray(dB),
                                     jnp.asarray(maskB), max_dist=0.6, ratio=0.9)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-5)


def test_row_top2_rejects_bad_inputs():
    a = torch.zeros(4, 8)
    with pytest.raises(ValueError):
        TB.row_top2(a, torch.zeros(4, 7), torch.ones(4, dtype=torch.bool))
    with pytest.raises(TypeError):
        TB.row_top2(a.double(), a.double(), torch.ones(4, dtype=torch.bool))
    with pytest.raises(ValueError):
        TB.row_top2(a, a, torch.ones(4))


def test_tma_ready_copies_only_what_tma_cannot_read():
    """The kernel's TMA loads need a 16-byte-aligned base and rows of a
    multiple of 4 floats; other inputs go through one zero-padded copy."""
    buf = torch.arange(1 + 8 * 13, dtype=torch.float32)
    x = buf[:8 * 12].view(8, 12)  # aligned, D % 4 == 0: used as it is
    assert x.data_ptr() % 16 == 0 and TB._tma_ready(x, 12) is x
    for y, ld in [(buf[1:1 + 8 * 12].view(8, 12), 12),  # base 4 bytes past alignment
                  (buf[:8 * 13].view(8, 13), 16)]:      # D = 13
        z = TB._tma_ready(y, ld)
        assert z.shape == (8, ld) and z.data_ptr() % 16 == 0 and z.is_contiguous()
        assert torch.equal(z[:, :y.shape[1]], y) and not z[:, y.shape[1]:].any()


# -------------------------------------------------------------- searches ---
def test_search_by_projection_and_initialization():
    rng = np.random.default_rng(9)
    from hfnet_slam_tpu import lie as Jlie
    from hfnet_slam_tpu.geometry import cameras as Jcam
    from hfnet_slam_torch.geometry import cameras as Tcam

    cj = Jcam.pinhole(450.0, 450.0, 320.0, 240.0, 640, 480)
    ct = Tcam.pinhole(450.0, 450.0, 320.0, 240.0, 640, 480, device="cpu")
    n = 400
    pts = (rng.uniform(-4, 4, (n, 3)) + [0, 0, 9]).astype(np.float32)
    desc = rng.standard_normal((n, 64)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    R = np.asarray(Jlie.so3_exp(np.array([0.01, -0.02, 0.0], np.float32)))
    t = np.array([0.1, 0.0, 0.05], np.float32)
    uv = np.asarray(cj.project(pts @ R.T + t)) + rng.normal(0, 1.0, (n, 2)).astype(np.float32)
    fdesc = desc + 0.05 * rng.standard_normal(desc.shape).astype(np.float32)
    fdesc /= np.linalg.norm(fdesc, axis=1, keepdims=True)
    octv = rng.integers(0, 3, n).astype(np.int32)
    fmask = np.ones(n, bool)
    mp_valid = np.ones(n, bool)
    mp_valid[::9] = False
    normal = (pts / np.linalg.norm(pts, axis=1, keepdims=True)).astype(np.float32)
    dmin = np.full(n, 1.0, np.float32)
    dmax = np.full(n, 20.0, np.float32)
    out_j = JS.search_by_projection(cj.kind, cj.params, (640, 480), R, t, pts, desc, mp_valid,
                                    uv, fdesc, octv, fmask, radius=4.0, max_dist=0.75,
                                    mp_normal=normal, mp_dmin=dmin, mp_dmax=dmax)
    out_t = TS.search_by_projection(ct.kind, ct.params, (640, 480), T(R), T(t), T(pts), T(desc),
                                    T(mp_valid), T(uv), T(fdesc), T(octv), T(fmask), radius=4.0,
                                    max_dist=0.75, mp_normal=T(normal), mp_dmin=T(dmin),
                                    mp_dmax=T(dmax))
    assert int((np.asarray(out_j[0]) >= 0).sum()) > 200
    np.testing.assert_array_equal(out_t[0].numpy(), np.asarray(out_j[0]))
    np.testing.assert_array_equal(out_t[2].numpy(), np.asarray(out_j[2]))
    i_j, _ = JS.search_for_initialization(uv, fdesc, fmask, uv + 3.0, desc, mp_valid)
    i_t, _ = TS.search_for_initialization(T(uv), T(fdesc), T(fmask), T(uv + 3.0), T(desc),
                                          T(mp_valid))
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
