"""The hand-written row_top2 kernel against its plain version, on the card,
and the loop-closing and relocalization paths that launch it.

These tests need an NVIDIA card (marker `cuda`) and skip without one. The
file imports neither jax nor hfnet_slam_tpu, so it runs on the GPU machine,
which has no jax, without the suite's conftest:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Tolerances: idx and gated match indices exactly; best and second 1e-5
(float32 over <= 256 unit-norm terms, summed in another order).
chip_smoke.py holds the kernel to the same rules at the slice's shapes."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from hfnet_slam_torch.ops import bf_match as B  # noqa: E402
from hfnet_slam_torch.ops import matching as M  # noqa: E402
from hfnet_slam_torch.slam import search as S  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: python -m pytest --noconftest -m cuda "
                    "tests/test_torch_cuda.py on the GPU")
    return torch.device("cuda")


def _unit(g, n, d):
    return torch.nn.functional.normalize(torch.randn(n, d, device="cuda", generator=g), dim=1)


def _problem(NA, NB, D, seed=0):
    """A rows with noisy copies in B, a tenth of B masked."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    A, Bm = _unit(g, NA, D), _unit(g, NB, D)
    n = min(NA, NB) // 4
    Bm[:n] = torch.nn.functional.normalize(
        A[:n] + 0.03 * torch.randn(n, D, device="cuda", generator=g), dim=1)
    return A, Bm, torch.rand(NB, device="cuda", generator=g) > 0.1


def _assert_same(A, Bm, m):
    best, second, idx = B.row_top2(A, Bm, m)
    rb, rs, ri = B.row_top2_reference(A, Bm, m)
    assert torch.equal(idx, ri)
    assert float((best - rb).abs().max()) <= 1e-5
    assert float((second - rs).abs().max()) <= 1e-5
    return best, second, idx


@pytest.mark.parametrize("shape", [(1024, 1024, 256), (1000, 777, 256), (130, 4097, 64),
                                   (1024, 2048, 256), (2048, 1024, 256),
                                   (1024, 4096, 256), (4096, 1024, 256), (1024, 8192, 256),
                                   (37, 1, 16), (100, 300, 13)])
def test_kernel_matches_plain(cuda, shape):
    A, Bm, m = _problem(*shape)
    before = B.launches
    _assert_same(A, Bm, m)
    assert B.launches == before + 1


def test_kernel_takes_a_base_off_16_byte_alignment(cuda):
    """TMA needs a 16-byte-aligned base: the wrapper copies such inputs into
    an aligned buffer and still runs the kernel."""
    A, Bm, m = _problem(1000, 777, 256, seed=3)

    def off_by_4_bytes(x):
        buf = torch.empty(x.numel() + 4, device=cuda)
        off = (1 - buf.data_ptr() // 4) % 4
        y = buf[off:off + x.numel()].view(x.shape)
        y.copy_(x)
        assert y.is_contiguous() and y.data_ptr() % 16 == 4
        return y

    before = B.launches
    _assert_same(off_by_4_bytes(A), off_by_4_bytes(Bm), m)
    assert B.launches == before + 1


def test_kernel_exact_ties_and_all_masked(cuda):
    A, Bm, _ = _problem(512, 700, 256, seed=1)
    Bm[300] = Bm[5]
    Bm[650] = Bm[5]
    A[:3] = Bm[5]
    ones = torch.ones(700, dtype=torch.bool, device=cuda)
    best, second, idx = _assert_same(A, Bm, ones)
    assert int(idx[0]) == 5 and float(best[0]) == float(second[0])
    best, second, idx = _assert_same(A, Bm, ~ones)
    assert bool((best == -1e9).all() & (second == -1e9).all() & (idx == 0).all())


def test_gated_matcher_matches_plain_matcher(cuda):
    A, Bm, mB = _problem(1024, 1024, 256, seed=2)
    mA = torch.rand(1024, device=cuda) > 0.1
    before = B.launches
    iK, dK = S.search_brute_force(A, mA, Bm, mB, max_dist=0.6, ratio=0.9)
    assert B.launches == before + 2  # forward and swapped, for the mutual check
    iP, dP = M.match_descriptors(A, mA, Bm, mB, max_dist=0.6, ratio=0.9, mutual=True)
    assert torch.equal(iK, iP) and int((iK >= 0).sum()) > 100
    assert float((dK - dP).abs().max()) <= 1e-4


def test_kernel_rejects_non_contiguous(cuda):
    A, Bm, m = _problem(64, 64, 32)
    with pytest.raises(ValueError, match="contiguous"):
        B.row_top2(A.t().contiguous().t(), Bm, m)


def test_relocalization_launches_the_kernel(cuda):
    """Tracker._relocalize on the card: retrieval, the brute-force matcher
    against the candidate keyframe (row_top2 both ways at (512,512,64)),
    PnP RANSAC and pose optimization recover a frame of the map."""
    from hfnet_slam_torch.scenes import SMALL, browse_pose, browse_system, reloc_spec
    from hfnet_slam_torch.slam.tracking import Frame

    sys_, ext = browse_system(SMALL, device=cuda, spec=reloc_spec)
    for i in range(40):
        sys_.track_features(ext(*browse_pose(i)), 0.05 * i)
    before = B.shape_launches[(512, 512, 64)]
    frame = Frame(feats=ext(*browse_pose(30)), timestamp=99.0)
    assert sys_.tracker._relocalize(frame)
    assert sys_.tracker.n_relocalizations == 1 and int((frame.obs >= 0).sum()) >= 30
    assert B.shape_launches[(512, 512, 64)] >= before + 2


def test_loop_circuit_corrects_through_the_kernel(cuda):
    """The SMALL loop circuit on the card until its first correction: loop
    association launches row_top2 at the window width, both ways."""
    from hfnet_slam_torch.scenes import LOOP_SMALL, loop_system, ring_pose

    sys_, ext = loop_system(LOOP_SMALL, device=cuda)
    win = LOOP_SMALL["loop"]["window_mp_cap"]
    before = B.shape_launches[(512, win, 64)], B.shape_launches[(win, 512, 64)]
    n = LOOP_SMALL["frames"]
    for i in range(n):
        sys_.track_features(ext(*ring_pose(i, n, LOOP_SMALL["total_angle"])), 0.05 * i)
        if sys_.loop_closer.stats["corrected"]:
            break
    assert sys_.loop_closer.stats["corrected"] == 1, sys_.loop_closer.stats
    assert B.shape_launches[(512, win, 64)] > before[0]
    assert B.shape_launches[(win, 512, 64)] > before[1]
    store = sys_.store
    assert store._device_map.pos.device.type == "cuda"
    assert torch.isfinite(torch.from_numpy(store.kf_t[store.kf_valid])).all()
