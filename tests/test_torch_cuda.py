"""The hand-written row_top2 kernel against its plain version, on the card
(from one thread and from two at once, as the async pipeline calls it), the
loop-closing and relocalization paths that launch it, and the HF-Net
extractor and its prefetch pipeline on the card.

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


def test_kernel_from_two_threads_at_one_shape(cuda):
    """The async pipeline launches row_top2 from the loop worker while the
    tracker launches it too: both threads on the default stream share one
    cached plan (scratch and merge tickets) per shape, which is safe because
    the stream orders their launches. Two threads, 200 calls each at the
    loop-association shape, each on its own inputs: every idx equals the
    plain version, and every launch is counted on its thread."""
    import threading

    shape = (1024, 2048, 256)
    B.reset_counts()
    errs, bad = [], []

    def run(seed):
        try:
            A, Bm, m = _problem(*shape, seed=seed)
            _, _, ri = B.row_top2_reference(A, Bm, m)
            for _ in range(200):
                _, _, idx = B.row_top2(A, Bm, m)
                if not torch.equal(idx, ri):
                    bad.append(int((idx != ri).sum()))
        except Exception as e:  # pragma: no cover - failure path
            errs.append(e)

    ths = [threading.Thread(target=run, args=(s,), name=f"t{s}") for s in (1, 2)]
    for th in ths:
        th.start()
    for th in ths:
        th.join(timeout=120)
    torch.cuda.synchronize()
    assert not errs, errs
    assert not bad, f"{len(bad)} calls gave idx differing from the plain version"
    assert B.shape_launches[shape] == 400
    assert B.thread_shape_launches[("t1",) + shape] == 200
    assert B.thread_shape_launches[("t2",) + shape] == 200


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


def _small_extractors(cuda):
    """HF-Net with seeded random weights, at tests/test_hfnet.py's extractor
    config, on the card and on the CPU."""
    from hfnet_slam_torch.models.extractor import HFExtractor
    from hfnet_slam_torch.models.hfnet import HFNet

    net = HFNet(torch.Generator().manual_seed(0))
    kw = dict(n_features=200, threshold=1e-5, pad_to=256)
    return HFExtractor(net, (96, 128), device=cuda, **kw), HFExtractor(net, (96, 128),
                                                                        device="cpu", **kw)


def _image(seed, hw=(96, 128)):
    import numpy as np

    return np.random.default_rng(seed).uniform(0, 255, hw).astype(np.float32)


def test_extractor_on_the_card_matches_the_cpu(cuda):
    """The card's extraction against the same code on the CPU, with the CPU
    parity tests' tolerances: >= 99% of slots with the same mask and xy
    (1e-3 px); descriptors, scores and the global descriptor within 1e-4."""
    ext, ext_cpu = _small_extractors(cuda)
    f, g = ext(_image(4)), ext_cpu(_image(4))
    assert all(x.device.type == "cuda" for x in f)
    f = f.to("cpu")
    same = (f.mask == g.mask) & ((f.xy - g.xy).abs().amax(1) <= 1e-3)
    assert float(same.float().mean()) >= 0.99
    ok = same & g.mask
    assert int(ok.sum()) > 100
    assert float((f.desc - g.desc)[ok].abs().max()) <= 1e-4
    assert float((f.score - g.score)[ok].abs().max()) <= 1e-4
    assert float((f.global_desc - g.global_desc).abs().max()) <= 1e-4


def test_extractor_uses_a_net_already_on_the_card(cuda):
    """Weights drawn on the card live on cuda:0; an extractor asked for
    "cuda" (device=None) serves them as they are, without a copy."""
    from hfnet_slam_torch.models.extractor import HFExtractor
    from hfnet_slam_torch.models.hfnet import HFNet

    net = HFNet(torch.Generator(device=cuda).manual_seed(0))
    assert next(net.parameters()).device.type == "cuda"
    assert HFExtractor(net, (96, 128), n_features=200, pad_to=256).net is net


def test_extractor_is_deterministic_on_the_card(cuda):
    ext, _ = _small_extractors(cuda)
    a, b = ext(_image(5)), ext(_image(5))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_pipeline_hands_features_over_between_streams(cuda):
    """pipeline_frames extracts on a stream of its own; what the consumer
    receives equals a direct call, frame by frame."""
    from hfnet_slam_torch.utils.prefetch import pipeline_frames

    ext, _ = _small_extractors(cuda)
    frames = [_image(s) for s in range(6)]
    streams = []

    def extract(img):
        streams.append(torch.cuda.current_stream())
        return ext(img)

    got = list(pipeline_frames(extract, frames, lookahead=2))
    consumer = torch.cuda.current_stream()
    assert streams and all(s != consumer for s in streams)
    for img, feats in got:
        # the consumer's stream uses the tensors, then drops them
        s = (feats.desc @ feats.desc.T).sum()
        assert all(torch.equal(x, y) for x, y in zip(feats, ext(img)))
        assert torch.isfinite(s)


def test_pipeline_waits_for_frames_the_consumer_stream_writes(cuda):
    """Frames made on the consumer's stream behind a busy spell (a sleep
    kernel, then an upload from pinned memory and an in-place add) and
    dropped by the producer right after the handover: the worker must wait
    for them and their memory must not be reused under it. The sleep
    outlasts the host's handover, so a worker that did not wait would read
    the frame before it is written."""
    from hfnet_slam_torch.utils.prefetch import pipeline_frames

    ext, _ = _small_extractors(cuda)
    images = [_image(s) for s in range(6)]
    hosts = [torch.from_numpy(img).pin_memory() for img in images]  # pinned up front

    def frames():
        for host in hosts:
            torch.cuda._sleep(200_000_000)  # ~0.1 s of the consumer's stream
            x = torch.empty(host.shape, device=cuda)
            x.copy_(host, non_blocking=True)
            x.add_(1.0)
            yield x

    got = [feats for _, feats in pipeline_frames(ext, frames(), lookahead=1)]
    for img, feats in zip(images, got):
        assert all(torch.equal(x, y) for x, y in zip(feats, ext(img + 1.0)))
