"""The hand-written row_top2 kernel against its plain version, on the card
(from one thread and from two at once, as the async pipeline calls it), the
loop-closing and relocalization paths that launch it, the HF-Net
extractor and its prefetch pipeline on the card, and the visual-inertial
solvers on the card against the same code on the CPU, and the stereo /
RGB-D path (the rectified stereo association, the depth lookup, the rig BA
with right-camera edges) on the card against the CPU.

These tests need an NVIDIA card (marker `cuda`) and skip without one. The
file imports neither jax nor hfnet_slam_tpu, so it runs on the GPU machine,
which has no jax, without the suite's conftest:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Tolerances: idx and gated match indices exactly; best and second 1e-5
(float32 over <= 256 unit-norm terms, summed in another order).
chip_smoke.py holds the kernel to the same rules at the slice's shapes.
Visual-inertial: preintegration and the per-frame VI solve within 1e-4 of
the CPU, inlier masks exactly; vi_ba_iterate's masks exactly and its states
within 1e-3 (index_add_ accumulates with atomics on the card). Stereo: the
association's matched columns exactly and its depths within 1e-5 relative;
the depth lookup exactly; the rig BA's edge validity exactly and its poses
and points within 1e-3."""
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


# ---------------------------------------------------------------------------
# visual-inertial solvers: the card against the CPU
# ---------------------------------------------------------------------------

def _imu_block(seed, n=60, dt=0.005):
    import numpy as np

    rng = np.random.default_rng(seed)
    meas = np.zeros((n, 7), np.float32)
    meas[:, :3] = rng.normal(0, 1.0, (n, 3)) + np.array([0.0, 0.0, 9.81])
    meas[:, 3:6] = rng.normal(0, 0.4, (n, 3))
    meas[:, 6] = dt
    mask = rng.random(n) > 0.2
    return torch.from_numpy(meas), torch.from_numpy(mask)


def _both(x, cuda):
    return x, x.to(cuda)


def _close(a, b, tol, what):
    err = float((a.cpu().double() - b.cpu().double()).abs().max())
    assert err <= tol * max(float(b.abs().max()), 1.0), f"{what}: {err}"


def test_preintegration_on_the_card_matches_the_cpu(cuda):
    from hfnet_slam_torch.geometry import imu as IMU

    meas, mask = _imu_block(0)
    calib = IMU.default_calib()
    bg, ba = torch.tensor([0.01, -0.02, 0.005]), torch.tensor([0.05, 0.0, -0.02])
    p_cpu = IMU.integrate(meas, mask, calib, bg, ba)
    rows0 = IMU.rows_integrated
    p_gpu = IMU.integrate(meas.to(cuda), mask.to(cuda), calib, bg.to(cuda), ba.to(cuda))
    assert IMU.rows_integrated - rows0 == int(mask.sum())
    assert p_gpu.dR.device.type == "cuda"
    for f in IMU.Preintegrated._fields:
        _close(getattr(p_gpu, f), getattr(p_cpu, f), 1e-4, f)


def _vi_pose_problem(seed):
    """An anchor state, a perturbed current guess and 256 observations of a
    point cloud, 20 of them outliers (CPU tensors)."""
    import numpy as np

    from hfnet_slam_torch import lie
    from hfnet_slam_torch.geometry import cameras
    from hfnet_slam_torch.geometry import imu as IMU
    from hfnet_slam_torch.optim import inertial as VI

    rng = np.random.default_rng(seed)
    cam = cameras.pinhole(450.0, 450.0, 320.0, 240.0, 640, 480, device="cpu")
    R1 = lie.so3_exp(torch.tensor([0.05, -0.1, 0.2]))
    p1, v1 = torch.tensor([0.3, -0.1, 0.0]), torch.tensor([0.4, 0.1, -0.2])
    meas, mask = _imu_block(seed, n=10)
    pre = IMU.integrate(meas, torch.ones(10, dtype=torch.bool), IMU.default_calib(),
                        torch.zeros(3), torch.zeros(3))
    R2, p2, v2 = IMU.predict_state(R1, p1, v1, torch.zeros(3), torch.zeros(3), pre)
    pts = torch.tensor(rng.uniform(-4, 4, (256, 3)) + [0, 0, 8], dtype=torch.float32)
    R_cw, t_cw = VI.body_to_cam(R2, p2, torch.eye(3), torch.zeros(3))
    uv = cam.project(pts @ R_cw.T + t_cw) + torch.tensor(rng.normal(0, 0.3, (256, 2)),
                                                         dtype=torch.float32)
    uv[:20] += 30.0
    guess = (R2 @ lie.so3_exp(torch.tensor([0.02, -0.01, 0.03])),
             p2 + torch.tensor([0.05, -0.03, 0.02]), v2 + 0.1)
    z3 = torch.zeros(3)
    return cam, (R1, p1, v1, z3, z3), pre, guess, (pts, uv, torch.ones(256),
                                                   torch.ones(256, dtype=torch.bool))


@pytest.mark.parametrize("marg", [False, True])
def test_pose_inertial_optimize_on_the_card_matches_the_cpu(cuda, marg):
    from hfnet_slam_torch.optim import inertial as VI

    cam, anchor, pre, guess, obs = _vi_pose_problem(1)

    def run(dev):
        c = cam.to(dev)
        mv = [x.to(dev) for x in (torch.eye(3), torch.zeros(3))]
        a = [x.to(dev) for x in anchor]
        g = [x.to(dev) for x in guess]
        o = [x.to(dev) for x in obs]
        p = pre.to(dev)
        if not marg:
            return VI.pose_inertial_optimize(c.kind, c.params, *mv, *a, p, *g, *o)
        H = VI.pose_inertial_optimize(c.kind, c.params, *mv, *a, p, *g, *o)["H"]
        return VI.pose_inertial_optimize_marg(c.kind, c.params, *mv, *a, H, p, *g, *o)

    r_cpu, r_gpu = run("cpu"), run(cuda)
    assert r_gpu["R"].device.type == "cuda"
    assert torch.equal(r_gpu["inlier"].cpu(), r_cpu["inlier"])
    for k in ("R", "p", "v", "bg", "ba"):
        _close(r_gpu[k], r_cpu[k], 1e-4, k)


def test_minimum_norm_lstsq_on_the_card(cuda):
    """A rank-deficient system (two dependent column pairs): the SVD
    replacement gives the minimum-norm solution on the card, where
    torch.linalg.lstsq's CUDA driver (gels) assumes full rank."""
    import numpy as np

    from hfnet_slam_torch.optim import inertial as VI

    rng = np.random.default_rng(0)
    A = rng.normal(size=(30, 8))
    A[:, 5] = A[:, 1] + A[:, 2]
    A[:, 7] = 2.0 * A[:, 3]
    b = rng.normal(size=30)
    want = np.linalg.lstsq(A, b, rcond=None)[0]  # minimum norm, float64
    At = torch.tensor(A, dtype=torch.float32, device=cuda)
    x = VI.lstsq_min_norm(At, torch.tensor(b, dtype=torch.float32, device=cuda)[:, None])
    np.testing.assert_allclose(x[:, 0].cpu().numpy(), want, atol=1e-4)


def test_vi_ba_iterate_on_the_card_matches_the_cpu(cuda):
    """Six keyframes on a simulated inertial chain, 80 landmarks seen by all
    of them, 20 observations corrupted: the card's LM against the CPU's."""
    import numpy as np

    from hfnet_slam_torch import lie
    from hfnet_slam_torch.geometry import cameras
    from hfnet_slam_torch.geometry import imu as IMU
    from hfnet_slam_torch.optim import inertial as VI
    from hfnet_slam_torch.optim import vi_ba

    rng = np.random.default_rng(3)
    cam = cameras.pinhole(458.0, 457.0, 367.0, 248.0, 752, 480, device="cpu")
    n_kf, m, steps, dt = 6, 80, 60, 0.005
    grav = torch.tensor(IMU.GRAVITY_VEC)
    R, p, v = torch.eye(3), torch.zeros(3), torch.zeros(3)
    Rs, ps, vs, pres = [R], [p], [v], []
    for link in range(n_kf - 1):
        meas = torch.zeros((steps, 7))
        for i in range(steps):
            t = (link * steps + i) * dt
            w = torch.tensor([0.05 * np.sin(t), 0.1, 0.08 * np.cos(2 * t)], dtype=torch.float32)
            a_w = torch.tensor([0.6 * np.cos(t), 0.5 * np.sin(1.3 * t), 0.3 * np.cos(0.7 * t)],
                               dtype=torch.float32)
            meas[i, :3] = R.T @ (a_w - grav)
            meas[i, 3:6] = w
            meas[i, 6] = dt
            p = p + v * dt + 0.5 * a_w * dt * dt
            v = v + a_w * dt
            R = R @ lie.so3_exp(w * dt)
        pres.append(IMU.integrate(meas, torch.ones(steps, dtype=torch.bool),
                                  IMU.default_calib(), torch.zeros(3), torch.zeros(3)))
        Rs.append(R)
        ps.append(p)
        vs.append(v)
    pts = torch.tensor(rng.uniform(-4, 4, (m, 3)) + [0, 0, 9], dtype=torch.float32)
    uv = []
    for k in range(n_kf):
        R_cw, t_cw = VI.body_to_cam(Rs[k], ps[k], torch.eye(3), torch.zeros(3))
        uv.append(cam.project(pts @ R_cw.T + t_cw))
    uv = torch.cat(uv) + torch.tensor(rng.normal(0, 0.3, (n_kf * m, 2)), dtype=torch.float32)
    uv[:20] += 60.0
    E = n_kf * m
    xi = torch.tensor(rng.normal(0, 0.01, (n_kf, 6)), dtype=torch.float32)
    xi[0] = 0.0
    prob = vi_ba.VIBAProblem(
        R_wb=torch.stack(Rs) @ lie.so3_exp(xi[:, :3]), p_wb=torch.stack(ps) + xi[:, 3:],
        v=torch.stack(vs), bg=torch.zeros((n_kf, 3)), ba=torch.zeros((n_kf, 3)),
        fixed=torch.zeros(n_kf, dtype=torch.bool), fix_pose_only=torch.arange(n_kf) == 0,
        points=pts + torch.tensor(rng.normal(0, 0.03, (m, 3)), dtype=torch.float32),
        Tbc_R=torch.eye(3), Tbc_t=torch.zeros(3),
        kf_idx=torch.arange(n_kf).repeat_interleave(m), pt_idx=torch.arange(m).repeat(n_kf),
        uv=uv, inv_sigma2=torch.ones(E), valid=torch.ones(E, dtype=torch.bool),
        z_meas=torch.zeros(E), wz=torch.zeros(E), li=torch.arange(n_kf - 1),
        lj=torch.arange(1, n_kf), pre=IMU.stack(pres),
        lvalid=torch.ones(n_kf - 1, dtype=torch.bool), prior_g=torch.tensor(0.0),
        prior_a=torch.tensor(0.0))

    def on(dev):
        return vi_ba.VIBAProblem(*(x.to(dev) if torch.is_tensor(x) else x.to(dev)
                                   for x in prob))

    rounds = ((8, True), (12, False))
    out_cpu = vi_ba.vi_bundle_adjust(cam.kind, cam.params, on("cpu"), rounds=rounds)
    c = cam.to(cuda)
    out_gpu = vi_ba.vi_bundle_adjust(c.kind, c.params, on(cuda), rounds=rounds)
    assert out_gpu.R_wb.device.type == "cuda"
    assert torch.equal(out_gpu.valid.cpu(), out_cpu.valid)
    assert int((~out_cpu.valid[:20]).sum()) >= 18
    for k in ("R_wb", "p_wb", "v", "bg", "ba", "points"):
        _close(getattr(out_gpu, k), getattr(out_cpu, k), 1e-3, k)


def _rectified_rig(n=512, d=64, seed=0):
    """tests/test_stereo.py's rectified rig at a larger size: right
    keypoints are left ones shifted by the disparity fx*b/z, with row noise,
    octaves 0-3 and a few masked slots."""
    import numpy as np

    rng = np.random.default_rng(seed)
    z = rng.uniform(1.0, 20.0, n)
    uL, v = rng.uniform(80, 600, n), rng.uniform(20, 460, n)
    desc = rng.standard_normal((n, d))
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    octv = rng.integers(0, 4, n)
    mask = rng.uniform(size=n) > 0.05
    xyL = np.stack([uL, v], 1)
    xyR = np.stack([uL - 450.0 * 0.1 / z, v + rng.normal(0, 0.3, n)], 1)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    i32 = lambda x: torch.tensor(x, dtype=torch.int32)  # noqa: E731
    return (f32(xyL), f32(desc), i32(octv), torch.tensor(mask), f32(xyR), f32(desc),
            i32(octv), torch.tensor(mask))


def test_match_stereo_on_the_card_matches_the_cpu(cuda):
    from hfnet_slam_torch import device as D
    from hfnet_slam_torch.ops import stereo

    D.full_fp32()
    args = _rectified_rig()
    d_cpu, u_cpu = stereo.match_stereo(*args, fx=450.0, baseline=0.1)
    d_gpu, u_gpu = stereo.match_stereo(*(x.to(cuda) for x in args), fx=450.0, baseline=0.1)
    assert d_gpu.device.type == "cuda"
    assert torch.equal(u_gpu.cpu(), u_cpu) and int((d_cpu > 0).sum()) > 400
    _close(d_gpu, d_cpu, 1e-5, "depth")


def test_depth_at_keypoints_on_a_cuda_depth_image(cuda):
    import numpy as np

    from hfnet_slam_torch.ops import stereo

    rng = np.random.default_rng(1)
    img = torch.tensor(rng.uniform(500, 20000, (480, 640)), dtype=torch.float32)
    img[100:110, 200:210] = 0.0
    img[5, 5] = float("nan")
    xy = torch.tensor(np.concatenate([rng.uniform(-3, 645, (1000, 2)),
                                      [[5.0, 5.0], [204.5, 104.5], [2.5, 3.5]]]),
                      dtype=torch.float32)
    want = stereo.depth_at_keypoints(img, xy, 1.0 / 5000.0)
    got = stereo.depth_at_keypoints(img.to(cuda), xy.to(cuda), 1.0 / 5000.0)
    assert got.device.type == "cuda" and torch.equal(got.cpu(), want)
    assert float(want[-3]) == 0.0 and float(want[-2]) == 0.0


def test_track_rgbd_with_device_none_raises_without_a_card(cuda, monkeypatch):
    from hfnet_slam_torch.scenes import SMALL, rgbd_system, rig_system, RIG_SMALL

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: rgbd_system(SMALL), lambda: rig_system(RIG_SMALL)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


def test_rig_bundle_adjust_on_the_card_matches_the_cpu(cuda):
    """tests/test_rig.py's problem: two keyframes, 120 points, 30% of them
    seen only by the right cameras (ToBody edges)."""
    import numpy as np

    from hfnet_slam_torch import lie
    from hfnet_slam_torch.geometry import cameras
    from hfnet_slam_torch.optim import ba

    cam_l = cameras.pinhole(450.0, 450.0, 320.0, 240.0, 640, 480, device="cpu")
    cam_r = cameras.pinhole(455.0, 452.0, 318.0, 242.0, 640, 480, device="cpu")
    R_rl = lie.so3_exp(torch.tensor([0.0, -0.03, 0.005]))
    t_rl = torch.tensor([-0.11, 0.002, 0.001])
    rng = np.random.default_rng(0)
    m = 120
    pts = torch.tensor(rng.uniform(-3, 3, (m, 3)) + [0, 0, 8.0], dtype=torch.float32)
    R_gt = torch.stack([torch.eye(3), lie.so3_exp(torch.tensor([0.02, 0.25, -0.01]))])
    t_gt = torch.tensor([[0.0, 0.0, 0.0], [-1.2, 0.05, 0.1]])
    kf, pt, uv, sel = [], [], [], []
    for k in range(2):
        pc = pts @ R_gt[k].T + t_gt[k]
        uv_l, uv_r = cam_l.project(pc), cam_r.project(pc @ R_rl.T + t_rl)
        for j in range(m):
            if j >= 36:
                kf.append(k), pt.append(j), uv.append(uv_l[j]), sel.append(0.0)
            kf.append(k), pt.append(j), uv.append(uv_r[j]), sel.append(1.0)
    E = len(kf)
    xi = torch.tensor(rng.normal(0, 0.01, (2, 6)), dtype=torch.float32)
    xi[0] = 0.0
    R0, t0 = lie.se3_retract(R_gt, t_gt, xi)
    prob = ba.BAProblem(
        poses_R=R0, poses_t=t0, fixed=torch.tensor([True, False]),
        points=pts + torch.tensor(rng.normal(0, 0.05, (m, 3)), dtype=torch.float32),
        kf_idx=torch.tensor(kf), pt_idx=torch.tensor(pt), uv=torch.stack(uv),
        inv_sigma2=torch.ones(E), valid=torch.ones(E, dtype=torch.bool),
        z_meas=torch.zeros(E), wz=torch.zeros(E), cam_sel=torch.tensor(sel), rig_R=R_rl,
        rig_t=t_rl, params_r=cam_r.params)
    rounds = ((5, True), (15, False))
    out_cpu = ba.bundle_adjust(cam_l.kind, cam_l.params, prob, rounds=rounds)
    out_gpu = ba.bundle_adjust(cam_l.kind, cam_l.params.to(cuda),
                               ba.BAProblem(*(x.to(cuda) for x in prob)), rounds=rounds)
    assert out_gpu.points.device.type == "cuda"
    assert torch.equal(out_gpu.valid.cpu(), out_cpu.valid)
    for k in ("poses_R", "poses_t", "points"):
        _close(getattr(out_gpu, k), getattr(out_cpu, k), 1e-3, k)
    err = (out_cpu.points - pts).norm(dim=1)[:36]
    assert float(err.max()) < 2e-2  # the right-only points converge

