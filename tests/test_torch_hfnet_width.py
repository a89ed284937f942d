"""HF-Net at the published width (MobileNetV2 depth multiplier 0.75) in the
port: the channel table, agreement with the plain reference at any width
(slambench/reference/hfnet_dm.py: plain torch, float32, no module of the
port), the unchanged x1.0 network, the .npz files at both widths, and the
normal path (HFExtractor -> SLAMSystem.track_monocular, and run_euroc's
`Extractor.depthMultiplier`), on the CPU with seeded random weights.

Tolerances, each with its reason: the port runs its convolutions on NHWC
views (channels-last kernels) and the reference on NCHW tensors, so the
float32 sums are taken in another order. At these sizes the largest
differences seen were 1.7e-6 on the dense scores (probabilities in [0,1]),
2.6e-7 on the descriptor map and 8e-7 on the global descriptor (unit
vectors); the weights rounded to bfloat16 move them by 1.5e-2, 2e-3 and
7e-3. The limits, 1e-5 on each, sit between. Keypoint positions and masks
must agree exactly.
"""
import pathlib
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from hfnet_slam_torch.models import hfnet as TH  # noqa: E402
from hfnet_slam_torch.models.extractor import HFExtractor  # noqa: E402
from slambench.reference import hfnet as RH  # noqa: E402
from slambench.reference import hfnet_dm as RD  # noqa: E402

TOL_SCORES = 1e-5
TOL_DESC = 1e-5
PUBLISHED = 0.75
# conv0, then layer_2..layer_18's outputs at 0.75 (HF-Net's published network,
# TF-slim's _make_divisible(c * 0.75, 8), written out by hand)
TABLE_075 = (24, [16, 24, 24, 24, 48, 96, 48, 48, 48, 48, 72, 72, 72, 120, 120, 120, 240])
EXT = dict(n_features=120, n_levels=2, scale_factor=1.2, threshold=0.003, pad_to=256,
           nms_radius=4)


@pytest.fixture(autouse=True)
def full_fp32():
    """TF32 off, as the configurations state (a no-op on the CPU)."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _net(m, seed=3):
    return TH.HFNet(torch.Generator().manual_seed(seed), m)


def _image(h, w, seed=1):
    return torch.rand(h, w, generator=torch.Generator().manual_seed(seed)) * 255.0


@pytest.mark.parametrize("m", [0.75, 1.0])
def test_channel_table(m):
    """(a) 0.75 gives the published table, 1.0 gives BLOCKS, the plain
    reference's written-out table is its rule's, and every expansion is
    rounded to a multiple of 8."""
    c0, table = TH.channel_table(m)
    if m == 1.0:
        assert (c0, table) == (32, TH.BLOCKS)
    else:
        assert (c0, [c for _, _, c in table]) == TABLE_075 == RD.CHANNELS_075
        assert [(e, s) for e, s, _ in table] == [(e, s) for e, s, _ in TH.BLOCKS]
    assert RD.channels(m) == (c0, [c for _, _, c in table])
    net = TH.HFNet(depth_multiplier=m)
    assert all(b.depthwise.weight.shape[0] % 8 == 0 for b in net.blocks)
    assert net.desc0.weight.shape[1] == table[TH.LOCAL_ENDPOINT][2]
    assert net.proj.weight.shape == (TH.GLOBAL_DIM, TH.N_CLUSTERS * table[-1][2])
    assert TH.make_divisible(3) == 8 and TH.make_divisible(18) == 24


@pytest.mark.parametrize("m,hw", [(0.75, (64, 96)), (0.75, (96, 152)), (1.0, (64, 96))])
def test_forward_matches_the_plain_reference(m, hw):
    """(b) scores_dense, desc_map and global_desc of HFNet(depth_multiplier=m)
    against hfnet_dm.forward on the same weights (96x152: an odd input to
    the stride-2 convs of the tail)."""
    net = _net(m)
    img = _image(*hw)
    with torch.no_grad():
        out = net(img[None, :, :, None])
        ref = RD.forward(dict(net.state_dict()), img[None, None], m)
    assert float((out["scores_dense"] - ref["scores_dense"]).abs().max()) <= TOL_SCORES
    assert float((out["desc_map"] - ref["desc_map"].permute(0, 2, 3, 1)).abs().max()) <= TOL_DESC
    assert float((out["global_desc"] - ref["global_desc"]).abs().max()) <= TOL_DESC
    assert out["desc_map"].shape[-1] == TH.DESC_DIM and out["global_desc"].shape[-1] == 4096


def test_extraction_matches_the_plain_reference():
    """(b) the port's pyramid extractor on a 0.75 net against the plain
    extraction at 0.75: the same slots valid at the same positions, their
    descriptors and the global descriptor within TOL_DESC."""
    net = _net(PUBLISHED)
    img = _image(96, 128, seed=5)
    ext = HFExtractor(net, (96, 128), **EXT, device="cpu")
    f = ext(img)
    ref = RD.extract(dict(net.state_dict()), img, EXT, PUBLISHED)
    assert torch.equal(f.mask, ref["mask"]) and int(f.mask.sum()) > 20
    assert torch.equal(f.xy[f.mask], ref["xy"][ref["mask"]])
    assert float((f.desc[f.mask] - ref["desc"][ref["mask"]]).abs().max()) <= TOL_DESC
    assert float((f.global_desc - ref["global_desc"]).abs().max()) <= TOL_DESC


def test_x1_state_dict_is_unchanged():
    """(c) the default network keeps every key and shape of the x1.0 plain
    reference (its copy predates the width), and draws the same weights as
    depth_multiplier=1.0."""
    sd = _net(1.0).state_dict()
    plain = RH.param_shapes()
    assert set(sd) == set(plain)
    assert all(tuple(sd[k].shape) == plain[k][0] for k in sd)
    default = TH.HFNet(torch.Generator().manual_seed(3)).state_dict()
    assert all(torch.equal(default[k], sd[k]) for k in sd)
    assert TH.HFNet().depth_multiplier == 1.0


def test_published_width_state_dict():
    """The 0.75 network's parameters are the plain reference's, and far
    fewer: the projection reads 64 x 240 features."""
    sd = _net(PUBLISHED).state_dict()
    plain = RD.param_shapes(PUBLISHED)
    assert set(sd) == set(plain) and all(tuple(sd[k].shape) == plain[k][0] for k in sd)
    assert sd["proj.weight"].shape == (4096, 15360)
    assert sum(v.numel() for v in sd.values()) < 0.8 * sum(
        v.numel() for v in _net(1.0).state_dict().values())


def test_npz_round_trip_and_wrong_width(tmp_path):
    """(d) a 0.75 .npz reads back at its width (given or read from its
    shapes), bit for bit; a file of the other width raises, at load and
    at from_state."""
    net = _net(PUBLISHED)
    TH.save_params(tmp_path / "w075.npz", net)
    for m in (None, PUBLISHED):
        back = TH.load_params(tmp_path / "w075.npz", device="cpu", depth_multiplier=m)
        assert back.depth_multiplier == PUBLISHED
        assert all(torch.equal(back.state_dict()[k], v) for k, v in net.state_dict().items())
    with pytest.raises(ValueError, match="shape"):
        TH.load_params(tmp_path / "w075.npz", device="cpu", depth_multiplier=1.0)
    TH.save_params(tmp_path / "w100.npz", _net(1.0))
    with pytest.raises(ValueError):
        TH.load_params(tmp_path / "w100.npz", device="cpu", depth_multiplier=PUBLISHED)
    assert TH.load_params(tmp_path / "w100.npz", device="cpu").depth_multiplier == 1.0
    with pytest.raises(RuntimeError, match="size mismatch"):
        TH.HFNet.from_state(net.state_dict(), "cpu", depth_multiplier=1.0)
    flat = TH.flat_from_state(net.state_dict())
    flat["conv0/w"] = flat["conv0/w"][..., :20]
    with pytest.raises(ValueError, match="no depth multiplier"):
        TH.state_from_flat(flat)


def test_settings_key_reaches_the_runners(tmp_path):
    """`Extractor.depthMultiplier` builds the random net at its width, picks
    a checkpoint's width, and refuses a checkpoint of another width; without
    the key a checkpoint keeps its own width."""
    from hfnet_slam_torch.utils.settings import Settings, depth_multiplier, make_hfnet

    path = tmp_path / "s.yaml"
    path.write_text('%YAML:1.0\nFile.version: "1.0"\nExtractor.depthMultiplier: 0.75\n')
    Settings.from_yaml(str(path))
    m = depth_multiplier(str(path))
    assert m == PUBLISHED
    assert make_hfnet(m, None, "cpu").depth_multiplier == PUBLISHED
    TH.save_params(tmp_path / "w100.npz", _net(1.0))
    TH.save_params(tmp_path / "w075.npz", _net(PUBLISHED))
    assert make_hfnet(m, str(tmp_path / "w075.npz"), "cpu").depth_multiplier == PUBLISHED
    with pytest.raises(ValueError):
        make_hfnet(m, str(tmp_path / "w100.npz"), "cpu")
    path.write_text('%YAML:1.0\nFile.version: "1.0"\n')
    plain = depth_multiplier(str(path))
    assert plain is None
    assert make_hfnet(plain, None, "cpu").depth_multiplier == 1.0
    assert make_hfnet(plain, str(tmp_path / "w075.npz"), "cpu").depth_multiplier == PUBLISHED


def test_forward_cost_carries_the_width():
    """tools/extract_breakdown.forward_cost at a width equals the plain
    reference's count, and at 1.0 the x1.0 count."""
    from hfnet_slam_torch.tools.extract_breakdown import forward_cost

    for g in (True, False):
        for m in (PUBLISHED, 1.0):
            a, b = forward_cost(480, 752, g, 4, m), RD.forward_cost(480, 752, g, m)
            assert a["flops"] == b["flops"] and a["min_bytes"] == b["min_bytes"]
        assert forward_cost(480, 752, g)["flops"] == RH.forward_cost(480, 752, g)["flops"]


def test_run_euroc_builds_the_settings_width(tmp_path):
    """(e) run_euroc with `Extractor.depthMultiplier: 0.75` runs its frames
    through a 0.75 network, and with a 0.75 checkpoint as --weights."""
    from hfnet_slam_torch.examples import run_euroc
    from hfnet_slam_torch.scenes import write_euroc_sequence
    from hfnet_slam_torch.utils.timing import timings

    seq, cfg, _ = write_euroc_sequence(str(tmp_path), 2)
    with open(cfg, "a") as f:
        f.write("Extractor.depthMultiplier: 0.75\n")
    TH.save_params(tmp_path / "w075.npz", _net(PUBLISHED))
    for extra in ([], ["--weights", str(tmp_path / "w075.npz")]):
        timings.reset()
        sys_ = run_euroc.main([seq, "--config", cfg, "--out", str(tmp_path / "t.txt"),
                               "--device", "cpu"] + extra)
        assert sys_.extractor.net.depth_multiplier == PUBLISHED
        assert timings.stats()["frame_total"][0] == 2
    timings.reset()


def test_published_width_initializes_and_tracks_monocular():
    """(e) the normal path: HF-Net at 0.75 from the port's self-training
    (models/selftrain, carrying the width) behind HFExtractor inside
    SLAMSystem.track_monocular, on a CylinderWorld orbit at 320x240: the
    map initializes from two views within the first frames, and every later
    frame returns a pose. With the recorder on, the initialization's spans
    are there and `init_attempts` counts one a frame up to the map."""
    from hfnet_slam_torch.geometry import cameras
    from hfnet_slam_torch.models import selftrain, synth
    from hfnet_slam_torch.slam.system import SLAMSystem, SystemConfig
    from hfnet_slam_torch.utils.timing import timings

    W, H = 320, 240
    cam = cameras.pinhole(0.7 * W, 0.7 * W, W / 2, H / 2, W, H, device="cpu")
    world = synth.CylinderWorld(cam, n_blobs=1400, seed=5)
    net, stats = selftrain.train(world, n_steps=40, pose_range=30, n_frames_cache=10,
                                 device="cpu", depth_multiplier=PUBLISHED)
    assert net.depth_multiplier == PUBLISHED and stats["loss_last"] < stats["loss_first"]
    ext = HFExtractor(net, (H, W), n_features=400, n_levels=2, pad_to=512, threshold=0.003,
                      device="cpu")
    sys_ = SLAMSystem(cam, ext, SystemConfig(k_max=32, m_max=4096, n_slots=512,
                                             loop_closing=False), device="cpu")
    timings.reset()
    timings.enable()
    try:
        poses = [sys_.track_monocular(world.render_rgbd(*world.orbit_pose(i))[0], 0.05 * i)[1]
                 for i in range(10)]
    finally:
        timings.disable()
        sys_.shutdown()
    recs = timings.records()
    timings.reset()
    first = next(i for i, R in enumerate(poses) if R is not None)
    assert first <= 4 and all(R is not None for R in poses[first:])
    assert int(sys_.store.kf_valid.sum()) >= 2
    init = {r.name: r for r in recs if r.name.startswith("track.init.")}
    assert set(init) == {"track.init.search", "track.init.twoview", "track.init.map"}
    assert all(recs[r.parent].name == "track.init" for r in init.values())
    assert sum((r.counts or {}).get("init_attempts", 0) for r in recs) == first + 1
