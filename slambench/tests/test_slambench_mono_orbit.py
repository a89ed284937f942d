"""The published-width monocular cell, hfnet075-mono-euroc-752x480.mono-orbit,
at a small size on the CPU: its generator initializes every episode within
the traffic's init_frames, a sound run holds every limit, the new check
kinds read over their limits with a planted fault (the program's network at
the other width; the monocular initializer skipped), the plain reference's
forward_cost counts what its forward computes, each new reader returns a
number on a small traced run (the device trace stood in for by a synthetic
one: the CPU has none), and a program whose HFNet takes no width stops in
set-up with an error."""
import time
import types

import pytest
import torch
import torch.nn.functional as F

from slambench.harness import core
from slambench.harness import program_trace as PT
from slambench.harness import trace as TR
from slambench.metrics import (hfnet075_roofline, hfnet_roofline, init_frames, init_ms,
                               mono_frame_mfu)
from slambench.reference import hfnet as RH
from slambench.reference import hfnet_dm as RD

CPU = torch.device("cpu")
SEED = 2 ** 31 + 53
CELL = "hfnet075-mono-euroc-752x480.mono-orbit"
# EuRoC cam0 at a quarter of its size, two pyramid levels, an 80-step
# fine-tune (after 20 steps of the detector term the keypoints are still too
# poor to initialize at this size); the orbit at the cell's 0.012 rad a frame
SMALL = {
    "config": {"camera": {"fx": 114.66, "fy": 114.32, "cx": 91.8, "cy": 62.1, "width": 184,
                          "height": 120},
               "extractor": {"n_features": 300, "n_levels": 2, "pad_to": 512,
                             "train": {"n_steps": 80, "n_pairs": 64, "n_frames_cache": 8}},
               "system": {"k_max": 32, "m_max": 4096, "n_slots": 512}},
    "traffic": {"phases": [0, 24], "frames": 24, "init_frames": 8, "warmup_frames": 12,
                "path": {"rate": 0.012}},
    "workload": {"check": {"samples": {"extract_dm": 2, "track_step": 4, "ba": 2,
                                       "mono_init": 0}}}}


@pytest.fixture(autouse=True)
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(seconds=20, trace=False, box=None):
    return core.run(CELL, SEED, seconds, trace, device=CPU, overrides=SMALL,
                    log=lambda *a: None, run_out=box)


@pytest.fixture(scope="module")
def sound():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        box = {}
        result, table = _run(box=box)
    finally:
        torch.set_num_threads(n)
    return types.SimpleNamespace(result=result, table=table, run=box["run"])


def test_every_episode_initializes_within_init_frames(sound):
    log = sound.run.feed.init_log
    assert log and all(e["has_map"] for e in log)
    assert all(len(e["frames"]) == SMALL["traffic"]["init_frames"] for e in log)
    assert sound.table["uninit_episodes"]["value"] == 0


def test_sound_run_holds_its_limits(sound):
    assert sound.result["correct"], sound.table
    assert sound.result["failed"] == 0 and sound.result["attempted"] > 0
    assert {"kp_mismatch", "desc_err", "gdesc_err", "obs_mismatch", "pose_err", "ba_excess",
            "uninit_episodes", "lost_frames"} == set(sound.table)
    assert sound.run.feed.extractor is None   # released before the comparison


def test_network_of_the_other_width_is_caught(monkeypatch):
    """The program's network built at 1.0 (He init from seed 0) where the
    configuration states 0.75: the extraction check reads over its limits."""
    from hfnet_slam_torch.models import hfnet

    def wrong_width(state, device=None, depth_multiplier=None):
        return hfnet.HFNet(torch.Generator().manual_seed(0), 1.0).to(device).eval()

    monkeypatch.setattr(hfnet.HFNet, "from_state", staticmethod(wrong_width))
    result, table = _run(seconds=6)
    assert not result["correct"]
    assert table["kp_mismatch"]["value"] > table["kp_mismatch"]["limit"], table


def test_skipped_initializer_is_caught(monkeypatch):
    """Tracker._monocular_initialization returning at once: no episode has
    a map, so uninit_episodes reads every episode, and no frame has a
    pose."""
    from hfnet_slam_torch.slam.tracking import Tracker

    monkeypatch.setattr(Tracker, "_monocular_initialization", lambda self, frame: None)
    result, table = _run(seconds=6)
    assert not result["correct"]
    assert table["uninit_episodes"]["value"] >= 1
    assert table["lost_frames"]["value"] == result["attempted"] > 0


def test_program_without_a_width_stops_in_setup(monkeypatch):
    """The parent program's HFNet(generator) has no depth_multiplier: the
    generator raises RunError (exit 2) before it trains any weights."""
    from hfnet_slam_torch.models import hfnet

    def old_hfnet(generator=None):
        raise AssertionError("not to be built")

    monkeypatch.setattr(hfnet, "HFNet", old_hfnet)
    t = time.perf_counter()
    with pytest.raises(core.RunError, match="depth_multiplier"):
        _run(seconds=6)
    assert time.perf_counter() - t < 30


def _counted_cost(h, w, m):
    """FLOPs and weight bytes of the plain forward, counted from the shapes
    of the convolutions, linear maps and the NetVLAD contraction it runs."""
    c = {"flops": 0.0, "weight_bytes": 0.0}
    conv2d, linear = F.conv2d, F.linear

    def conv(x, w_, b=None, stride=1, padding=0, dilation=1, groups=1):
        y = conv2d(x, w_, b, stride, padding, dilation, groups)
        c["flops"] += 2.0 * y.numel() * w_[0].numel()
        c["weight_bytes"] += 4.0 * (w_.numel() + b.numel())
        if w_.shape[0] == RD.N_CLUSTERS:     # the memberships: NetVLAD's contraction
            c["flops"] += 2.0 * y.numel() * x.shape[1]
        return y

    def lin(x, w_, b=None):
        c["flops"] += 2.0 * w_.numel()
        c["weight_bytes"] += 4.0 * (w_.numel() + b.numel())
        return linear(x, w_, b)

    p = {k: torch.randn(s) * 0.1 for k, (s, _) in RD.param_shapes(m).items()}
    try:
        F.conv2d, F.linear = conv, lin
        RD.forward(p, torch.rand(1, 1, h, w) * 255, m)
    finally:
        F.conv2d, F.linear = conv2d, linear
    c["weight_bytes"] += 4.0 * p["vlad_clusters"].numel()
    return c


@pytest.mark.parametrize("hw", [(64, 96), (120, 184), (96, 152)])
def test_forward_cost_counts_the_plain_forward(hw):
    for g in (True, False):
        assert RD.forward_cost(*hw, g, 1.0) == RH.forward_cost(*hw, g)
    got, want = RD.forward_cost(*hw, True, 0.75), _counted_cost(*hw, 0.75)
    assert got["flops"] == pytest.approx(want["flops"], rel=1e-12)
    assert got["weight_bytes"] == pytest.approx(want["weight_bytes"], rel=1e-12)
    assert got["flops"] < 0.8 * RD.forward_cost(*hw, True, 1.0)["flops"]


class SyntheticTrace(TR.Trace):
    """The profiler's slices on the CPU: each span boundary becomes a marker
    1 us after the last, with one 0.5 us kernel after each marker."""

    def start(self, n_boundaries):
        self.sessions.append({"h0": time.perf_counter(), "b0": n_boundaries})

    def stop(self, n_boundaries):
        self.sessions[-1].update(h1=time.perf_counter(), b1=n_boundaries)

    def read(self):
        t = 10 ** 12
        for ses in self.sessions:
            n = ses["b1"] - ses["b0"]
            markers = [t + 1000 * k for k in range(n)]
            kernels = [("k", m + 100, m + 600) for m in markers]
            self.slices.append({"start": ses["h0"], "secs": ses["h1"] - ses["h0"],
                                "busy_ns": 500 * n, "markers": markers,
                                "b": (ses["b0"], ses["b1"])})
            self.kernels.extend(kernels)
            self.markers.extend(markers)
            t += 1000 * n + 10 ** 9
        self.sessions = []
        self.read_s = 0.0


def test_new_readers_read_a_small_traced_run(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda *a, **k: None)
    monkeypatch.setattr(TR, "Trace", SyntheticTrace)
    PT.RECORDER.reset()
    box = {}
    try:
        result, _ = _run(seconds=16, trace=True, box=box)
        run = box["run"]
        assert {"hfnet075_roofline", "mono_frame_mfu", "init_ms", "init_frames"} \
            <= set(result["metrics"])
        # init_frames: the initializer's attempts an episode, at least the
        # two views, at most the frames the traffic gives it
        assert 2 <= init_frames.read(run) <= SMALL["traffic"]["init_frames"]
        assert init_ms.read(run) > 0
        # the roofline's bound at 0.75; the x1.0 reader's, on the same calls,
        # is larger by the ratio of the two counts
        calls = [iv for iv in run.trace.intervals(run.spans.boundaries) if iv[0] == "hfnet"]
        outer = [c for c in calls if c[1][0] in ("global", "local") and not any(
            o is not c and o[2] <= c[2] and c[3] <= o[3] for o in calls)]
        assert outer

        def bound(cost, *a):
            c = cost(*a)
            return max(c["flops"] / 67e12, c["min_bytes"] / 3.35e12)

        b075 = sum(bound(RD.forward_cost, i[1], i[2], i[0] == "global", 0.75)
                   for _, i, _, _ in outer)
        b100 = sum(bound(RH.forward_cost, i[1], i[2], i[0] == "global") for _, i, _, _ in outer)
        r075, r100 = hfnet075_roofline.read(run), hfnet_roofline.read(run)
        assert r075 == pytest.approx(result["metrics"]["hfnet075_roofline"]["value"])
        assert r100 / r075 == pytest.approx(b100 / b075, rel=1e-9) and b100 > b075
        flops = RD.frame_cost((120, 184), run.feed.ref_extractor, 0.75)["flops"]
        assert mono_frame_mfu.read(run) == pytest.approx(
            100.0 * flops * len(run.frame_s) / run.window_s / 67e12)
    finally:
        PT.RECORDER.reset()


def test_readers_without_a_width_or_a_log_read_none():
    """A feed of the x1.0 cells (no depth_multiplier, no init_log), or no
    recorder: the new readers leave their metric out."""
    run = types.SimpleNamespace(feed=types.SimpleNamespace(), trace=object(), spans=None,
                                frame_s=[0.1], launches_window={}, window_s=1.0)
    for m in (hfnet075_roofline, mono_frame_mfu, init_ms, init_frames):
        assert m.read(run) is None


# the cell's texture_points keywords (configs/hfnet075-mono-euroc-752x480.json)
TEXTURE = {"sigma": 1.0, "window": 7, "min_curvature": 2.0, "floor": 0.3}


def test_texture_points_are_the_rendered_extrema():
    """Each wall keypoint, projected into a rendered view, lies on an extremum
    of the image: its pixel is the largest or smallest grey level within one
    pixel of the projection; the soft targets sum to 1 in every cell."""
    import numpy as np

    from slambench.frozen import selftrain_dm
    from slambench.frozen.synth import CylinderWorld

    cam = {"fx": 458.654, "fy": 457.296, "cx": 367.215, "cy": 248.375, "width": 752,
           "height": 480}
    world = CylinderWorld(cam)
    P, s = selftrain_dm.texture_points(world, **TEXTURE)
    assert len(P) > 5000 and s.min() >= 0.3 and s.max() == 1.0
    pose = world.orbit_pose(30)
    img, _ = world.render_rgbd(*pose)
    T, pos = selftrain_dm.view_targets(world, P, s, pose, (480, 752), 0.8)
    assert T.shape == (65, 60, 94) and np.allclose(T.sum(0), 1.0)
    assert 300 < pos.sum() < pos.size
    # a cell's peak is the pixel nearest its keypoint's projection
    cls = T[:64].argmax(0)[pos]
    cy, cx = np.nonzero(pos)
    ys, xs = cy * 8 + cls // 8, cx * 8 + cls % 8
    hit = 0
    for y, x in zip(ys, xs):
        if 2 <= y < 478 and 2 <= x < 750:
            win, c = img[y - 2:y + 3, x - 2:x + 3], img[y - 1:y + 2, x - 1:x + 2]
            hit += bool(c.max() == win.max() or c.min() == win.min())
    assert hit >= 0.9 * len(ys)


def test_detector_term_lowers_the_detector_loss():
    """A few steps of the fine-tune with the detector term lower that term
    (the soft targets are learnable), at a small size on the CPU."""
    from slambench.frozen import selftrain_dm
    from slambench.frozen.synth import CylinderWorld

    cam = SMALL["config"]["camera"]
    world = CylinderWorld(cam)
    params = selftrain_dm.init_params(0, CPU, 0.75)
    pose = world.orbit_pose
    det = {"weight": 1.0, "spread": 0.8, **TEXTURE}
    _, s0 = selftrain_dm.train(world, params, 1, 1, 64, 8, 24, 0, 0.75, pose, lr=3e-3, det=det,
                               levels=[(120, 184), (96, 152)])
    _, s1 = selftrain_dm.train(world, params, 1, 40, 64, 8, 24, 0, 0.75, pose, lr=3e-3, det=det,
                               levels=[(120, 184), (96, 152)])
    assert s1["det_loss_last"] < 0.8 * s0["det_loss_last"]
