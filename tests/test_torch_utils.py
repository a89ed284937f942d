"""The port's utilities against the reference's (port on the CPU): settings,
the PNG reader, the dataset loaders, the trajectory savers, the timing
registry and the EuRoC runner.

Tolerances: parsed settings, dataset arrays, images and KITTI lines
exactly. TUM/EuRoC lines: timestamps and positions exactly, quaternions
within 2e-7 (float32 Shepperd conversions whose square roots and divisions
round the last bit differently in torch and XLA, printed to 7 decimals)."""
import struct
import time
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import test_utils  # noqa: E402
from test_utils import EUROC_YAML  # noqa: E402

MORE_YAML = """%YAML:1.0
# a comment line
File.version: "1.0"
Camera.type: 'KannalaBrandt8'   # quoted, with a trailing comment
Camera1.fx: 190.97847715128717
Camera1.k1: -0.0034823894022493434
Camera1.k2: 7e-3
Camera.width: 512
System.LoadAtlasFromFile: "maps/a#1"
Stereo.T_c1_c2: !!opencv-matrix
  rows: 4
  cols: 4
  dt: f
  data: [0.999997256477797,-0.002317135723275,-0.000343393120620,0.101079526383951,
         0.002312067192432,0.999898048507103,-0.014090668452683,-0.001950446285015,
         0.000376008102320,0.014089835846691,0.999900662638081,-0.000154134283024,
         0,0,0,1.000000000000000]
Viewer.list: [1, 2.5, abc, "q"]
Viewer.on: true
System.thFarPoints: -20.0
Empty.value:
"""


def _write(tmp_path, text, name="cfg.yaml"):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


# ---------------------------------------------------------------------------
# settings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("text", [EUROC_YAML, MORE_YAML], ids=["euroc", "more"])
def test_settings_parser_equals_pyyaml_on_the_preprocessed_text(text):
    import yaml

    from hfnet_slam_tpu.utils.settings import _preprocess_opencv_yaml
    from hfnet_slam_torch.utils.settings import parse_opencv_yaml

    want = yaml.safe_load(_preprocess_opencv_yaml(text))
    got = parse_opencv_yaml(text)
    assert got == want
    assert {k: type(v) for k, v in got.items()} == {k: type(v) for k, v in want.items()}


@pytest.mark.parametrize("bad", [
    "A: 1\nB:\n  c: 2\n",                     # nested mapping
    "A:\n  - 1\n  - 2\n",                      # block sequence
    "A: &x 1\n",                               # anchor
    "A: !!binary abc\n",                       # another tag
    "A: [1, 2\nB: 3\n",                        # unterminated flow list
    "A: 1\nA: 2\n",                            # duplicate key
    "M: !!opencv-matrix\n  rows: 1\n  cols: 1\n  data: [1]\n",  # no dt
    "  A: 1\n",                                # indented top level
])
def test_settings_parser_raises_outside_its_subset(bad):
    from hfnet_slam_torch.utils.settings import parse_opencv_yaml

    with pytest.raises(ValueError, match="settings"):
        parse_opencv_yaml(bad)


def test_settings_fields_equal_the_reference(tmp_path):
    import dataclasses

    from hfnet_slam_tpu.utils.settings import Settings as JS
    from hfnet_slam_torch.utils.settings import Settings as TS

    for text in (EUROC_YAML, MORE_YAML):
        p = _write(tmp_path, text)
        j, t = JS.from_yaml(p), TS.from_yaml(p)
        for f in dataclasses.fields(JS):
            a, b = getattr(j, f.name), getattr(t, f.name)
            if isinstance(a, np.ndarray):
                np.testing.assert_array_equal(b, a, err_msg=f.name)
            else:
                assert b == a and type(b) is type(a), f.name
        assert t.sensor == j.sensor
    assert [f.name for f in dataclasses.fields(TS)] == [f.name for f in dataclasses.fields(JS)]


def test_make_camera_and_system_config_equal_the_reference(tmp_path):
    from hfnet_slam_tpu.utils.settings import Settings as JS
    from hfnet_slam_torch.utils.settings import Settings as TS

    p = _write(tmp_path, EUROC_YAML)
    j, t = JS.from_yaml(p), TS.from_yaml(p)
    cj, ct = j.make_camera(), t.make_camera(device="cpu")
    assert (ct.kind, ct.width, ct.height) == (cj.kind, cj.width, cj.height)
    np.testing.assert_array_equal(ct.params.numpy(), np.asarray(cj.params))
    np.testing.assert_array_equal(ct.dist.numpy(), np.asarray(cj.dist))
    gj, gt = j.make_system_config(), t.make_system_config(async_mapping=True)
    assert gt.async_mapping and not gj.async_mapping
    for f in ("loop_closing", "baseline", "depth_factor", "k_max", "n_slots", "desc_dim"):
        assert getattr(gt, f) == getattr(gj, f), f
    for f in ("th_depth", "th_far", "max_frames_between_kf"):
        assert getattr(gt.tracker, f) == getattr(gj.tracker, f), f
    assert gt.tracker.max_frames_between_kf == 20  # Camera.fps
    ij, it = j.make_imu_calib(), t.make_imu_calib()  # the IMU keys' defaults
    for f in ("sigma_g", "sigma_a", "sigma_gw", "sigma_aw", "Tbc_R", "Tbc_t"):
        np.testing.assert_array_equal(np.asarray(getattr(it, f), np.float32),
                                      np.asarray(getattr(ij, f), np.float32))
    # a monocular file has no second camera, in either package (item 16)
    assert t.make_camera_right("cpu") is None and j.make_camera_right() is None
    assert gt.cam_right is None and gt.T_lr is None


# ---------------------------------------------------------------------------
# PNG reader
# ---------------------------------------------------------------------------

def _encode(img, ftype, interlace=0):
    """A PNG of img with every row under filter `ftype` (0-4): 8-bit
    grayscale or RGB of uint8, 16-bit grayscale (big-endian) of uint16. The
    filters work on bytes, bpp bytes a pixel."""
    h, w = img.shape[:2]
    wide = img.dtype == np.uint16
    bpp = 2 if wide else (1 if img.ndim == 2 else 3)
    data = img.astype(">u2").view(np.uint8) if wide else img
    rows = data.reshape(h, w * bpp).astype(np.int64)
    out, prior = [], np.zeros(w * bpp, np.int64)
    for y in range(h):
        x = rows[y]
        a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        if ftype == 0:
            f = x
        elif ftype == 1:
            f = x - a
        elif ftype == 2:
            f = x - prior
        elif ftype == 3:
            f = x - (a + prior) // 2
        else:
            p = a + prior - c
            pa, pb, pc = abs(p - a), abs(p - prior), abs(p - c)
            f = x - np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prior, c))
        out.append(np.concatenate([[ftype], f % 256]).astype(np.uint8))
        prior = x

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body))

    ihdr = struct.pack(">IIBBBBB", w, h, 16 if wide else 8, 2 if bpp == 3 else 0, 0, 0,
                       interlace)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(np.concatenate(out).tobytes()))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_png_reader_undoes_each_row_filter(tmp_path, ftype):
    from hfnet_slam_torch.utils.datasets import read_png

    rng = np.random.default_rng(ftype)
    for shape in ((9, 13), (7, 11, 3)):
        img = rng.integers(0, 256, shape).astype(np.uint8)
        img[2:5] = 255  # runs that make the predictors carry
        p = tmp_path / f"f{ftype}_{len(shape)}.png"
        p.write_bytes(_encode(img, ftype))
        np.testing.assert_array_equal(read_png(str(p)), img)


@pytest.mark.parametrize("shape", [(31, 17), (480, 752), (23, 9, 3), (64, 75, 3)])
def test_png_reader_matches_pil(tmp_path, shape):
    from PIL import Image

    from hfnet_slam_torch.utils.datasets import load_image_gray, read_png, write_png

    rng = np.random.default_rng(sum(shape))
    img = np.cumsum(rng.integers(0, 9, shape), axis=1).astype(np.uint8)  # smooth: PIL filters
    p = str(tmp_path / "pil.png")
    Image.fromarray(img).save(p)
    np.testing.assert_array_equal(read_png(p), np.asarray(Image.open(p)))
    with Image.open(p) as im:
        gray = np.asarray(im.convert("L"), np.float32)
    np.testing.assert_array_equal(load_image_gray(p), gray)
    q = str(tmp_path / "ours.png")
    write_png(q, img)
    np.testing.assert_array_equal(np.asarray(Image.open(q)), img)


@pytest.mark.parametrize("mode", ["I;16", "P", "interlaced"])
def test_png_reader_raises_on_other_pngs(tmp_path, mode):
    from PIL import Image

    from hfnet_slam_torch.utils.datasets import read_png

    p = str(tmp_path / "x.png")
    if mode == "I;16":
        # 16-bit grayscale (TUM-RGBD's depth maps) reads as Pillow reads it;
        # 16-bit RGB raises
        img = np.arange(64, dtype=np.uint16).reshape(8, 8) * 900
        Image.fromarray(img).save(p)
        np.testing.assert_array_equal(read_png(p), np.asarray(Image.open(p)))
        raw = bytearray(_encode(np.zeros((8, 48), np.uint8), 0))
        raw[16:29] = struct.pack(">IIBBBBB", 8, 8, 16, 2, 0, 0, 0)
        raw[29:33] = struct.pack(">I", zlib.crc32(bytes(raw[12:29])))
        open(p, "wb").write(bytes(raw))
    elif mode == "P":
        Image.fromarray(np.zeros((8, 8), np.uint8)).convert("P").save(p)
    else:  # an Adam7 header
        open(p, "wb").write(_encode(np.zeros((8, 8), np.uint8), 0, interlace=1))
    with pytest.raises(ValueError, match="PNG|palette"):
        read_png(p)


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------

def test_load_euroc_imu_between_and_associate_equal_the_reference(tmp_path):
    from hfnet_slam_tpu.utils import datasets as JD
    from hfnet_slam_torch.utils import datasets as TD

    root = test_utils.TestDatasets()._fake_euroc(tmp_path)
    sj, st = JD.load_euroc(root, with_imu=True), TD.load_euroc(root, with_imu=True)
    assert st.image_paths == sj.image_paths and len(st) == 3
    np.testing.assert_array_equal(st.timestamps, sj.timestamps)
    np.testing.assert_array_equal(st.imu, sj.imu)
    np.testing.assert_allclose(st.imu[0, 1:4], [0.1, 0.2, 9.8])  # [t ax ay az wx wy wz]
    for i in range(3):
        np.testing.assert_array_equal(st.image(i), sj.image(i))
    for a, b in ((st.timestamps[0], st.timestamps[1]), (0.0, 1e10), (5.0, 6.0)):
        np.testing.assert_array_equal(st.imu_between(a, b), sj.imu_between(a, b))
    assert len(st.imu_between(st.timestamps[0], st.timestamps[1])) > 0
    a = [(0.00, "a0"), (0.05, "a1"), (0.10, "a2"), (0.2, "a3")]
    b = [(0.001, "b0"), (0.052, "b1"), (0.30, "b2"), (0.21, "b3")]
    assert TD.associate(a, b) == JD.associate(a, b)
    assert len(TD.associate(a, b)) == 2  # b2 lies past a2's window: the scan stops
    # the TUM-RGBD list parser and its association
    d = tmp_path / "tum"
    d.mkdir()
    (d / "rgb.txt").write_text("# rgb\n1.00 rgb/1.png\n1.05 rgb/2.png\n")
    (d / "depth.txt").write_text("# depth\n1.004 depth/1.png\n1.3 depth/2.png\n")
    rj, rt = JD.load_tum_rgbd(str(d)), TD.load_tum_rgbd(str(d))
    assert (rt.image_paths, rt.depth_paths) == (rj.image_paths, rj.depth_paths)
    np.testing.assert_array_equal(rt.timestamps, rj.timestamps)
    # the 16-bit depth maps, divided by the depth factor (item 16)
    (d / "depth").mkdir()
    from PIL import Image

    Image.fromarray(np.arange(48, dtype=np.uint16).reshape(6, 8) * 1250).save(
        str(d / "depth" / "1.png"))
    np.testing.assert_array_equal(rt.depth(0), rj.depth(0))
    assert rt.depth(0).dtype == np.float32 and rt.depth(0)[1, 0] == 8 * 1250 / 5000.0


# ---------------------------------------------------------------------------
# trajectory savers and timing
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tracked_20():
    from _torch_parity import build, run

    sys_t, ext = build("torch", device="cpu")
    run(sys_t, ext, 0, 20)
    return sys_t


@pytest.mark.parametrize("fmt", ["tum", "euroc", "kitti"])
def test_trajectory_savers_equal_the_reference(tracked_20, tmp_path, fmt):
    """SLAMSystem.save_trajectory against the reference's saver on the same
    tracked trajectory (both rebuild each pose through its keyframe)."""
    from hfnet_slam_tpu.utils import trajectory as JTJ

    sys_t = tracked_20
    p, q = tmp_path / "port.txt", tmp_path / "ref.txt"
    sys_t.save_trajectory(str(p), fmt)
    JTJ.save(str(q), sys_t.trajectory, fmt)
    got, want = p.read_text().splitlines(), q.read_text().splitlines()
    assert len(got) == len(want) == len(sys_t.trajectory) > 0
    for g, w in zip(got, want):
        if fmt == "kitti":
            assert g == w
            continue
        g, w = g.split(), w.split()
        assert g[:4] == w[:4]  # timestamp and position
        np.testing.assert_allclose(np.float64(g[4:]), np.float64(w[4:]), atol=2e-7)
    if fmt == "tum":
        rows = np.loadtxt(p)
        np.testing.assert_allclose(np.linalg.norm(rows[:, 4:8], axis=1), 1.0, atol=1e-6)
        assert sys_t.trajectory_tum().splitlines() == got
    kp = tmp_path / "kf.txt"
    sys_t.save_keyframe_trajectory(str(kp), fmt)
    assert len(kp.read_text().splitlines()) == int(sys_t.store.kf_valid.sum())


def test_timing_sections_and_report(tmp_path):
    from hfnet_slam_torch.utils.timing import TimingRegistry

    reg = TimingRegistry()
    for _ in range(3):
        with reg.section("stage_a"):
            time.sleep(0.002)
    reg.add("stage_b", 0.5)
    n, mean, _, p50, _ = reg.stats()["stage_a"]
    assert n == 3 and mean >= 1.5 and p50 >= 1.5
    rep = reg.report()
    assert "stage_a" in rep and "stage_b" in rep and rep.splitlines()[0].startswith("stage")
    x = torch.ones(3)
    assert reg.block(x) is x  # a CPU tensor needs no card sync
    reg.save(str(tmp_path / "t.txt"))
    assert (tmp_path / "t.txt").read_text().strip() == rep
    reg.reset()
    assert reg.stats() == {}


# ---------------------------------------------------------------------------
# the EuRoC runner
# ---------------------------------------------------------------------------

def test_run_euroc_on_a_synthetic_sequence_on_the_cpu(tmp_path, capsys):
    """write_euroc_sequence's 6 frames through the runner with --device cpu:
    the async system tracks, the TUM file has one line per tracked frame, the
    timing report names frame_total, and a matching --gt prints the ATE."""
    from hfnet_slam_torch.examples import run_euroc
    from hfnet_slam_torch.scenes import write_euroc_sequence
    from hfnet_slam_torch.utils.timing import timings

    seq, cfg, stamps = write_euroc_sequence(str(tmp_path), 6)
    out = str(tmp_path / "traj.txt")
    gt = str(tmp_path / "gt.txt")
    line = np.column_stack([0.01 * np.arange(6), np.zeros(6), 0.002 * np.arange(6) ** 2])
    np.savetxt(gt, np.column_stack([stamps, line, np.zeros((6, 3)), np.ones(6)]))
    timings.reset()
    sys_ = run_euroc.main([seq, "--config", cfg, "--out", out, "--device", "cpu",
                           "--gt", gt])
    text = capsys.readouterr().out
    assert "random HF-Net" in text and "frame_total" in text and "load" in text
    assert sys_.worker is not None and not sys_.worker._thread.is_alive()
    assert timings.stats()["frame_total"][0] == 6
    lines = open(out).read().splitlines()
    assert len(lines) == len(sys_.trajectory) >= 1
    rows = np.loadtxt(out, ndmin=2)
    assert rows.shape == (len(lines), 8) and np.isfinite(rows).all()
    assert set(np.round(rows[:, 0], 6)) <= set(np.round(stamps, 6))
    assert "ATE RMSE" in text
    timings.reset()


def _log_records(log):
    import logging

    records = []

    class Cap(logging.Handler):
        def emit(self, r):
            records.append((r.levelno, r.getMessage()))

    h = Cap()
    log.logger.addHandler(h)
    return records, h


def test_leveled_logger_matches_reference():
    """tests/test_utils.py:250-280 on the port, and the same levels, numbers
    and stdlib severities as the reference's."""
    import logging

    from hfnet_slam_torch.utils import log
    from hfnet_slam_tpu.utils import log as ref

    for name in ("QUIET", "NORMAL", "VERBOSE", "VERY_VERBOSE", "DEBUG"):
        assert getattr(log, name) == getattr(ref, name)
    assert log._PY_LEVEL == ref._PY_LEVEL and log._NAMES == ref._NAMES
    assert log.get_level() == log.QUIET
    records, h = _log_records(log)
    try:
        log.set_level("quiet")
        log.print_mess("hidden", log.NORMAL)
        log.warn("always")
        assert records == [(logging.WARNING, "always")]
        log.set_level("normal")
        log.print_mess("shown", log.NORMAL)
        log.print_mess("hidden2", log.VERBOSE)
        assert [m for _, m in records] == ["always", "shown"]
        log.set_level(log.DEBUG)
        assert log.get_level() == log.DEBUG
        log.print_mess("deep", log.DEBUG)
        assert records[-1] == (logging.DEBUG - 2, "deep")
        for level in (logging.INFO, log.VERBOSE, "very_verbose"):
            log.set_level(level)
            ref.set_level(level)
            assert (log.get_level(), log.logger.level) == (ref.get_level(), ref.logger.level)
    finally:
        log.logger.removeHandler(h)
        log.set_level("quiet")
        ref.set_level("quiet")
