"""The port's TUM RGB-D input on the CPU:
  * the 16-bit grayscale PNG reader against Pillow (the reference's reader)
    on files written under each row filter 0-4, and the port's writer;
  * write_tum_rgbd_sequence read by both packages: the same associated
    pairs and the same depth maps in metres;
  * examples/run_tum_rgbd on a 6-frame sequence with --device cpu: the depth
    map factor is applied once, so the first keyframe's depths are the
    written plane's in metres (the reference's runner divides twice,
    ROADMAP.md Queue 3), and the TUM file has one line per tracked frame.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_utils import _encode  # noqa: E402


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_16_bit_png_reader_matches_pillow(tmp_path, ftype):
    from PIL import Image

    from hfnet_slam_torch.utils.datasets import read_png, write_png

    rng = np.random.default_rng(ftype)
    img = rng.integers(0, 65536, (11, 17)).astype(np.uint16)
    img[3:6, 4:9] = 10000  # flat runs, as depth maps have
    p = str(tmp_path / "d.png")
    open(p, "wb").write(_encode(img, ftype))
    got = read_png(p)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(got, np.asarray(Image.open(p)))
    q = str(tmp_path / "ours.png")
    write_png(q, img)
    np.testing.assert_array_equal(np.asarray(Image.open(q)), img)


def test_tum_rgbd_sequence_reads_alike_in_both_packages(tmp_path):
    from hfnet_slam_tpu.utils.datasets import load_tum_rgbd as jload
    from hfnet_slam_torch.scenes import TUM_DEPTH_FACTOR, tum_plane_depth, write_tum_rgbd_sequence
    from hfnet_slam_torch.utils.datasets import load_tum_rgbd

    seq_dir, _, stamps = write_tum_rgbd_sequence(str(tmp_path), 3)
    st, sj = load_tum_rgbd(seq_dir, TUM_DEPTH_FACTOR), jload(seq_dir, TUM_DEPTH_FACTOR)
    assert (st.image_paths, st.depth_paths) == (sj.image_paths, sj.depth_paths)
    np.testing.assert_array_equal(st.timestamps, stamps)
    for i in range(3):
        np.testing.assert_array_equal(st.depth(i), sj.depth(i))
        np.testing.assert_array_equal(st.image(i), sj.image(i))
    np.testing.assert_allclose(st.depth(0), tum_plane_depth(480, 640), atol=1e-4)


def test_run_tum_rgbd_applies_the_depth_factor_once(tmp_path, capsys):
    from hfnet_slam_torch.examples import run_tum_rgbd
    from hfnet_slam_torch.scenes import tum_plane_depth, write_tum_rgbd_sequence
    from hfnet_slam_torch.utils.timing import timings

    seq_dir, cfg, stamps = write_tum_rgbd_sequence(str(tmp_path), 6)
    out = str(tmp_path / "traj.txt")
    timings.reset()
    sys_ = run_tum_rgbd.main([seq_dir, "--config", cfg, "--out", out, "--device", "cpu"])
    text = capsys.readouterr().out
    assert "random HF-Net" in text and "extract" in text and "frame_total" in text
    assert sys_.cfg.depth_factor == 1.0
    s = sys_.store
    k0 = int(s.valid_kf_ids()[0])
    assert s.kf_timestamp[k0] == stamps[0]  # depth seeds the map at frame 0
    d = s.kf_depth[k0]
    ok = d > 0
    assert ok.sum() >= sys_.cfg.tracker.min_stereo_init_points
    # the written plane at each keypoint's (distorted, raw) pixel; kf_xy is
    # undistorted, so compare the medians, which the tilt barely moves
    written = tum_plane_depth(480, 640)[0]
    med, want = float(np.median(d[ok])), float(np.median(written))
    print(f"first keyframe: median depth {med:.4f} m, written {want:.4f} m")
    assert abs(med - want) <= 0.02 * want
    lines = open(out).read().splitlines()
    assert len(lines) == len(sys_.trajectory) >= 1
    rows = np.loadtxt(out, ndmin=2)
    assert rows.shape[1] == 8 and np.isfinite(rows).all()
    assert set(np.round(rows[:, 0], 6)) <= set(np.round(stamps, 6))
    timings.reset()
