"""The port's mono-inertial runners and settings on the CPU:
  * the settings file's IMU keys give the reference's ImuCalib (float32 bits
    of every noise density and T_b_c1), the defaults included;
  * write_euroc_inertial_sequence's 6 frames through
    examples/run_euroc_inertial with --device cpu: the system is
    visual-inertial, every frame got its IMU rows, and the TUM file has one
    line per tracked frame;
  * the IMU file matches the scene's exact IMU and load_euroc reads it the
    way the reference's does;
  * run_tum_vi's --stereo (ROADMAP.md Queue 1 item 16) on a 3-frame stereo
    copy of that sequence (cam1 = cam0, a Camera2 block and Stereo.T_c1_c2)
    drives track_stereo_inertial with --imu and track_stereo without.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hfnet_slam_torch.scenes import synth_imu, write_euroc_inertial_sequence  # noqa: E402


@pytest.mark.parametrize("with_keys", [True, False])
def test_make_imu_calib_matches_the_reference(tmp_path, with_keys):
    from hfnet_slam_tpu.utils.settings import Settings as JSettings
    from hfnet_slam_torch.scenes import EUROC_CAM0, EUROC_HFNET, EUROC_IMU_SETTINGS, \
        EUROC_SETTINGS
    from hfnet_slam_torch.utils.settings import Settings as TSettings

    text = (EUROC_IMU_SETTINGS if with_keys else EUROC_SETTINGS).format(**EUROC_CAM0,
                                                                         **EUROC_HFNET)
    if with_keys:
        text = text.replace("IMU.NoiseGyro: 1.7e-4", "IMU.NoiseGyro: 1.6e-4").replace(
            "0.0, 1.0, 0.0, 0.0,", "0.0, 0.0, -1.0, 0.02,").replace(
            "0.0, 0.0, 1.0, 0.0,", "0.0, 1.0, 0.0, -0.01,")
    path = tmp_path / "s.yaml"
    path.write_text(text)
    cj = JSettings.from_yaml(str(path), sensor="imu-monocular").make_imu_calib()
    ct = TSettings.from_yaml(str(path), sensor="imu-monocular").make_imu_calib()
    for k in ("sigma_g", "sigma_a", "sigma_gw", "sigma_aw"):
        assert np.float32(getattr(ct, k)) == np.asarray(getattr(cj, k), np.float32), k
    np.testing.assert_array_equal(ct.Tbc_R, np.asarray(cj.Tbc_R, np.float32))
    np.testing.assert_array_equal(ct.Tbc_t, np.asarray(cj.Tbc_t, np.float32))


def test_inertial_sequence_imu_file(tmp_path):
    from hfnet_slam_tpu.utils.datasets import load_euroc as jload
    from hfnet_slam_torch.utils.datasets import load_euroc

    mav0, _, stamps = write_euroc_inertial_sequence(str(tmp_path), 4)
    seq = load_euroc(mav0, with_imu=True)
    jseq = jload(mav0, with_imu=True)
    np.testing.assert_array_equal(seq.imu, jseq.imu)
    rows = seq.imu_between(stamps[0], stamps[1])
    np.testing.assert_array_equal(rows, jseq.imu_between(stamps[0], stamps[1]))
    assert len(rows) == 10  # 50 ms at 200 Hz
    np.testing.assert_allclose(rows[:, :6], synth_imu(0.0, 0.05)[:, :6], atol=1e-5)


def test_run_euroc_inertial_on_a_synthetic_sequence_on_the_cpu(tmp_path, capsys):
    from hfnet_slam_torch.examples import run_euroc_inertial
    from hfnet_slam_torch.utils.timing import timings

    mav0, cfg, stamps = write_euroc_inertial_sequence(str(tmp_path), 6)
    out = str(tmp_path / "traj.txt")
    blocks = []
    timings.reset()
    from hfnet_slam_torch.slam import tracking

    track = tracking.Tracker.track

    def spy(self, feats, timestamp, depth=None, imu=None, right=None):
        blocks.append(0 if imu is None else len(imu))
        return track(self, feats, timestamp, depth=depth, imu=imu, right=right)

    tracking.Tracker.track = spy
    try:
        sys_ = run_euroc_inertial.main([mav0, "--config", cfg, "--out", out,
                                        "--device", "cpu"])
    finally:
        tracking.Tracker.track = track
    text = capsys.readouterr().out
    assert "random HF-Net" in text and "+ IMU" in text and "frame_total" in text
    assert sys_.vi is not None and sys_.tracker.vi is sys_.vi
    assert blocks[0] > 0 and all(b == 10 for b in blocks[1:]), blocks
    lines = open(out).read().splitlines()
    assert len(lines) == len(sys_.trajectory) >= 1
    rows = np.loadtxt(out, ndmin=2)
    assert rows.shape == (len(lines), 8) and np.isfinite(rows).all()
    timings.reset()


def test_stereo_inertial_is_item_16(tmp_path, capsys, monkeypatch):
    import shutil

    from hfnet_slam_torch.examples import run_tum_vi
    from hfnet_slam_torch.slam.system import SLAMSystem

    mav0, cfg, _ = write_euroc_inertial_sequence(str(tmp_path), 3)
    shutil.copytree(f"{mav0}/cam0", f"{mav0}/cam1")
    with open(cfg) as f:
        text = f.read()
    rig = ["Camera2.fx: 458.654", "Camera2.fy: 457.296", "Camera2.cx: 367.215",
           "Camera2.cy: 248.375", "Stereo.T_c1_c2: !!opencv-matrix", "   rows: 4",
           "   cols: 4", "   dt: f", "   data: [1.0, 0.0, 0.0, 0.11, 0.0, 1.0, 0.0, 0.0,",
           "          0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0]"]
    with open(cfg, "w") as f:
        f.write(text + "\n".join(rig) + "\n")
    calls = []
    for name in ("track_stereo", "track_stereo_inertial"):
        real = getattr(SLAMSystem, name)

        def spy(self, *a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(self, *a, **k)

        monkeypatch.setattr(SLAMSystem, name, spy)
    for extra in (["--imu"], []):
        sys_ = run_tum_vi.main([mav0, "--config", cfg, "--stereo", "--device", "cpu",
                                "--out", str(tmp_path / "t.txt"), *extra])
        assert sys_.cam_right is not None and sys_.store.has_right
        assert (sys_.vi is not None) == bool(extra)
    assert calls == ["track_stereo_inertial"] * 3 + ["track_stereo"] * 3
    assert "stereo + IMU" in capsys.readouterr().out
