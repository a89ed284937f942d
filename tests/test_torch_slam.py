"""The port's monocular SLAM slice end to end against the JAX reference
(port on the CPU), and the port's entry-point contract.

The whole-slice test runs the browse trajectory at tests/test_fused.py size
(512 slots, 64-d) for 60 frames with a 0.1 rad camera jolt from frame 40 on,
which sends both packages through reference-keyframe tracking (the
brute-force matcher). Tolerances: first tracked frame within +-1 and the
tracked count within +-2 (the RANSAC samples come from different
generators); port ATE <= max(2 x reference ATE, 0.01 m); fake-extractor
outputs bit-identical."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from _torch_parity import browse_pose, build, run  # noqa: E402
from hfnet_slam_torch.evaluation import ate  # noqa: E402
from hfnet_slam_torch.slam import search as TS  # noqa: E402


def test_fake_extractor_is_bit_identical():
    _, ext_j = build("tpu")
    _, ext_t = build("torch", device="cpu")
    for i in (0, 17, 44, 45):
        R, t = browse_pose(i, jolt_at=40)
        fj, ft = ext_j(R, t), ext_t(R, t)
        np.testing.assert_array_equal(ext_t.last_ids, ext_j.last_ids)
        for name in fj._fields:
            a, b = getattr(ft, name).numpy(), np.asarray(getattr(fj, name))
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_whole_slice_matches_reference_through_a_jolt(monkeypatch):
    from hfnet_slam_tpu.slam.tracking import OK as J_OK
    from hfnet_slam_torch.slam.tracking import OK as T_OK

    sys_j, ext_j = build("tpu")
    est_j, gt_j, ids_j = run(sys_j, ext_j, 0, 60, jolt_at=40)

    calls = []
    real = TS.search_brute_force

    def spy(*a, **kw):
        calls.append(a[0].device.type)
        return real(*a, **kw)

    monkeypatch.setattr(TS, "search_brute_force", spy)
    sys_t, ext_t = build("torch", device="cpu")
    est_t, gt_t, ids_t = run(sys_t, ext_t, 0, 60, jolt_at=40)

    assert sys_j.tracker.state == J_OK and sys_t.tracker.state == T_OK
    assert abs(ids_t[0] - ids_j[0]) <= 1
    assert abs(len(ids_t) - len(ids_j)) <= 2
    assert calls and set(calls) == {"cpu"}  # reference-keyframe tracking ran
    ate_j = ate.ate_rmse(est_j, gt_j, with_scale=True)
    ate_t = ate.ate_rmse(est_t, gt_t, with_scale=True)
    assert np.isfinite(est_t).all()
    assert ate_t <= max(2 * ate_j, 0.01), (ate_t, ate_j)
    s = sys_t.store
    assert np.isfinite(s.mp_pos[s.mp_valid]).all()
    # the map mirrors live on the system's device
    assert s._device_map.pos.device.type == "cpu" and s._kf_bank.desc.device.type == "cpu"


def test_device_none_means_cuda_and_raises_without_it(monkeypatch):
    from hfnet_slam_torch import device as D
    from hfnet_slam_torch.geometry import cameras
    from hfnet_slam_torch.slam.local_mapping import LocalMapper
    from hfnet_slam_torch.slam import retrieval
    from hfnet_slam_torch.slam.map import MapStore
    from hfnet_slam_torch.slam.system import SLAMSystem, SystemConfig
    from hfnet_slam_torch.slam.tracking import Tracker
    from hfnet_slam_torch.models.extractor import HFExtractor
    from hfnet_slam_torch.models.hfnet import HFNet
    from hfnet_slam_torch.examples import run_euroc
    from hfnet_slam_torch.scenes import euroc_hfnet_system
    from hfnet_slam_torch.examples import run_euroc_inertial, run_tum_vi
    from hfnet_slam_torch.geometry.imu import default_calib
    from hfnet_slam_torch.scenes import VI_SMALL, vi_system
    from hfnet_slam_torch.slam.vi import VIManager
    from hfnet_slam_torch import scenes
    from hfnet_slam_torch.examples import run_tum_rgbd

    cam = cameras.pinhole(450.0, 450.0, 320.0, 240.0, 640, 480, device="cpu")
    store = MapStore(8, 64, 16, 8, 8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    # every public entry point: device None means CUDA, and raises here
    for make in (lambda: build("torch", device=None),
                 lambda: SLAMSystem(cam, None, SystemConfig(loop_closing=False)),
                 lambda: SLAMSystem(cam, None, SystemConfig()),
                 lambda: SLAMSystem(cam, None, SystemConfig(async_mapping=True)),
                 lambda: run_euroc.main(["unused_dir", "--config", "unused.yaml"]),
                 lambda: Tracker(cam, store),
                 lambda: LocalMapper(cam, store),
                 lambda: retrieval.score_all(store, np.ones(8, np.float32)),
                 lambda: retrieval.detect_n_best_candidates(store, np.ones(8, np.float32),
                                                            exclude=set()),
                 lambda: retrieval.detect_relocalization_candidates(store,
                                                                    np.ones(8, np.float32)),
                 lambda: cameras.pinhole(450.0, 450.0, 320.0, 240.0, 640, 480),
                 lambda: cameras.kb8(190.0, 190.0, 254.0, 256.0, 0, 0, 0, 0, 512, 512),
                 lambda: HFExtractor(HFNet(), (96, 128)),
                 lambda: HFNet.from_state({}),
                 lambda: euroc_hfnet_system(),
                 lambda: SLAMSystem(cam, None, SystemConfig(), imu_calib=default_calib()),
                 lambda: VIManager(default_calib(), store),
                 lambda: vi_system(VI_SMALL),
                 lambda: run_euroc_inertial.main(["unused_dir", "--config", "unused.yaml"]),
                 lambda: run_tum_vi.main(["unused_dir", "--config", "unused.yaml"]),
                 lambda: run_tum_rgbd.main(["unused_dir", "--config", "unused.yaml"]),
                 lambda: scenes.rgbd_system(scenes.SMALL),
                 lambda: scenes.stereo_system(scenes.SMALL),
                 lambda: scenes.rig_system(scenes.RIG_SMALL),
                 lambda: scenes.stereo_vi_system(VI_SMALL)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    with pytest.raises(RuntimeError, match="CUDA"):
        D.resolve("cuda")
    assert D.resolve("cpu").type == "cpu"


@pytest.mark.parametrize("field,value,item", [
    ("loop_closing", True, "item 14"),
    ("async_mapping", True, "item 14"),
    ("baseline", 0.1, "item 16"),
])
def test_out_of_slice_configs_raise(field, value, item):
    """Loop closing (item 14), the async pipeline (item 14b) and the stereo
    rig (item 16) are in the port now: such systems construct on the CPU,
    wired as the reference wires them."""
    from hfnet_slam_torch.geometry import cameras
    from hfnet_slam_torch.slam.loop_closing import LoopCloser
    from hfnet_slam_torch.slam.system import SLAMSystem, SystemConfig

    cfg = SystemConfig(k_max=8, m_max=64, n_slots=16, desc_dim=8, gdesc_dim=8,
                       loop_closing=False)
    setattr(cfg, field, value)
    cam = cameras.pinhole(450.0, 450.0, 320.0, 240.0, 640, 480, device="cpu")
    if field == "baseline":
        sys_ = SLAMSystem(cam, None, cfg, device="cpu")
        # bf = fx * baseline reaches the tracker and the mapper; no rig
        assert sys_.tracker.cfg.bf == sys_.mapper.cfg.bf == pytest.approx(450.0 * value)
        assert sys_.mapper.cfg.rig is None and not sys_.store.has_right
        cfg.cam_right = cameras.kb8(190.0, 190.0, 254.0, 256.0, 0, 0, 0, 0, 512, 512,
                                    device="cpu")
        cfg.T_lr = (np.eye(3, dtype=np.float32), np.array([0.11, 0, 0], np.float32))
        with pytest.raises(ValueError, match="projection model"):
            SLAMSystem(cam, None, cfg, device="cpu")  # the rig's kinds must agree
        return
    if field == "loop_closing":
        sys_ = SLAMSystem(cam, None, cfg, device="cpu")
        assert isinstance(sys_.loop_closer, LoopCloser)
        assert sys_.tracker.loop_closer is sys_.loop_closer and sys_.loop_closer.system is sys_
        assert sys_.worker is None  # the reference's defaults: loop closing on, sync
        assert isinstance(SLAMSystem(cam, None, SystemConfig(), device="cpu").loop_closer,
                          LoopCloser)
        cfg.async_mapping = True
    sys_ = SLAMSystem(cam, None, cfg, device="cpu")
    try:
        lock = sys_.worker.map_lock
        assert sys_.tracker.worker is sys_.worker
        assert sys_.tracker.lock is sys_.mapper.lock is lock
        if cfg.loop_closing:
            assert sys_.loop_closer.lock is lock
            assert sys_.loop_closer.mapping_worker is sys_.worker
            assert sys_.loop_closer.gba_worker is sys_.gba_worker is not None
            assert sys_.loop_worker is not None
        else:
            assert sys_.loop_worker is None and sys_.gba_worker is None
        sys_.finish()
    finally:
        sys_.shutdown()
    assert not sys_.worker._thread.is_alive()


def test_imu_and_stereo_entry_points_raise():
    from hfnet_slam_torch.slam.tracking import Frame

    sys_t, ext = build("torch", device="cpu")
    # visual-inertial is ported (item 15): a system built without an IMU
    # calibration ignores IMU rows, as the reference's does
    st, _, _ = sys_t.track_features(ext(*browse_pose(0)), 0.0, imu=np.zeros((3, 7), np.float32))
    assert st == 0 and sys_t.tracker.vi is None and sys_t.tracker._imu_since_kf == []
    # stereo and RGB-D are ported (item 16): a mono system's extractor fed
    # two "images" associates them along the rows (baseline 0: no depth)
    R, t = browse_pose(0)
    sys_s, _ = build("torch", device="cpu")
    st, _, _ = sys_s.track_stereo((R, t), (R, t), 0.0)
    assert st == 0 and sys_s.tracker.state == 0  # no close depth: no map yet
    st, _, _ = sys_s.track_rgbd((R, t), np.full((480, 640), 4.0, np.float32), 0.05)
    assert st == 1 and int(sys_s.store.kf_valid.sum()) == 1  # a metric map at once
    # the mesh layer is ported (item 17): install_mesh wires the mapper and
    # every map of the atlas
    from hfnet_slam_torch.parallel.multihost import Mesh
    mesh = Mesh(torch.device("cpu"), 2)
    sys_t.install_mesh(mesh, dist_min_kfs=12, retrieval_min_kfs=16)
    assert sys_t.mapper.mesh is mesh and sys_t.mapper.dist_min_kfs == 12
    assert sys_t.store.retrieval_mesh is mesh and sys_t.store.retrieval_min_kfs == 16
    # relocalization is ported: on an empty map it finds no candidate
    assert sys_t.tracker._relocalize(Frame(feats=ext(*browse_pose(0)), timestamp=0.0)) is False


def test_save_and_load_map_round_trip(tmp_path):
    sys_t, ext = build("torch", device="cpu")
    run(sys_t, ext, 0, 20)
    assert sys_t.store.kf_valid.sum() >= 2
    path = str(tmp_path / "map.npz")
    sys_t.save_map(path)
    fresh, _ = build("torch", device="cpu")
    fresh.load_map(path)
    for f in ("kf_R", "kf_obs", "mp_pos", "mp_desc", "mp_valid", "covis"):
        np.testing.assert_array_equal(getattr(fresh.store, f), getattr(sys_t.store, f))
    assert fresh.tracker.store is fresh.store and fresh.mapper.store is fresh.store
    # the reference reads the port's snapshot
    from hfnet_slam_tpu.slam.map import MapStore as JMapStore

    np.testing.assert_array_equal(JMapStore.load(path).mp_pos, sys_t.store.mp_pos)


@pytest.fixture(scope="module")
def tracked_20():
    sys_t, ext = build("torch", device="cpu")
    run(sys_t, ext, 0, 20)
    store = sys_t.store
    # move one keyframe, as a correction would: recovery follows it
    k = int(store.valid_kf_ids()[-1])
    store.kf_t[k] = store.kf_t[k] + np.float32(0.05)
    return sys_t


@pytest.mark.parametrize("fn", ["recovered", "recovered_resolved", "keyframe_trajectory"])
def test_trajectory_recovery_matches_reference(tracked_20, fn):
    """The port's trajectory recovery against the reference's functions on
    the same tracked trajectory and store: timestamps and poses exactly. A
    plain (ts, R, t) tuple is kept as it is by recovered() and skipped by
    recovered_resolved()."""
    from hfnet_slam_tpu.utils import trajectory as JTJ
    from hfnet_slam_torch.utils import trajectory as TJ

    sys_t = tracked_20
    store = sys_t.store
    traj = list(sys_t.trajectory) + [(9.0, np.eye(3, dtype=np.float32),
                                      np.ones(3, np.float32))]
    if fn == "keyframe_trajectory":
        out_t, out_j = TJ.keyframe_trajectory(store), JTJ.keyframe_trajectory(store)
        assert len(out_t) == int(store.kf_valid.sum()) >= 2
    elif fn == "recovered":
        out_t, out_j = TJ.recovered(traj), JTJ.recovered(traj)
        assert len(out_t) == len(traj)
    else:
        out_t, out_j = TJ.recovered_resolved(traj, store=store), \
            JTJ.recovered_resolved(traj, store=store)
        assert out_t[2] == out_j[2] and 0.0 < out_t[2] < 1.0
        for a, b in zip(out_t[1], out_j[1]):
            assert a[0] == b[0]
            np.testing.assert_array_equal(a[1], b[1])
            np.testing.assert_array_equal(a[2], b[2])
        out_t, out_j = out_t[0], out_j[0]
    assert len(out_t) == len(out_j) > 0
    for a, b in zip(out_t, out_j):
        assert a[0] == b[0]
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[2], b[2])
    if fn != "keyframe_trajectory":
        # the moved keyframe moved the frames that hang on it
        live = {e.ts: e.t for e in sys_t.trajectory}
        assert any(not np.allclose(t, live[ts]) for ts, _, t in out_t if ts in live)
