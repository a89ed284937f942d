"""The async mapping/loop/GBA pipeline of the port against the JAX reference
(port on the CPU), and atlas persistence.

A free-running async run is not reproducible: the threads interleave as the
host schedules them. The parity tests therefore run lockstep, finish() after
every frame, which makes both packages deterministic; the worker threads
still do all the mapping, loop closing and global BA. Tolerances:
  * the browse slice (tests/test_torch_slam.py's jolted 60 frames): keyframe
    and map-point counts equal; first tracked frame within +-1, the tracked
    count within +-2 and ATE <= max(2 x reference, 0.01 m), PR 1's slice
    tolerances;
  * the SMALL loop circuit (170 frames): the same loop edges and correction
    counts, and post-correction ATE <= max(2 x reference, 0.02 m);
  * free-running async (tests/test_slam.py's async quality test): ATE under
    8% of the path, at most 20 frames untracked.
The lock-discipline test is the fast form of tests/test_loop.py's
test_tracking_not_blocked_by_correction: the main thread must take the map
lock while the correction's pose-graph solve runs."""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from _torch_parity import LOOP_SMALL, browse_pose, build, build_loop, run, run_loop  # noqa: E402
from hfnet_slam_torch.evaluation import ate  # noqa: E402


def test_lockstep_browse_matches_reference():
    from hfnet_slam_tpu.slam.tracking import OK as J_OK
    from hfnet_slam_torch.slam.tracking import OK as T_OK

    sys_j, ext_j = build("tpu", async_mapping=True)
    sys_t, ext_t = build("torch", device="cpu", async_mapping=True)
    try:
        assert sys_j.worker is not None and sys_t.worker is not None
        est_j, gt_j, ids_j = run(sys_j, ext_j, 0, 60, jolt_at=40, lockstep=True)
        est_t, gt_t, ids_t = run(sys_t, ext_t, 0, 60, jolt_at=40, lockstep=True)
        assert sys_j.tracker.state == J_OK and sys_t.tracker.state == T_OK
        assert sys_t.worker.processed == sys_j.worker.processed >= 1
    finally:
        sys_j.shutdown()
        sys_t.shutdown()
    sj, st = sys_j.store, sys_t.store
    assert int(st.kf_valid.sum()) == int(sj.kf_valid.sum())
    assert int(st.mp_valid.sum()) == int(sj.mp_valid.sum())
    assert abs(ids_t[0] - ids_j[0]) <= 1 and abs(len(ids_t) - len(ids_j)) <= 2
    ate_j = ate.ate_rmse(est_j, gt_j, with_scale=True)
    ate_t = ate.ate_rmse(est_t, gt_t, with_scale=True)
    assert np.isfinite(est_t).all() and ate_t <= max(2 * ate_j, 0.01), (ate_t, ate_j)


def test_lockstep_loop_circuit_matches_reference():
    sys_j, ext_j = build_loop("tpu", async_mapping=True)
    sys_t, ext_t = build_loop("torch", device="cpu", async_mapping=True)
    try:
        _, post_j, n_j = run_loop(sys_j, ext_j, LOOP_SMALL, lockstep=True)
        _, post_t, n_t = run_loop(sys_t, ext_t, LOOP_SMALL, lockstep=True)
    finally:
        sys_j.shutdown()
        sys_t.shutdown()
    lj, lt = sys_j.loop_closer.stats, sys_t.loop_closer.stats
    assert lt["corrected"] >= 1 and lt["corrected"] == lj["corrected"], (lt, lj)
    assert sys_t.store.loop_edges == sys_j.store.loop_edges
    # the corrections' global BA ran on the detached worker and completed
    assert sys_t.gba_worker.full_ba_idx >= 1
    assert sys_t.loop_worker.processed >= 1
    assert abs(n_t - n_j) <= 5
    assert np.isfinite(post_t) and post_t <= max(2 * post_j, 0.02), (post_t, post_j)


def test_free_running_async_matches_sync_quality():
    """tests/test_slam.py::test_async_pipeline_matches_sync_quality on the
    port: mapping off the tracking thread, no lockstep."""
    from hfnet_slam_torch.geometry import cameras
    from hfnet_slam_torch.models.fake import FakeExtractor, SyntheticWorld
    from hfnet_slam_torch.slam.local_mapping import MapperConfig
    from hfnet_slam_torch.slam.system import SLAMSystem, SystemConfig
    from hfnet_slam_torch.slam.tracking import OK, TrackerConfig

    cam = cameras.pinhole(450.0, 450.0, 320.0, 240.0, 640, 480, device="cpu")
    world = SyntheticWorld.cloud(seed=5, n_landmarks=1400, extent=16.0, center=(0, 0, 10.0),
                                 desc_dim=64)
    ext = FakeExtractor(world, cam, pad_to=512, noise_px=0.3, desc_noise=0.03,
                        max_landmarks_per_frame=480, seed=7, device="cpu")
    cfg = SystemConfig(k_max=128, m_max=8192, n_slots=512, desc_dim=64, gdesc_dim=64,
                       async_mapping=True,
                       tracker=TrackerConfig(local_mp_cap=2048, min_init_med_parallax_deg=4.0),
                       mapper=MapperConfig(ba_kf_cap=16, ba_mp_cap=2048, ba_edge_cap=8192,
                                           tri_neighbors=5))
    sys_ = SLAMSystem(cam, ext, cfg, device="cpu")
    try:
        assert sys_.worker is not None and sys_.tracker.lock is sys_.worker.map_lock
        est, gtc = [], []
        for i in range(80):
            R, t = browse_pose(i)
            _, Re, te = sys_.track_features(ext(R, t), 0.05 * i)
            if Re is not None:
                est.append(-Re.T @ te)
                gtc.append(-R.T @ t)
        sys_.finish()  # re-raises a worker exception
        assert sys_.tracker.state == OK
    finally:
        sys_.shutdown()
    est, gtc = np.asarray(est), np.asarray(gtc)
    assert len(est) >= 80 - 20
    store = sys_.store
    assert store.kf_valid.sum() >= 3 and store.mp_valid.sum() >= 200
    err = ate.ate_rmse(est, gtc, with_scale=True)
    path = np.linalg.norm(np.diff(gtc, axis=0), axis=1).sum()
    assert err < 0.08 * path, f"async ATE {err:.3f} m over {path:.1f} m path"
    assert not sys_.worker._thread.is_alive()  # shutdown() stopped the worker


def test_tracking_takes_the_map_lock_during_a_correction(tmp_path, monkeypatch):
    """One loop correction on tests/test_torch_loop.py's drifted-ring
    snapshot, on a worker thread with the shared RLock: its pose-graph solve
    (held 1 s longer here) and its fuse kernel run without the lock, so the
    main thread takes the lock during the solve at once."""
    from test_torch_loop import _drifted_ring
    from _torch_parity import cams
    from hfnet_slam_torch.convert import store_from_reference
    from hfnet_slam_torch.slam import fused
    from hfnet_slam_torch.slam import loop_closing as LC
    from hfnet_slam_torch.slam.local_mapping import LocalMapper, MapperConfig

    path = str(tmp_path / "ring.npz")
    _drifted_ring(path)
    store = store_from_reference(path)
    cam = cams()[1]
    lock = threading.RLock()
    mapper = LocalMapper(cam, store, MapperConfig(), device="cpu")
    lc = LC.LoopCloser(cam, store, LC.LoopCloserConfig(
        min_pair_matches=30, min_sim3_inliers=15, min_proj_matches=30, consistency_hits=1,
        n_covis_window=5, window_mp_cap=512, pair_cap=256, ransac_hyps=128, run_gba=False),
        mapper=mapper, device="cpu")
    lc.lock = mapper.lock = lock
    in_solve, fuse_owned = threading.Event(), []
    real_pg, real_fuse = LC.pg.optimize_pose_graph, fused.fuse_targets_banked

    def slow_pg(*a, **kw):
        in_solve.set()
        time.sleep(1.0)
        return real_pg(*a, **kw)

    def fuse(*a, **kw):
        fuse_owned.append(lock._is_owned())
        return real_fuse(*a, **kw)

    monkeypatch.setattr(LC.pg, "optimize_pose_graph", slow_pg)
    monkeypatch.setattr(fused, "fuse_targets_banked", fuse)
    kf_t0 = store.kf_t.copy()
    out = []
    th = threading.Thread(target=lambda: out.append(lc.process_keyframe(23)), name="hfnet-loop")
    th.start()
    try:
        assert in_solve.wait(120), "the correction never reached its pose-graph solve"
        t0 = time.monotonic()
        assert lock.acquire(timeout=0.5), "the correction held the map lock through its solve"
        waited = time.monotonic() - t0
        lock.release()
    finally:
        th.join(timeout=120)
    assert waited < 0.5 and out == [True]
    assert fuse_owned == [False]  # the fuse kernel ran without the lock
    assert lc.stats["corrected"] == 1 and store.loop_edges == [(lc.last_loop[1], 23)]
    assert not np.allclose(store.kf_t[store.kf_valid], kf_t0[store.kf_valid])


# ---------------------------------------------------------------------------
# atlas persistence
# ---------------------------------------------------------------------------

def _assert_maps_equal(a, b):
    from hfnet_slam_torch.slam.map import _ARRAY_FIELDS

    for f in _ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert (a.k_max, a.m_max, a.n_slots, a.desc_dim, a.gdesc_dim) == \
        (b.k_max, b.m_max, b.n_slots, b.desc_dim, b.gdesc_dim)
    assert list(map(tuple, a.loop_edges)) == list(map(tuple, b.loop_edges))
    assert (a.n_kf, a.n_mp, a._next_uid) == (b.n_kf, b.n_mp, b._next_uid)
    assert list(a._free_kf) == list(b._free_kf) and list(a._free_mp) == list(b._free_mp)


def test_atlas_written_by_the_port_loads_in_the_reference(tmp_path):
    from hfnet_slam_tpu.slam.atlas import Atlas as JAtlas

    sys_t, ext = build("torch", device="cpu")
    run(sys_t, ext, 0, 20)
    sys_t.atlas.create_new_map()  # a second, empty map; it becomes the active one
    p = str(tmp_path / "atlas")
    sys_t.save_atlas(p)
    ja = JAtlas.load(p)
    assert ja.n_maps() == 2 and ja.active_idx == 1
    for a, b in zip(sys_t.atlas.maps, ja.maps):
        _assert_maps_equal(a, b)
    assert sys_t.atlas.maps[0].kf_valid.sum() >= 2
    # and back into a fresh port system
    fresh, _ = build("torch", device="cpu")
    fresh.load_atlas(p)
    for a, b in zip(sys_t.atlas.maps, fresh.atlas.maps):
        _assert_maps_equal(a, b)
    assert fresh.tracker.store is fresh.store is fresh.atlas.maps[1]


def test_atlas_written_by_the_reference_loads_in_the_port(tmp_path):
    from test_gba import circle_store
    from hfnet_slam_tpu.slam.atlas import Atlas as JAtlas

    store_j, _, _, _ = circle_store(K=20, P=200, obs_per_kf=25, seed=3)
    store_j.loop_edges.append((0, 19))
    store_j.remove_keyframe(7)
    ja = JAtlas(store_j.k_max, store_j.m_max, store_j.n_slots, store_j.desc_dim,
                store_j.gdesc_dim)
    ja.maps = [ja.maps[0], store_j]
    ja.active_idx = 1
    p = str(tmp_path / "atlas")
    ja.save(p)
    sys_t, _ = build("torch", device="cpu")
    sys_t.load_atlas(p)
    assert sys_t.atlas.n_maps() == 2 and sys_t.atlas.active_idx == 1
    for a, b in zip(ja.maps, sys_t.atlas.maps):
        _assert_maps_equal(a, b)
    assert sys_t.store is sys_t.mapper.store is sys_t.tracker.store is sys_t.atlas.maps[1]


def test_atlas_checksum_guard(tmp_path):
    """tests/test_utils.py::test_atlas_checksum_guard on the port: one flipped
    byte in a map file makes load refuse the snapshot."""
    from hfnet_slam_torch.slam.atlas import Atlas

    a = Atlas(4, 16, 8, 8, 8)
    a.active.kf_valid[0] = True
    a.active.n_kf = 1
    p = tmp_path / "snap"
    a.save(str(p))
    assert Atlas.load(str(p)).active.kf_valid[0]
    f = p / "map_0.npz"
    raw = bytearray(f.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    f.write_bytes(bytes(raw))
    with pytest.raises(IOError, match="md5"):
        Atlas.load(str(p))


def test_atlas_create_and_reset():
    """tests/test_reloc.py::TestAtlas::test_create_and_reset on the port."""
    from hfnet_slam_torch.slam.atlas import Atlas

    atlas = Atlas(16, 64, 8, 8, 8)
    m0 = atlas.active
    m0.kf_valid[:5] = True
    m1 = atlas.create_new_map()
    assert atlas.n_maps() == 2 and atlas.active is m1
    assert atlas.maps[0].kf_valid.sum() == 5
    atlas.reset_active_map()
    assert atlas.n_maps() == 2 and atlas.active.kf_valid.sum() == 0


def test_atlas_save_load_roundtrip(tmp_path):
    """tests/test_reloc.py::TestAtlas::test_save_load_roundtrip on the port."""
    from hfnet_slam_torch.slam.atlas import Atlas

    atlas = Atlas(16, 64, 8, 8, 8)
    atlas.active.kf_valid[:3] = True
    atlas.active.kf_gdesc[:3] = 0.5
    atlas.create_new_map()
    atlas.active.kf_valid[:1] = True
    p = tmp_path / "atlas"
    atlas.save(p)
    a2 = Atlas.load(p)
    assert a2.n_maps() == 2 and a2.active_idx == 1
    assert a2.maps[0].kf_valid.sum() == 3
    np.testing.assert_allclose(a2.maps[0].kf_gdesc[:3], 0.5)


def test_async_system_survives_keyframe_overflow():
    """tests/test_growth.py::test_system_survives_keyframe_overflow in the
    async pipeline: the mapping worker grows the store past a 4-keyframe
    capacity (the device mirrors re-upload) instead of dropping keyframes."""
    from hfnet_slam_torch.geometry import cameras
    from hfnet_slam_torch.models.fake import FakeExtractor, SyntheticWorld
    from hfnet_slam_torch.slam.local_mapping import MapperConfig
    from hfnet_slam_torch.slam.system import SLAMSystem, SystemConfig
    from hfnet_slam_torch.slam.tracking import OK, TrackerConfig

    cam = cameras.pinhole(450.0, 450.0, 320.0, 240.0, 640, 480, device="cpu")
    world = SyntheticWorld.cloud(seed=5, n_landmarks=1200, extent=16.0, center=(0, 0, 10.0),
                                 desc_dim=64)
    ext = FakeExtractor(world, cam, pad_to=512, noise_px=0.3, desc_noise=0.03,
                        max_landmarks_per_frame=420, seed=7, device="cpu")
    cfg = SystemConfig(k_max=4, m_max=2048, n_slots=512, desc_dim=64, gdesc_dim=64,
                       loop_closing=False, async_mapping=True,
                       tracker=TrackerConfig(local_mp_cap=1024, min_init_med_parallax_deg=4.0,
                                             max_frames_between_kf=3),
                       mapper=MapperConfig(ba_kf_cap=16, ba_mp_cap=2048, ba_edge_cap=8192,
                                           tri_neighbors=5, kf_cull_min_age=10 ** 6))
    sys_ = SLAMSystem(cam, ext, cfg, device="cpu")

    def pose(i):  # tests/test_growth.py's fast sweep
        th, r = 0.03 * i, 10.0
        c = np.array([r * np.sin(th), 0.4 * np.sin(0.07 * i), r - r * np.cos(th)])
        fwd = np.array([0.0, 0.0, r]) - c
        fwd /= np.linalg.norm(fwd)
        right = np.cross(np.array([0.0, 1.0, 0.0]), fwd)
        right /= np.linalg.norm(right)
        R_wc = np.stack([right, np.cross(fwd, right), fwd], 1)
        return R_wc.T.astype(np.float32), (-R_wc.T @ c).astype(np.float32)

    try:
        for i in range(80):
            sys_.track_features(ext(*pose(i)), 0.05 * i)
        sys_.finish()
        assert sys_.tracker.state == OK
        assert sys_.store.k_max > 4, "store never grew"
        with sys_.worker.map_lock:
            assert sys_.store._kf_bank.desc.shape[0] == sys_.store.k_max
    finally:
        sys_.shutdown()
