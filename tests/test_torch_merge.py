"""Map merging of the port against the JAX reference (port on the CPU):
tests/test_merge.py's test_merge_grows_target_beyond_capacity on both
packages, with the same inputs. Remaps, capacities and every array of the
merged store equal the reference's exactly; the world transform of a Sim3
hit within 1e-5."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hfnet_slam_tpu import lie as JL  # noqa: E402


def _build(cls, n_kf, n_mp, k_max, m_max, rng):
    st = cls(k_max=k_max, m_max=m_max, n_slots=16, desc_dim=8, gdesc_dim=8)
    descs = rng.normal(size=(n_mp, 8)).astype(np.float32)
    descs /= np.linalg.norm(descs, axis=1, keepdims=True)
    ids = st.add_points(rng.normal(size=(n_mp, 3)).astype(np.float32), descs)

    class F:
        xy = rng.uniform(0, 100, (16, 2)).astype(np.float32)
        score = np.ones(16, np.float32)
        octave = np.zeros(16, np.int32)
        desc = np.zeros((16, 8), np.float32)
        mask = np.ones(16, bool)
        global_desc = np.ones(8, np.float32)

    for i in range(n_kf):
        obs = np.full(16, -1, np.int32)
        obs[:4] = ids[(4 * i) % n_mp: (4 * i) % n_mp + 4]
        st.add_keyframe(np.eye(3), np.full(3, 0.1 * i), F(), float(i), obs=obs)
    st.loop_edges.append((1, 9))
    return st


def _pair(cls):
    rng = np.random.default_rng(0)
    return (_build(cls, 12, 96, 16, 128, rng), _build(cls, 6, 48, 8, 64, rng))


def test_merge_grows_target_beyond_capacity():
    from hfnet_slam_tpu.slam import merging as JM
    from hfnet_slam_tpu.slam.map import MapStore as JStore
    from hfnet_slam_torch.slam import merging as TM
    from hfnet_slam_torch.slam.map import MapStore as TStore

    (aj, tj), (at, tt) = _pair(JStore), _pair(TStore)
    n_kf_a, n_mp_a = int(at.kf_valid.sum()), int(at.mp_valid.sum())
    n_kf_t, n_mp_t = int(tt.kf_valid.sum()), int(tt.mp_valid.sum())
    R = np.asarray(JL.so3_exp(np.asarray([0.1, -0.2, 0.3], np.float32)))
    G = (R, np.array([0.5, -1.0, 2.0], np.float32), 1.3)
    kj, mj = JM.merge_into(aj, tj, G)
    kt, mt = TM.merge_into(at, tt, G)
    assert kt == kj and mt == mj
    assert len(kt) == n_kf_a and len(mt) == n_mp_a
    assert int(tt.kf_valid.sum()) == n_kf_a + n_kf_t
    assert int(tt.mp_valid.sum()) == n_mp_a + n_mp_t
    assert (tt.k_max, tt.m_max) == (tj.k_max, tj.m_max) and tt.k_max > 8 and tt.m_max > 64
    for f in ("kf_R", "kf_t", "kf_obs", "kf_parent", "kf_valid", "mp_pos", "mp_valid",
              "mp_first_kf", "mp_obs_count", "covis", "kf_uid"):
        np.testing.assert_array_equal(getattr(tt, f), getattr(tj, f), err_msg=f)
    assert tt.loop_edges == tj.loop_edges and len(tt.loop_edges) == 2
    live = tt.kf_obs[tt.valid_kf_ids()]
    assert tt.mp_valid[live[live >= 0]].all()


def test_compute_world_transform_matches_reference():
    from hfnet_slam_tpu.slam import merging as JM
    from hfnet_slam_tpu.slam.map import MapStore as JStore
    from hfnet_slam_torch.slam import merging as TM
    from hfnet_slam_torch.slam.map import MapStore as TStore

    (aj, tj), (at, tt) = _pair(JStore), _pair(TStore)
    R_cm = np.asarray(JL.so3_exp(np.asarray([0.05, 0.2, -0.1], np.float32)))
    t_cm = np.array([0.3, 0.1, -0.2], np.float32)
    Gj = JM.compute_world_transform(aj, tj, 7, 2, R_cm, t_cm, 0.8)
    Gt = TM.compute_world_transform(at, tt, 7, 2, R_cm, t_cm, 0.8)
    for a, b in zip(Gj, Gt):
        np.testing.assert_allclose(b, a, atol=1e-5)


def _merge_spec(size):
    """tests/test_merge.py's merge_run: a short RECENTLY_LOST window and an
    impossible relocalization gate send the blackout to LOST, the mature map
    is stored and a new one starts; loop closing (on, sync) merges them."""
    from _torch_parity import browse_spec

    sp = browse_spec(size)
    sp["world"]["n_landmarks"] = 1600
    sp["ext"]["max_landmarks_per_frame"] = 480
    sp["system"].update(k_max=192, m_max=16384, loop_closing=True)
    sp["tracker"].update(local_mp_cap=2048, min_init_med_parallax_deg=2.0,
                         recently_lost_frames=4, min_reloc_inliers=10**9, mature_map_kfs=3,
                         kf_ref_ratio=0.95)
    sp["loop"] = dict(min_pair_matches=30, min_sim3_inliers=15, min_proj_matches=30,
                      consistency_hits=1, n_covis_window=5, window_mp_cap=2048,
                      gba_kf_cap=48, gba_mp_cap=4096, gba_edge_cap=16384, ransac_hyps=256)
    return sp


def test_lost_map_is_stored_and_merged_back():
    """SLAMSystem.execute_merge / weld_after_merge through LoopCloser's
    _try_merge, on the port (CPU): the blackout at frames 50-57 loses the
    track, a new map starts, and place recognition welds it into the stored
    map; the merged store is one consistent map and tracking continues."""
    torch.set_num_threads(2)
    from _torch_parity import SMALL, browse_pose, build
    from hfnet_slam_torch.models.extractor import Features
    from hfnet_slam_torch.slam.tracking import OK

    sys_, ext = build("torch", device="cpu", size=SMALL, spec=_merge_spec)
    empty = Features(xy=torch.zeros((512, 2)), score=torch.zeros(512),
                     octave=torch.zeros(512, dtype=torch.int32), desc=torch.zeros((512, 64)),
                     mask=torch.zeros(512, dtype=torch.bool), global_desc=torch.zeros(64))
    lost, merged_at = False, -1
    for i in range(160):
        sys_.track_features(empty if 50 <= i < 58 else ext(*browse_pose(i)), 0.05 * i)
        lost |= sys_.atlas.n_maps() > 1
        if lost and merged_at < 0 and sys_.atlas.n_maps() == 1:
            merged_at = i
    assert lost, "the blackout never forced a second map"
    assert merged_at > 0 and sys_.loop_closer.stats["merged"] >= 1, sys_.loop_closer.stats
    assert sys_.tracker.state == OK and sys_.atlas.n_maps() == 1
    store = sys_.store
    kfs = store.valid_kf_ids()
    assert (store.covis[np.ix_(kfs, kfs)] > 0).any()
    live = store.kf_obs[kfs]
    assert store.mp_valid[live[live >= 0]].all()
    assert sys_.tracker.store is store and sys_.loop_closer.store is store


def test_merge_into_a_later_map_makes_it_active():
    """With three maps of one size, a merge of the active map into map 1
    leaves map 1 active. The reference re-finds the target with list.index,
    whose dataclass equality compares only the capacities, and so activates
    map 0 (slam/system.py:356, ROADMAP Queue 3 (l)); the port finds it by
    identity (Atlas.index_of)."""
    from hfnet_slam_torch.scenes import SMALL, browse_system
    from hfnet_slam_torch.slam.map import MapStore as TStore

    sys_, _ = browse_system(SMALL, "cpu")
    rng = np.random.default_rng(0)
    first, target, active = (_build(TStore, n, 48, 16, 128, rng) for n in (4, 6, 5))
    sys_.atlas.maps = [first, target, active]
    sys_.atlas.active_idx = 2
    sys_._rewire(active)
    k_new = sys_.execute_merge(1, 0, 0, np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
                               1.0, [])
    assert k_new is not False
    assert sys_.atlas.n_maps() == 2 and sys_.atlas.active_idx == 1
    assert sys_.store is target and sys_.tracker.store is target
    assert int(target.kf_valid.sum()) == 11
