"""Parity of the port's fused tracking and banked mapping kernels with the
JAX reference, from state carried over from a reference run.

The reference tracks 45 browse frames at test size (512 slots, 64-d) and
saves its map; the port loads that snapshot (convert.store_from_reference)
and both packages then run the same step on the same inputs.

Tolerances: observation vectors, match indices and gate masks exactly;
poses 1e-4 (two float32 pose LMs of 20 steps each); triangulated points
1e-3 relative."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from _torch_parity import browse_pose, build  # noqa: E402

from hfnet_slam_torch import convert  # noqa: E402
from hfnet_slam_torch.models.extractor import Features as TFeatures  # noqa: E402
from hfnet_slam_torch.slam import fused as Tfused  # noqa: E402
from hfnet_slam_torch.slam.map import MapStore as TMapStore  # noqa: E402

N_WARM = 45


def T(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    """Reference system after N_WARM frames, its saved map, the features of
    the next frame, and the port store loaded from the snapshot."""
    from hfnet_slam_tpu.slam.tracking import OK

    ref, ext = build("tpu")
    for i in range(N_WARM):
        R, t = browse_pose(i)
        ref.track_features(ext(R, t), 0.05 * i)
    assert ref.tracker.state == OK
    path = os.path.join(tmp_path_factory.mktemp("carried"), "map.npz")
    ref.save_map(path)
    R, t = browse_pose(N_WARM)
    feats = ext(R, t)
    port_store = convert.store_from_reference(path)
    return ref, feats, port_store, path


def _port_feats(feats):
    return TFeatures(*(torch.from_numpy(np.array(x)) for x in feats))


def test_store_round_trips_the_reference_snapshot(carried):
    ref, _, port_store, path = carried
    s = ref.store
    for f in ("kf_R", "kf_t", "kf_valid", "kf_obs", "kf_desc", "mp_pos", "mp_desc",
              "mp_valid", "mp_obs_count", "covis", "kf_uid"):
        np.testing.assert_array_equal(getattr(port_store, f), getattr(s, f), err_msg=f)
    assert (port_store.n_kf, port_store.n_mp) == (s.n_kf, s.n_mp)
    assert port_store._free_mp == s._free_mp and port_store._uid_slot == s._uid_slot
    # and back: the port's snapshot loads in the reference
    from hfnet_slam_tpu.slam.map import MapStore as JMapStore

    out = path.replace(".npz", "_port.npz")
    port_store.save(out)
    back = JMapStore.load(out)
    np.testing.assert_array_equal(back.mp_pos, s.mp_pos)
    np.testing.assert_array_equal(back.kf_obs, s.kf_obs)


def test_track_step_from_carried_state(carried):
    """Frame N_WARM + 1 through both packages' track_step from the same map
    and tracker state: the per-slot observations agree exactly and the pose
    within 1e-4."""
    from hfnet_slam_tpu.slam import fused as Jfused

    ref, feats, port_store, _ = carried
    tr = ref.tracker
    R0, t0 = tr._predicted_pose()
    last_obs = tr.last_frame.obs
    mp_ids = np.unique(last_obs[last_obs >= 0])
    mp_ids = mp_ids[ref.store.mp_valid[mp_ids]]
    motion_ids = np.full(ref.store.n_slots, -1, np.int32)
    motion_ids[:len(mp_ids)] = mp_ids
    local_ids = tr._local_ids
    z = np.zeros(ref.store.n_slots, np.float32)
    dm = Jfused.get_device_map(ref.store)
    dm.sync()
    cam = tr.cam
    out_j = Jfused.track_step(cam.kind, cam.params, 640.0, 480.0, R0, t0, dm.pos, dm.desc,
                              dm.normal, dm.dmin, dm.dmax, dm.valid, motion_ids, local_ids,
                              feats.xy, feats.desc, feats.octave, feats.mask, z, z,
                              tr._fused_cfg)
    out_j = {k: np.asarray(v) for k, v in out_j.items()}

    from hfnet_slam_torch.geometry import cameras as Tcam

    ct = Tcam.pinhole(450.0, 450.0, 320.0, 240.0, 640, 480, device="cpu")
    tdm = Tfused.get_device_map(port_store, "cpu")
    tdm.sync()
    f = _port_feats(feats)
    cfg = Tfused.FusedConfig(*tr._fused_cfg)
    out_t = Tfused.track_step(ct.kind, ct.params, 640.0, 480.0, T(R0), T(t0), tdm.pos,
                              tdm.desc, tdm.normal, tdm.dmin, tdm.dmax, tdm.valid,
                              T(motion_ids, torch.int64), T(local_ids, torch.int64),
                              f.xy, f.desc, f.octave, f.mask, T(z), T(z), cfg)
    out_t = {k: v.numpy() for k, v in out_t.items()}
    assert out_j["stats"][0] >= 20  # the motion-model path, not a fallback
    np.testing.assert_array_equal(out_t["stats"], out_j["stats"])
    np.testing.assert_array_equal(out_t["obs1"], out_j["obs1"])
    np.testing.assert_array_equal(out_t["obs"], out_j["obs"])
    np.testing.assert_array_equal(out_t["vis_local"], out_j["vis_local"])
    np.testing.assert_allclose(out_t["R"], out_j["R"], atol=1e-4)
    np.testing.assert_allclose(out_t["t"], out_j["t"], atol=1e-4)

    # the same frame through the port's Tracker, from the carried state
    from hfnet_slam_torch.slam.tracking import OK
    from _torch_parity import build as build_port

    port, _ = build_port("torch", device="cpu")
    port.load_map(carried[3])
    convert.tracker_state_from_reference(
        port.tracker, port.store, last_R=tr.last_frame.R, last_t=tr.last_frame.t,
        last_obs=tr.last_frame.obs, last_feats=_port_feats(tr.last_frame.feats),
        last_timestamp=tr.last_frame.timestamp, velocity=tr.velocity, ref_kf=tr.ref_kf,
        local_ids=tr._local_ids)
    port.tracker.frames_since_kf = tr.frames_since_kf
    port.tracker.n_inliers = tr.n_inliers
    st, Rp, tp = port.track_features(f, 0.05 * N_WARM)
    st_j, Rj, tj = ref.track_features(feats, 0.05 * N_WARM)
    assert st == st_j == OK
    np.testing.assert_allclose(Rp, np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(tp, np.asarray(tj), atol=1e-4)
    np.testing.assert_array_equal(port.tracker.last_frame.obs, ref.tracker.last_frame.obs)


def _fresh_reference_store(carried):
    """Both packages' stores freshly loaded from the snapshot (the reference
    system itself moves on in the tracker test)."""
    from hfnet_slam_tpu.slam.map import MapStore as JMapStore

    ref, _, _, path = carried
    return JMapStore.load(path), convert.store_from_reference(path), ref.tracker.cam


def _neighbors(store, k):
    nb = [int(j) for j in store.covisible_kfs(k, n=5, min_weight=15)]
    assert nb, "the carried map has no covisible neighbors"
    return nb


def test_triangulate_banked_from_carried_state(carried):
    from hfnet_slam_tpu.slam import fused as Jfused

    s, port_store, cam = _fresh_reference_store(carried)
    k = int(np.nonzero(s.kf_valid)[0].max())
    # detach 150 of k's points from every keyframe in both stores, so the
    # epipolar search has free slot pairs to rediscover and triangulate
    obs_k = s.kf_obs[k]
    drop = obs_k[obs_k >= 0][:150]
    for st in (s, port_store):
        st.kf_obs[np.isin(st.kf_obs, drop)] = -1
    B = 8
    nbr = np.full(B, -1, np.int32)
    R21 = np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))
    t21 = np.zeros((B, 3), np.float32)
    for bi, j in enumerate(_neighbors(s, k)):
        nbr[bi] = j
        R21[bi] = s.kf_R[j] @ s.kf_R[k].T
        t21[bi] = s.kf_t[j] - R21[bi] @ s.kf_t[k]
    bank = Jfused.get_kf_bank(s, cam)
    bank.sync()
    _, b_desc, b_oct, b_mask, b_xn, b_obs = bank.snapshot()
    idx_j, good_j, p_j = (np.asarray(a) for a in Jfused.triangulate_banked(
        k, nbr, R21, t21, b_desc, b_oct, b_mask, b_xn, b_obs, 450.0))

    from hfnet_slam_torch.geometry import cameras as Tcam

    tb = Tfused.get_kf_bank(port_store, Tcam.pinhole(450.0, 450.0, 320.0, 240.0, 640, 480, device="cpu"),
                            "cpu")
    tb.sync()
    _, d, o, m, xn, ob = tb.snapshot()
    np.testing.assert_allclose(xn.numpy(), np.asarray(b_xn), atol=1e-6)
    idx_t, good_t, p_t = (a.numpy() for a in Tfused.triangulate_banked(
        k, T(nbr, torch.int64), T(R21), T(t21), d, o, m, xn, ob, 450.0))
    assert good_j.sum() > 50
    np.testing.assert_array_equal(idx_t, idx_j)
    np.testing.assert_array_equal(good_t, good_j)
    np.testing.assert_allclose(p_t[good_j], p_j[good_j], rtol=1e-3, atol=1e-4)


def test_fuse_neighbors_banked_from_carried_state(carried):
    from hfnet_slam_tpu.slam import fused as Jfused

    s, port_store, cam = _fresh_reference_store(carried)
    k = int(np.nonzero(s.kf_valid)[0].max())
    # free 150 of k's slots in both stores: fusing the neighbors' points into
    # k should claim them back
    slots = np.nonzero(s.kf_obs[k] >= 0)[0][:150]
    for st in (s, port_store):
        st.kf_obs[k, slots] = -1
    pairs = [(k, j) for j in _neighbors(s, k)] + [(j, k) for j in _neighbors(s, k)]
    P = 16
    tgt = np.full(P, -1, np.int32)
    src = np.full(P, -1, np.int32)
    R_t = np.tile(np.eye(3, dtype=np.float32), (P, 1, 1))
    t_t = np.zeros((P, 3), np.float32)
    for pi, (a, b) in enumerate(pairs):
        tgt[pi], src[pi] = a, b
        R_t[pi], t_t[pi] = s.kf_R[a], s.kf_t[a]
    dm = Jfused.get_device_map(s)
    dm.sync()
    bank = Jfused.get_kf_bank(s, cam)
    bank.sync()
    b_xy, b_desc, b_oct, b_mask, _, b_obs = bank.snapshot()
    # a looser radius than the mapper's 3 px so the pass has matches to compare
    idx_j = np.asarray(Jfused.fuse_neighbors_banked(
        cam.kind, cam.params, 640.0, 480.0, tgt, src, R_t, t_t, b_xy, b_desc, b_oct, b_mask,
        b_obs, dm.pos, dm.desc, dm.valid, radius=6.0, max_dist=0.75))

    from hfnet_slam_torch.geometry import cameras as Tcam

    ct = Tcam.pinhole(450.0, 450.0, 320.0, 240.0, 640, 480, device="cpu")
    tdm = Tfused.get_device_map(port_store, "cpu")
    tdm.sync()
    tb = Tfused.get_kf_bank(port_store, ct, "cpu")
    tb.sync()
    xy, d, o, m, _, ob = tb.snapshot()
    idx_t = Tfused.fuse_neighbors_banked(
        ct.kind, ct.params, 640.0, 480.0, T(tgt, torch.int64), T(src, torch.int64), T(R_t),
        T(t_t), xy, d, o, m, ob, tdm.pos, tdm.desc, tdm.valid, radius=6.0,
        max_dist=0.75).numpy()
    assert (idx_j >= 0).sum() > 50
    np.testing.assert_array_equal(idx_t, idx_j)


def test_device_map_incremental_sync():
    """Row-level sync equals a full re-upload (tests/test_fused.py:116-145)."""
    store = TMapStore(k_max=8, m_max=256, n_slots=64, desc_dim=16, gdesc_dim=16)
    rng = np.random.default_rng(0)
    ids = store.add_points(rng.normal(size=(40, 3)).astype(np.float32),
                           rng.normal(size=(40, 16)).astype(np.float32), first_kf=0)
    dm = Tfused.get_device_map(store, "cpu")
    dm.sync()
    np.testing.assert_allclose(dm.pos.numpy()[ids], store.mp_pos[ids])
    snap = dm.snapshot()
    sel = ids[::3]
    store.mp_pos[sel] += 1.5
    store.mark_points_dirty(sel)
    dm.sync()
    np.testing.assert_allclose(dm.pos.numpy(), store.mp_pos, rtol=1e-6)
    # functional update: the earlier snapshot still holds the old rows
    assert not np.allclose(snap[0].numpy()[sel], store.mp_pos[sel])
    store.mp_pos[:] *= 0.5
    store.bump_change()
    dm.sync()
    np.testing.assert_allclose(dm.pos.numpy(), store.mp_pos, rtol=1e-6)


def test_kf_bank_incremental_sync():
    from hfnet_slam_torch.geometry import cameras as Tcam

    cam = Tcam.pinhole(450.0, 450.0, 320.0, 240.0, 640, 480, device="cpu")
    store = TMapStore(k_max=8, m_max=256, n_slots=64, desc_dim=16, gdesc_dim=16)
    bank = Tfused.get_kf_bank(store, cam, "cpu")
    rng = np.random.default_rng(1)
    feats = TFeatures(xy=rng.uniform(0, 400, (64, 2)).astype(np.float32),
                      score=np.ones(64, np.float32), octave=np.zeros(64, np.int32),
                      desc=rng.normal(size=(64, 16)).astype(np.float32),
                      mask=np.ones(64, bool), global_desc=np.ones(16, np.float32))
    k = store.add_keyframe(np.eye(3), np.zeros(3), feats, 0.0)
    store.consume_dirty_kfs()  # the bank above already holds the empty tables
    store.mark_kf_feat_dirty(k)
    store.assign_observations(k, np.arange(5), np.arange(5, dtype=np.int32))
    bank.sync()
    np.testing.assert_array_equal(bank.desc.numpy(), store.kf_desc)
    np.testing.assert_array_equal(bank.obs.numpy(), store.kf_obs)
    np.testing.assert_allclose(bank.xn.numpy()[k], (store.kf_xy[k] - [320, 240]) / 450.0,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# host-packed batch wrappers and the map's one-shot helpers
# ---------------------------------------------------------------------------
def _host_bank(s, cam):
    """The reference bank's tables as numpy (both packages read them)."""
    from hfnet_slam_tpu.slam import fused as Jfused

    bank = Jfused.get_kf_bank(s, cam)
    bank.sync()
    xy, desc, oc, mask, xn, obs = (np.asarray(a) for a in bank.snapshot())
    return xy, desc, oc.astype(np.float32), mask, xn, obs


def test_triangulate_pairs_batch_matches_reference(carried):
    from hfnet_slam_tpu.slam import fused as Jfused

    s, _, cam = _fresh_reference_store(carried)
    k = int(np.nonzero(s.kf_valid)[0].max())
    obs_k = s.kf_obs[k]
    s.kf_obs[np.isin(s.kf_obs, obs_k[obs_k >= 0][:150])] = -1
    _, desc, oc, mask, xn, obs = _host_bank(s, cam)
    free = mask & (obs < 0)
    B = 8
    nbr = np.full(B, -1, np.int64)
    R21 = np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))
    t21 = np.zeros((B, 3), np.float32)
    for bi, j in enumerate(_neighbors(s, k)):
        nbr[bi] = j
        R21[bi] = s.kf_R[j] @ s.kf_R[k].T
        t21[bi] = s.kf_t[j] - R21[bi] @ s.kf_t[k]
    safe = np.clip(nbr, 0, len(desc) - 1)
    args = (xn[k], desc[k], 1.2 ** (2.0 * oc[k]), free[k], xn[safe], desc[safe],
            1.2 ** (2.0 * oc[safe]), free[safe] & (nbr >= 0)[:, None], R21, t21)
    idx_j, good_j, p_j = (np.asarray(a) for a in Jfused.triangulate_pairs_batch(*args, 450.0))
    idx_t, good_t, p_t = (a.numpy() for a in Tfused.triangulate_pairs_batch(
        *(T(a) for a in args), 450.0))
    assert good_j.sum() > 50
    np.testing.assert_array_equal(idx_t, idx_j)
    np.testing.assert_array_equal(good_t, good_j)
    np.testing.assert_allclose(p_t[good_j], p_j[good_j], rtol=1e-3, atol=1e-4)


def test_fuse_pairs_batch_matches_reference(carried):
    from hfnet_slam_tpu.slam import fused as Jfused

    s, _, cam = _fresh_reference_store(carried)
    k = int(np.nonzero(s.kf_valid)[0].max())
    s.kf_obs[k, np.nonzero(s.kf_obs[k] >= 0)[0][:150]] = -1
    xy, desc, oc, mask, _, obs = _host_bank(s, cam)
    pairs = [(k, j) for j in _neighbors(s, k)] + [(j, k) for j in _neighbors(s, k)]
    P = 16
    tgt = np.zeros(P, np.int64)
    cand = np.full((P, obs.shape[1]), -1, np.int64)
    R_t = np.tile(np.eye(3, dtype=np.float32), (P, 1, 1))
    t_t = np.zeros((P, 3), np.float32)
    free_t = np.zeros(mask.shape[1:], bool)[None].repeat(P, 0)
    for pi, (a, b) in enumerate(pairs):
        tgt[pi] = a
        cand[pi] = obs[b]
        free_t[pi] = mask[a] & (obs[a] < 0)
        R_t[pi], t_t[pi] = s.kf_R[a], s.kf_t[a]
    dm = Jfused.get_device_map(s)
    dm.sync()
    m_pos, m_desc, m_valid = (np.asarray(a) for a in (dm.pos, dm.desc, dm.valid))
    args = (R_t, t_t, xy[tgt], desc[tgt], oc[tgt].astype(np.int32), free_t, cand, m_pos,
            m_desc, m_valid)
    idx_j = np.asarray(Jfused.fuse_pairs_batch(cam.kind, cam.params, 640.0, 480.0, *args,
                                               radius=6.0, max_dist=0.75))
    from hfnet_slam_torch.geometry import cameras as Tcam

    ct = Tcam.pinhole(450.0, 450.0, 320.0, 240.0, 640, 480, device="cpu")
    idx_t = Tfused.fuse_pairs_batch(ct.kind, ct.params, 640.0, 480.0, *(T(a) for a in args),
                                    radius=6.0, max_dist=0.75).numpy()
    assert (idx_j >= 0).sum() > 50
    np.testing.assert_array_equal(idx_t, idx_j)


def test_set_observation_and_descriptor_refresh_match_reference(carried):
    """MapStore.set_observation and the one-shot refresh_point_descriptors
    on both packages' copies of the carried map: every array equal."""
    s, p, _ = _fresh_reference_store(carried)
    k = int(np.nonzero(s.kf_valid)[0].max())
    slots = np.nonzero(s.kf_obs[k] >= 0)[0]
    free = np.nonzero(s.kf_obs[k] < 0)[0]
    moves = [(k, int(slots[0]), -1), (k, int(free[0]), int(s.kf_obs[k, slots[1]])),
             (k, int(slots[2]), int(s.kf_obs[k, slots[3]]))]
    for st in (s, p):
        for kf, slot, mp in moves:
            st.set_observation(kf, slot, mp)
    np.testing.assert_array_equal(p.kf_obs, s.kf_obs)
    np.testing.assert_array_equal(p.mp_obs_count, s.mp_obs_count)
    ids = np.nonzero(s.mp_valid)[0]
    s.refresh_point_descriptors(ids)
    p.refresh_point_descriptors(ids, device="cpu")
    assert (s.mp_obs_count[ids] >= 2).sum() > 50
    np.testing.assert_array_equal(p.mp_desc, s.mp_desc)
    assert p.consume_dirty_points() is not None


@pytest.mark.parametrize("active", [0, 1, 2, 3])
def test_remove_bad_maps_matches_reference(active):
    """Atlas.remove_bad_maps keeps the same maps as the reference's and the
    map that was active stays active. The reference finds the active map
    again by dataclass equality, which compares only the capacities, so it
    points at the first kept map (ROADMAP Queue 3 (l)); the port keeps it
    by identity."""
    from hfnet_slam_tpu.slam.atlas import Atlas as JAtlas
    from hfnet_slam_torch.slam.atlas import Atlas as TAtlas

    out = []
    for cls in (JAtlas, TAtlas):
        a = cls(8, 16, 8, 8, 8)
        for _ in range(3):
            a.create_new_map()
        for m, n in zip(a.maps, (1, 4, 0, 3)):
            m.kf_valid[:n] = True
        a.active_idx = active
        keep = a.active
        a.remove_bad_maps()
        out.append(([int(m.kf_valid.sum()) for m in a.maps], a.active_idx,
                     next(i for i, m in enumerate(a.maps) if m is keep)))
    (kfs_j, idx_j, _), (kfs_t, idx_t, want) = out
    assert kfs_t == kfs_j
    assert idx_t == want
    assert idx_j == (want if active in (0, 1) else 0)
