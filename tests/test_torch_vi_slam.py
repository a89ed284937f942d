"""End-to-end mono-inertial SLAM of the port against the JAX reference on
tests/test_vi_slam.py's scene (scenes.VI_SMALL: 512 slots, 64-d, 1400
landmarks, 110 frames at 20 Hz with exact 200 Hz IMU), both driven frame by
frame from the same inputs. The reference runs in a process of its own
(tests/_vi_reference_run.py) while the port runs here.

Bounds: the reference's own acceptance (IMU initialized through VIBA1, more
than 95 of 110 frames tracked, one map, metric ATE after frame 60 under 5%
of the path); the port's metric ATE at most 1.5x the reference's plus 0.01 m
and its scale error at most the reference's plus 0.005 (bench.py's
_vi_metrics protocol). Then, on the port's IMU-initialized map: an atlas
round trip with every array equal, and an inertial loop correction (gravity
gate, 4-DoF essential graph, FullInertialBA), with the gravity gate held
against the reference's on the same map."""
import os
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from _torch_parity import VI_SMALL, build_vi, drive_vi, vi_metrics  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("vi_ref") / "ref.npz"
    proc = subprocess.Popen([sys.executable, os.path.join(HERE, "_vi_reference_run.py"),
                             str(out)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        sys_, ext = build_vi("torch", VI_SMALL, device="cpu")
        size = VI_SMALL
        port = drive_vi(sys_, ext, [(i, False) for i in range(size["frames"])],
                        size["frame_dt"], size["grav"], lockstep=True)
    finally:
        log, _ = proc.communicate(timeout=900)
    assert proc.returncode == 0, log[-4000:]
    ref = dict(np.load(out))
    return sys_, port, ref


def test_imu_initializes_through_viba1(runs):
    sys_, _, ref = runs
    assert bool(ref["imu_initialized"]) and int(ref["stage"]) >= 2
    assert sys_.store.imu_initialized and sys_.vi.stage >= 2
    speed = np.linalg.norm(sys_.store.kf_vel[sys_.store.valid_kf_ids()], axis=1)
    assert 2.0 < np.median(speed[-8:]) < 6.0  # ground truth ~4 m/s


def test_tracks_the_sequence_in_one_map(runs):
    sys_, (_, est, _, _), ref = runs
    assert len(ref["est"]) > 95 and int(ref["n_maps"]) == 1
    assert len(est) > 95
    assert sys_.atlas.n_maps() == 1


def test_metric_ate_against_the_reference(runs):
    _, (_, est, gt, when), ref = runs
    _, ate_t, path = vi_metrics(est, gt, when)
    _, ate_r, _ = vi_metrics(ref["est"], ref["gt"], ref["when"])
    assert ate_t < 0.05 * path, (ate_t, path)
    assert ate_t <= 1.5 * ate_r + 0.01, (ate_t, ate_r)


def test_scale_error_against_the_reference(runs):
    _, (_, est, gt, when), ref = runs
    s_t, _, _ = vi_metrics(est, gt, when)
    s_r, _, _ = vi_metrics(ref["est"], ref["gt"], ref["when"])
    assert s_t <= s_r + 0.005, (s_t, s_r)


def test_imu_initialized_atlas_round_trip(runs, tmp_path):
    from hfnet_slam_torch.slam.atlas import Atlas
    from hfnet_slam_torch.slam.map import _ARRAY_FIELDS

    sys_, _, _ = runs
    sys_.save_atlas(str(tmp_path / "atlas"))
    back = Atlas.load(str(tmp_path / "atlas"))
    a, b = sys_.store, back.active
    for name in _ARRAY_FIELDS:
        assert np.array_equal(getattr(a, name), getattr(b, name)), name
    for name in ("kf_vel", "kf_bg", "kf_ba", "kf_prev"):
        assert name in _ARRAY_FIELDS
    assert (b.imu_initialized, b.viba1, b.viba2) == (a.imu_initialized, a.viba1, a.viba2)
    assert b.imu_initialized and np.abs(b.kf_vel[b.valid_kf_ids()]).max() > 0


def _hit(store, k, cand, roll=0.0, yaw=0.02, shift=(0.05, 0.0, 0.0)):
    """A loop hit whose world-frame correction is Exp([roll, 0, yaw]) and a
    small shift: (R_cm, t_cm, s_cm, loop_mps)."""
    from hfnet_slam_torch import lie
    R_ww = lie.so3_exp(torch.tensor([roll, 0.0, yaw])).numpy()
    Rk, tk = store.kf_R[k], store.kf_t[k]
    Rc, tc = store.kf_R[cand], store.kf_t[cand]
    R_cw = Rk @ R_ww
    t_cw = Rk @ np.asarray(shift, np.float32) + tk
    R_cm = (R_cw @ Rc.T).astype(np.float32)
    t_cm = (t_cw - R_cm @ tc).astype(np.float32)
    mps = store.kf_obs[cand]
    return R_cm, t_cm, 1.0, np.unique(mps[mps >= 0])


@pytest.mark.parametrize("viba2", [False, True])
def test_gravity_gate_matches_the_reference(runs, tmp_path, viba2):
    from hfnet_slam_tpu.slam.loop_closing import LoopCloser as JLoop
    from hfnet_slam_tpu.slam.map import MapStore as JStore
    from hfnet_slam_torch.slam.loop_closing import LoopCloser as TLoop

    sys_, _, _ = runs
    store = sys_.store
    store.save(str(tmp_path / "m.npz"))
    jstore = JStore.load(str(tmp_path / "m.npz"))
    store_v, jstore.viba2 = store.viba2, viba2
    store.viba2 = viba2
    try:
        ids = store.valid_kf_ids()
        k, cand = int(ids[-1]), int(ids[0])
        for roll, yaw in ((0.0, 0.02), (0.01, -0.1), (0.03, 0.0), (0.0, 0.5)):
            hit = _hit(store, k, cand, roll=roll, yaw=yaw)
            out_t = TLoop._gravity_gate(types.SimpleNamespace(store=store), k, cand, *hit)
            out_j = JLoop._gravity_gate(types.SimpleNamespace(store=jstore), k, cand, *hit)
            assert (out_t is None) == (out_j is None), (roll, yaw)
            if out_t is not None:
                for a, b in zip(out_t[:3], out_j[:3]):
                    np.testing.assert_allclose(np.asarray(a, np.float64),
                                               np.asarray(b, np.float64), atol=1e-5)
    finally:
        store.viba2 = store_v


def test_inertial_loop_correction(runs):
    """On the IMU-initialized map: the gravity gate accepts a near-yaw hit
    and refuses a rolled one (BAD LOOP); the correction runs the 4-DoF
    essential graph and FullInertialBA after it. Runs last: it moves the
    fixture's map."""
    from hfnet_slam_torch.slam.loop_closing import LoopCloser, LoopCloserConfig

    sys_, _, _ = runs
    store = sys_.store
    lc = LoopCloser(sys_.cam, store, LoopCloserConfig(), mapper=sys_.mapper, device="cpu")
    ids = store.valid_kf_ids()
    k, cand = int(ids[-1]), int(ids[0])
    # the scene keeps the whole cloud in view, so the first keyframe may
    # share points with the last; a loop correction needs them apart
    store.covis[k, cand] = store.covis[cand, k] = 0
    assert lc._confirm_and_correct(k, cand, _hit(store, k, cand, roll=0.05)) is False
    assert lc.gravity_rejected == 1
    calls = []
    fiba = sys_.mapper.full_inertial_ba
    sys_.mapper.full_inertial_ba = lambda *a, **kw: calls.append(kw) or fiba(*a, **kw)
    try:
        big0 = store.big_change_idx
        act = lc._confirm_and_correct(k, cand, _hit(store, k, cand))
        assert isinstance(act, tuple)
        lc._correct_loop(k, *act)
    finally:
        sys_.mapper.full_inertial_ba = fiba
    assert lc.last_pg_mode == "4dof"
    assert lc.inertial_gba_requests == 1 and calls == [{"rounds": ((3, True), (4, False))}]
    assert store.big_change_idx > big0 and (int(cand), int(k)) in store.loop_edges
    ids = store.valid_kf_ids()
    assert np.isfinite(store.kf_R[ids]).all() and np.isfinite(store.kf_t[ids]).all()
    assert store.imu_initialized
