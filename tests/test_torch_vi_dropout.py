"""The port's visual-inertial pipeline through a visual blackout and through
an IMU initialization without enough motion, on tests/test_vi_dropout.py's
runs at scenes.VI_SMALL's widths (512 slots, 64-d) and that test's clock
(10 Hz frames, 200 Hz exact IMU, gravity along -y), with that test's
assertions:
  * the async pipeline (mapping, loop and GBA workers) with frames 60-69
    featureless: never LOST, RECENTLY_LOST in the blackout, a pose emitted
    for every frame 61-69 by IMU dead reckoning that stays within 1.0 m of
    the ground truth, OK again afterwards, post-recovery metric ATE < 0.5 m;
  * a rig that stops moving at 2.5 s: the mapper's motion gate flags
    bad_imu and the tracker resets the active map (Tracking.cc:1108-1114).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from _torch_parity import VI_DROPOUT, VI_SMALL, build_vi, drive_vi, vi_blank_features  # noqa: E402
from hfnet_slam_torch.evaluation import ate  # noqa: E402
from hfnet_slam_torch.slam.tracking import LOST, NOT_INITIALIZED, OK, RECENTLY_LOST  # noqa: E402


def test_async_vi_rides_out_a_blackout_on_the_imu():
    sys_, ext = build_vi("torch", VI_SMALL, device="cpu", async_mapping=True)
    d = VI_DROPOUT
    plan = [(i, i in d["blackout"]) for i in range(d["frames"])]
    try:
        states, est, gtc, when = drive_vi(sys_, ext, plan, d["frame_dt"], d["grav"],
                                          blank=vi_blank_features(VI_SMALL))
        sys_.finish()
    finally:
        sys_.shutdown()
    assert sys_.store.imu_initialized, "the staged init never ran on the worker"
    assert LOST not in states
    assert RECENTLY_LOST in states[60:70]
    post = states[72:]
    assert np.mean([s == OK for s in post]) >= 0.8, post
    assert all(s == OK for s in states[-6:]), states[-6:]
    assert all(i in set(when.tolist()) for i in range(61, 70)), "a frame without a pose"
    pre_w = (when >= 30) & (when < 60)
    R_al, t_al, _ = ate.align_horn(est[pre_w], gtc[pre_w], with_scale=False)
    dr = np.isin(when, np.arange(60, 70))
    err_dr = np.linalg.norm((R_al @ est[dr].T).T + t_al - gtc[dr], axis=1)
    assert err_dr.max() < 1.0, f"dead reckoning drifted {err_dr.max():.2f} m"
    late = when >= 72
    err = ate.ate_rmse(est[late], gtc[late], with_scale=False)
    assert err < 0.5, f"post-recovery metric ATE {err:.3f}"


def test_not_enough_motion_resets_the_map(monkeypatch):
    """The rig stops at 2.5 s, after the first init (~1.7 s) and well inside
    the 10 moving seconds the post-init gate watches."""
    import hfnet_slam_torch.scenes as S

    sys_, ext = build_vi("torch", VI_SMALL, device="cpu")
    d = VI_DROPOUT
    t_stop = 2.5
    pose = S.vi_pose
    monkeypatch.setattr(S, "vi_pose", lambda t, **kw: pose(min(t, t_stop), **kw))
    tripped = False
    for i in range(80):
        t = i * d["frame_dt"]
        R, tt = S.vi_frame_pose(t)
        sys_.track_features(ext(R, tt), t,
                            imu=S.synth_imu(t - d["frame_dt"], t, d["grav"]) if i > 0 else None)
        tripped = tripped or sys_.vi.bad_imu or (
            sys_.tracker.state == NOT_INITIALIZED and i > 30)
        if tripped and not sys_.store.imu_initialized:
            break
    sys_.shutdown()
    assert tripped, "bad_imu never fired on a motion-starved rig"
    assert not sys_.store.imu_initialized
    assert sys_.vi.stage == 0


def test_imu_init_cannot_land_between_a_frame_and_its_keyframe():
    """The async run with the staged IMU init held back until a keyframe is
    being inserted, then attempted from another thread under the map lock
    while the tracker preintegrates the keyframe's chain link. The frame's
    pose is final there: a rescale landing before the insertion would leave
    the keyframe in the old gauge and lose tracking from the next frame on.
    The init has to wait for the lock and land where the tracker re-checks
    the map, and tracking stays OK through it."""
    import threading

    sys_, ext = build_vi("torch", VI_SMALL, device="cpu", async_mapping=True)
    d = VI_DROPOUT
    tr, vi, lock = sys_.tracker, sys_.vi, sys_.worker.map_lock
    init, integrate, create_kf = vi.maybe_initialize, vi.integrate, tr._create_keyframe
    ev = dict(fired=False, inserting=False, landed_inside=None)

    def held_back(now_ts):  # the worker's init waits for the attempt below
        return init(now_ts) if ev["fired"] else False

    def attempt_init():
        with lock:
            ev["landed_inside"] = ev["inserting"]
            init(float(sys_.store.kf_timestamp[tr._last_kf]))

    def integrate_in_insertion(*a):
        if ev["inserting"] and not ev["fired"] and tr.frame_id >= 20:
            ev["fired"] = True
            th = threading.Thread(target=attempt_init)
            th.start()
            th.join(timeout=2.0)
        return integrate(*a)

    def create_keyframe(frame):
        ev["inserting"] = True
        try:
            return create_kf(frame)
        finally:
            ev["inserting"] = False

    vi.maybe_initialize, vi.integrate, tr._create_keyframe = (
        held_back, integrate_in_insertion, create_keyframe)
    plan = [(i, False) for i in range(34)]
    try:
        states, _, _, when = drive_vi(sys_, ext, plan, d["frame_dt"], d["grav"])
        sys_.finish()
    finally:
        sys_.shutdown()
    assert ev["fired"], "no keyframe was inserted from frame 20 on"
    assert sys_.store.imu_initialized
    assert all(s == OK for s in states[2:]), states
    assert when.tolist() == list(range(2, 34))
    assert ev["landed_inside"] is False, "the init ran while a keyframe was being inserted"


def test_tracker_waits_for_the_mapper_until_the_imu_is_initialized():
    """The async run with the mapping worker slowed by 0.6 s a keyframe, so
    that the tracker would outrun it: until the IMU is initialized a frame
    starts only once the worker took the last keyframe. No keyframe waits
    behind another, each one gets its local BA, and the staged init runs
    with the tracker at most one keyframe ahead of it."""
    import time

    sys_, ext = build_vi("torch", VI_SMALL, device="cpu", async_mapping=True)
    d = VI_DROPOUT
    mapper, vi, store = sys_.mapper, sys_.vi, sys_.store
    process, init = mapper.process_keyframe, vi.maybe_initialize
    seen = dict(queue=[], do_ba=[], ahead=None)

    def slow_process(k, **kw):
        time.sleep(0.6)
        if not store.imu_initialized:
            seen["do_ba"].append(kw.get("do_ba", True))
        return process(k, **kw)

    def first_init(now_ts):
        ran = init(now_ts)
        if ran and seen["ahead"] is None:
            ids = store.valid_kf_ids()
            seen["ahead"] = int((store.kf_timestamp[ids] > now_ts).sum())
        return ran

    track = sys_.tracker.track

    def track_and_look(*a, **kw):
        out = track(*a, **kw)
        if not store.imu_initialized:
            seen["queue"].append(sys_.worker.queue_size())
        return out

    mapper.process_keyframe, vi.maybe_initialize = slow_process, first_init
    sys_.tracker.track = track_and_look
    try:
        states, _, _, _ = drive_vi(sys_, ext, [(i, False) for i in range(24)],
                                   d["frame_dt"], d["grav"])
        sys_.finish()
    finally:
        sys_.shutdown()
    assert store.imu_initialized
    assert all(s == OK for s in states[2:]), states
    assert max(seen["queue"]) <= 1, seen["queue"]
    assert seen["ahead"] <= 1, seen["ahead"]
    assert all(seen["do_ba"]) and len(seen["do_ba"]) >= 4, seen["do_ba"]
