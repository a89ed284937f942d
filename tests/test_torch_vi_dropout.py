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
