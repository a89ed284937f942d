"""Parity of the port's stereo and RGB-D path with the JAX reference (port
on the CPU): the stereo association and depth lookup of ops/stereo.py on
tests/test_stereo.py's rigs, the RGB-D and rectified-stereo browse runs in
lockstep through track_rgbd / track_stereo, the TUM RGB-D and TUM-VI stereo
settings, VI-BA with depth rows, and a port-only stereo-inertial run.

Tolerances: matched indices and right columns exactly; depths and
triangulated points within 1e-5 relative; the whole runs' tracking states
and keyframe counts at every frame exactly, their camera centres within
1e-3 m; the VI-BA keyframe states within 1e-4 and landmarks within 1e-3
relative (tests/test_torch_vi_ba.py's); settings fields exactly."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from hfnet_slam_tpu.ops import stereo as JS  # noqa: E402
from hfnet_slam_torch.ops import stereo as TS  # noqa: E402
import test_stereo  # noqa: E402

SMALL_FRAMES, SMALL_JOLT = 60, 40


def T(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _rect_case(case):
    """tests/test_stereo.py's rectified rig, as that file's tests vary it,
    plus random octaves 0-3 (the row band widens as 1.2^octave)."""
    cam, b, xyL, xyR, d, octv, mask, z = test_stereo.TestMatchStereo()._rig()
    octL = octR = octv
    if case == "row_gate":
        xyR = xyR.copy()
        xyR[:, 1] += 30.0
    elif case == "negative_disparity":
        xyR = xyL.copy()
        xyR[:, 0] += 5.0
    elif case == "octaves":
        rng = np.random.default_rng(4)
        octL = rng.integers(0, 4, len(xyL)).astype(np.int32)
        octR = np.clip(octL + rng.integers(-2, 3, len(xyL)), 0, 3).astype(np.int32)
        xyR = xyR.copy()
        xyR[:, 1] += rng.uniform(-4, 4, len(xyR)).astype(np.float32)
        mask = mask.copy()
        mask[::9] = False
    return float(cam.fx), b, xyL, d, octL, mask, xyR.astype(np.float32), d, octR, mask


@pytest.mark.parametrize("case", ["recovered", "row_gate", "negative_disparity", "octaves"])
def test_match_stereo_matches_reference(case):
    fx, b, xyL, dL, oL, mL, xyR, dR, oR, mR = _rect_case(case)
    dj, uj = JS.match_stereo(*(jnp.asarray(x) for x in (xyL, dL, oL, mL, xyR, dR, oR, mR)),
                             fx=fx, baseline=b)
    dt, ut = TS.match_stereo(*(T(x) for x in (xyL, dL, oL, mL, xyR, dR, oR, mR)),
                             fx=fx, baseline=b)
    np.testing.assert_array_equal(ut.numpy(), np.asarray(uj))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5, atol=0)
    n = int((dt > 0).sum())
    assert (n > 0.9 * len(xyL)) if case == "recovered" else \
        (n == 0 if case in ("row_gate", "negative_disparity") else 0 < n < len(xyL))


@pytest.mark.parametrize("shuffled", [False, True])
def test_match_stereo_fisheye_matches_reference(shuffled):
    from hfnet_slam_torch.geometry import cameras as Tcam

    (cam_l, cam_r, R_lr, t_lr, pts, uv_l, uv_r, d, mask,
     oct_) = test_stereo.TestFisheyeStereo()._kb8_rig()
    if shuffled:  # tests/test_stereo.py's wrong-match case
        uv_r = uv_r[np.random.default_rng(1).permutation(len(d))]
    args = (uv_l, d, oct_, mask, uv_r, d, oct_, mask)
    dj, ij, pj = JS.match_stereo_fisheye(cam_l.kind, cam_l.params, cam_r.kind, cam_r.params,
                                         *(jnp.asarray(x) for x in args),
                                         jnp.asarray(R_lr), jnp.asarray(t_lr))
    tl = Tcam.Camera(cam_l.kind, T(cam_l.params), 512, 512)
    tr = Tcam.Camera(cam_r.kind, T(cam_r.params), 512, 512)
    dt, it, pt = TS.match_stereo_fisheye(tl.kind, tl.params, tr.kind, tr.params,
                                         *(T(x) for x in args), T(R_lr), T(t_lr))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5, atol=0)
    ok = np.asarray(ij) >= 0
    np.testing.assert_allclose(pt.numpy()[ok], np.asarray(pj)[ok], rtol=1e-5, atol=1e-6)
    assert ok.sum() < 0.1 * len(d) if shuffled else ok.sum() > 0.8 * len(d)


def test_depth_at_keypoints_matches_reference():
    """Nearest pixel with rounding half to even (x.5 keypoints), clipping to
    the image, a depth factor, and NaN / inf / <= 0 values giving 0."""
    rng = np.random.default_rng(2)
    img = rng.uniform(500.0, 20000.0, (48, 64)).astype(np.float32)
    img[3, 4], img[5, 6], img[7, 8], img[9, 10] = np.nan, np.inf, -3.0, 0.0
    xy = np.concatenate([
        rng.uniform(-5, 70, (200, 2)),
        [[4.0, 3.0], [6.0, 5.0], [8.0, 7.0], [10.0, 9.0]],      # the bad values
        [[2.5, 3.5], [3.5, 4.5], [-0.5, 0.5], [63.5, 47.5]],    # half pixels
        [[100.0, -20.0], [-7.2, 60.0]]]).astype(np.float32)     # outside: clipped
    dj = JS.depth_at_keypoints(jnp.asarray(img), jnp.asarray(xy), 1.0 / 5000.0)
    dt = TS.depth_at_keypoints(T(img), T(xy), 1.0 / 5000.0)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    assert (dt.numpy()[200:204] == 0).all()
    assert dt[204] == img[4, 2] / 5000 and dt[205] == img[4, 4] / 5000  # half to even


# ---------------------------------------------------------------------------
# whole runs in lockstep
# ---------------------------------------------------------------------------
def _jax_stereo_system(sp, rig=False):
    """The reference system of a port scene spec, with its extractor behind
    the port's PoseRig adapter (plain Python, no torch)."""
    from hfnet_slam_tpu.geometry import cameras
    from hfnet_slam_tpu.models.fake import FakeExtractor, SyntheticWorld
    from hfnet_slam_tpu.slam.local_mapping import MapperConfig
    from hfnet_slam_tpu.slam.system import SLAMSystem, SystemConfig
    from hfnet_slam_tpu.slam.tracking import TrackerConfig
    from hfnet_slam_torch.scenes import PoseRig

    cam = cameras.pinhole(**sp["cam"])
    world = SyntheticWorld.cloud(**sp["world"])
    ext_l = FakeExtractor(world, cam, **sp["ext"])
    ext_r = FakeExtractor(world, cam, **dict(sp["ext"], seed=sp["ext"]["seed"] + 1))
    cfg = SystemConfig(**sp["system"], tracker=TrackerConfig(**sp["tracker"]),
                       mapper=MapperConfig(**sp["mapper"]))
    return SLAMSystem(cam, PoseRig(ext_l, ext_r) if rig else ext_l, cfg), ext_l


def _drive(sys_, ext, mode, n=SMALL_FRAMES, jolt=SMALL_JOLT):
    """Track n browse frames through track_rgbd or track_stereo: (states,
    keyframe counts, camera centres or None per frame)."""
    from hfnet_slam_torch.scenes import STEREO_BASELINE, browse_pose, depth_image, stereo_images

    states, kfs, centres = [], [], []
    for i in range(n):
        R, t = browse_pose(i, jolt)
        if mode == "rgbd":
            out = sys_.track_rgbd((R, t), depth_image(ext.world, ext.cam, R, t, i), 0.05 * i)
        else:
            out = sys_.track_stereo(*stereo_images(R, t, np.eye(3), (-STEREO_BASELINE, 0, 0)),
                                    0.05 * i)
        st, Re, te = out
        states.append(int(st))
        kfs.append(int(sys_.store.kf_valid.sum()))
        centres.append(None if Re is None else -np.asarray(Re).T @ np.asarray(te))
    return states, kfs, centres


@pytest.mark.parametrize("mode", ["rgbd", "stereo"])
def test_depth_browse_matches_reference_in_lockstep(mode, monkeypatch):
    from hfnet_slam_torch.evaluation import ate
    from hfnet_slam_torch.scenes import SMALL, browse_pose, rgbd_spec, rgbd_system, stereo_spec
    from hfnet_slam_torch.scenes import stereo_system
    from hfnet_slam_torch.slam import search

    spec = rgbd_spec if mode == "rgbd" else stereo_spec
    sys_j, ext_j = _jax_stereo_system(spec(SMALL), rig=mode == "stereo")
    calls = []
    real = search.search_brute_force
    monkeypatch.setattr(search, "search_brute_force",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    sys_t, ext_t = (rgbd_system if mode == "rgbd" else stereo_system)(SMALL, "cpu")
    out_t = _drive(sys_t, ext_t, mode)
    out_j = _drive(sys_j, ext_j, mode)
    assert out_t[0] == out_j[0] and out_t[1] == out_j[1]
    assert out_t[0][0] == 1  # depth initializes the map at frame 0
    assert calls, "the jolt never sent tracking to the reference keyframe"
    gt = [-browse_pose(i, SMALL_JOLT)[0].T @ browse_pose(i, SMALL_JOLT)[1]
          for i in range(SMALL_FRAMES)]
    ct, cj = out_t[2], out_j[2]
    assert all((a is None) == (b is None) for a, b in zip(ct, cj))
    tracked = [i for i, c in enumerate(ct) if c is not None]
    assert len(tracked) >= SMALL_FRAMES - 2
    et, ej = np.array([ct[i] for i in tracked]), np.array([cj[i] for i in tracked])
    np.testing.assert_allclose(et, ej, atol=1e-3)
    g = np.array([gt[i] for i in tracked])
    m_t, m_j = ate.ate_rmse(et, g, with_scale=False), ate.ate_rmse(ej, g, with_scale=False)
    print(f"{mode}: metric ATE port {m_t:.5f} m, reference {m_j:.5f} m, "
          f"keyframes {out_t[1][-1]}")
    # tests/test_stereo.py:135-138's bounds: metric, and scale barely helps
    assert m_t < 0.25 and m_t < ate.ate_rmse(et, g, with_scale=True) * 1.5 + 0.05
    s = sys_t.store
    k0 = int(s.valid_kf_ids()[0])
    np.testing.assert_array_equal(s.kf_depth[k0], sys_j.store.kf_depth[k0])


# ---------------------------------------------------------------------------
# settings
# ---------------------------------------------------------------------------
TUM_VI_STEREO_YAML = """%YAML:1.0
File.version: "1.0"
Camera.type: "KannalaBrandt8"
Camera1.fx: 190.978477
Camera1.fy: 190.973307
Camera1.cx: 254.931706
Camera1.cy: 256.897442
Camera1.k1: 0.003482389402
Camera1.k2: 0.000715034845
Camera1.k3: -0.002053236141
Camera1.k4: 0.000202936736
Camera2.fx: 190.442369
Camera2.fy: 190.4344
Camera2.cx: 252.597253
Camera2.cy: 254.91772
Camera2.k1: 0.0034003170790442797
Camera2.k2: 0.001766278153372525
Camera2.k3: -0.00266312569781606
Camera2.k4: 0.0003299517423931039
Camera.width: 512
Camera.height: 512
Camera.fps: 20
Camera.RGB: 1
Stereo.ThDepth: 40.0
Stereo.T_c1_c2: !!opencv-matrix
   rows: 4
   cols: 4
   dt: f
   data: [0.999994, 0.001166, -0.003200, 0.101065,
          -0.001189, 0.999964, -0.008446, 0.001995,
          0.003190, 0.008450, 0.999959, 0.001405,
          0.0, 0.0, 0.0, 1.0]
Extractor.nFeatures: 1000
loopClosing: 1
"""


@pytest.mark.parametrize("kind", ["tum_rgbd", "tum_vi_stereo"])
def test_stereo_and_rgbd_settings_match_reference(kind, tmp_path):
    from hfnet_slam_tpu.utils.settings import Settings as JS_
    from hfnet_slam_torch.scenes import TUM1_CAM, TUM_RGBD_SETTINGS, EUROC_HFNET
    from hfnet_slam_torch.utils.settings import Settings as TS_

    text = TUM_RGBD_SETTINGS.format(**TUM1_CAM, **EUROC_HFNET) if kind == "tum_rgbd" \
        else TUM_VI_STEREO_YAML
    path = tmp_path / "s.yaml"
    path.write_text(text)
    sensor = "rgbd" if kind == "tum_rgbd" else "stereo"
    j, t = JS_.from_yaml(str(path), sensor=sensor), TS_.from_yaml(str(path), sensor=sensor)
    gj, gt = j.make_system_config(), t.make_system_config("cpu")
    for f in ("loop_closing", "baseline", "depth_factor", "virtual_baseline"):
        assert getattr(gt, f) == getattr(gj, f), f
    for f in ("th_depth", "th_far", "max_frames_between_kf"):
        assert getattr(gt.tracker, f) == getattr(gj.tracker, f), f
    if kind == "tum_rgbd":
        assert gt.depth_factor == 1.0 / 5000.0 and gt.baseline == 0.07732
        assert gt.cam_right is None and t.make_camera_right() is None
        assert gj.cam_right is None
        return
    cj, ct = j.make_camera_right(), t.make_camera_right("cpu")
    assert (ct.kind, ct.width, ct.height) == (cj.kind, cj.width, cj.height)
    np.testing.assert_array_equal(ct.params.numpy(), np.asarray(cj.params))
    np.testing.assert_array_equal(gt.cam_right.params.numpy(), np.asarray(gj.cam_right.params))
    for a, b in zip(gt.T_lr, gj.T_lr):
        np.testing.assert_array_equal(a, b)
    assert gt.baseline == gj.baseline == float(np.linalg.norm(t.T_c1_c2[:3, 3]))


# ---------------------------------------------------------------------------
# stereo-inertial
# ---------------------------------------------------------------------------
def test_vi_ba_with_depth_rows_matches_reference():
    import jax

    from hfnet_slam_tpu.optim import vi_ba as Jvb
    from hfnet_slam_torch.geometry import cameras as Tcam
    from hfnet_slam_torch.optim import vi_ba as Tvb
    from test_torch_vi_ba import assert_same, to_port
    from test_vi_ba import CAM, body_to_cam, make_problem

    prob, kf_R, kf_p, _, pts_gt = make_problem(jax.random.PRNGKey(1), noise_px=0.5,
                                               perturb=0.02)
    kf, pt = np.asarray(prob.kf_idx), np.asarray(prob.pt_idx)
    z = np.zeros(len(kf), np.float32)
    for k in range(len(kf_R)):
        R_cw, t_cw = body_to_cam(kf_R[k], kf_p[k])
        z[kf == k] = (pts_gt[pt[kf == k]] @ np.asarray(R_cw).T + np.asarray(t_cw))[:, 2]
    z *= 1 + np.random.default_rng(0).normal(0, 0.005, len(z)).astype(np.float32)
    bf = 458.0 * 0.11
    wz = np.where(np.arange(len(z)) % 3 == 0, 0.0, bf / z ** 2).astype(np.float32)
    prob = prob._replace(z_meas=jnp.asarray(z), wz=jnp.asarray(wz))
    rounds = ((8, True), (20, False))
    out_j = Jvb.vi_bundle_adjust(CAM.kind, CAM.params, prob, rounds=rounds)
    cam_t = Tcam.pinhole(458.0, 457.0, 367.0, 248.0, 752, 480, device="cpu")
    out_t = Tvb.vi_bundle_adjust(cam_t.kind, cam_t.params, to_port(prob), rounds=rounds)
    assert_same(out_t, out_j)


def test_stereo_inertial_small_run():
    """Port only (a reference VI run costs minutes): tests/test_vi_slam.py's
    scene with a rectified right camera 0.11 m along x, through
    track_stereo_inertial at 20 Hz. Depth seeds a metric map at frame 0, the
    IMU initializes (stage >= 1), and the metric ATE of the saved trajectory
    (rebuilt through the final map's keyframes, as chip_smoke.py phase 15
    reads it) stays within phase 10's bounds: <= 0.2 m and <= 5% of the
    path."""
    from hfnet_slam_torch.evaluation import ate
    from hfnet_slam_torch.scenes import (VI_BASELINE, VI_SMALL, stereo_images,
                                         stereo_vi_system, synth_imu, vi_frame_pose, vi_pose)

    size, n = VI_SMALL, 60
    sys_, _ = stereo_vi_system(size, "cpu")
    est, gt, states = [], [], []
    for i in range(n):
        t = i * size["frame_dt"]
        rows = synth_imu(t - size["frame_dt"], t, size["grav"]) if i > 0 else None
        st, Re, te = sys_.track_stereo_inertial(
            *stereo_images(*vi_frame_pose(t), np.eye(3), (-VI_BASELINE, 0, 0)), t, rows)
        states.append(int(st))
        if Re is not None:
            est.append(-Re.T @ te)
            gt.append(vi_pose(t)[1])
    from hfnet_slam_torch.utils import trajectory as TJ

    gt = np.asarray(gt)
    path = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
    rec = TJ.recovered(sys_.trajectory)
    est = np.asarray([-np.asarray(R).T @ np.asarray(t_) for _, R, t_ in rec])
    gt = np.asarray([vi_pose(ts)[1] for ts, _, _ in rec])
    err = float(ate.ate_rmse(est, gt, with_scale=False))
    print(f"stereo-inertial SMALL: stage {sys_.vi.stage}, metric ATE {err:.4f} m over {path:.2f} m")
    assert states[0] == 1 and len(est) >= n - 2
    assert sys_.store.imu_initialized and sys_.vi.stage >= 1
    assert err <= 0.2 and err <= 0.05 * path
