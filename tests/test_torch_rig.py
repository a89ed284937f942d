"""Parity of the port's stereo-rig pieces with the JAX reference, on the
problems of tests/test_rig.py: the rig residual (the reference's ToBody
edges), the rig-aware Schur BA, the map's right-camera bank, and
tests/test_rig.py's fisheye-rig system run in lockstep through
track_stereo.

Tolerances: the rig factor's r, J_pose and J_point within 1e-5 of each
array's largest magnitude (float32; the KB8 pose Jacobian's rotation block
cancels terms near 190 to leave entries near 0.5, whose last bits differ);
BA poses 1e-4 and points 1e-3 relative (segment sums land in another order);
edge validity and every right-bank array exactly, the rig run's right
keypoints within 1e-4 px (the fake extractors' KB8 projections differ in the
last bit); the rig run's tracking states and keyframe counts exactly, its
camera centres within 1e-3 m."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from hfnet_slam_tpu import lie as Jlie  # noqa: E402
from hfnet_slam_tpu.geometry import cameras as Jcam  # noqa: E402
from hfnet_slam_tpu.optim import ba as Jba  # noqa: E402
from hfnet_slam_tpu.optim import factors as Jf  # noqa: E402
from hfnet_slam_torch.geometry import cameras as Tcam  # noqa: E402
from hfnet_slam_torch.optim import ba as Tba  # noqa: E402
from hfnet_slam_torch.optim import factors as Tf  # noqa: E402

CAM_L = Jcam.pinhole(450.0, 450.0, 320.0, 240.0, 640, 480)
CAM_R = Jcam.pinhole(455.0, 452.0, 318.0, 242.0, 640, 480)
TCAM_L = Tcam.pinhole(450.0, 450.0, 320.0, 240.0, 640, 480, device="cpu")
TCAM_R = Tcam.pinhole(455.0, 452.0, 318.0, 242.0, 640, 480, device="cpu")
R_RL = np.asarray(Jlie.so3_exp(jnp.asarray([0.0, -0.03, 0.005])), np.float32)
T_RL = np.array([-0.11, 0.002, 0.001], np.float32)


def T(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


@pytest.mark.parametrize("sel", [0.0, 1.0])
@pytest.mark.parametrize("kind", ["pinhole", "kb8"])
def test_rig_factor_matches_reference(sel, kind):
    if kind == "kb8":
        cl = Jcam.kb8(190.0, 190.0, 256.0, 256.0, 0.0035, 0.0007, -0.0037, 0.0007, 512, 512)
        cr = Jcam.kb8(190.5, 190.2, 255.0, 257.0, 0.0034, 0.0008, -0.0038, 0.0006, 512, 512)
    else:
        cl, cr = CAM_L, CAM_R
    rng = np.random.default_rng(1)
    R = np.asarray(Jlie.so3_exp(jnp.asarray([0.05, 0.1, -0.02])), np.float32)
    t = np.array([0.1, 0.05, -0.1], np.float32)
    for _ in range(4):
        p_w = (rng.uniform(-1, 1, 3) + [0, 0, 5.0]).astype(np.float32)
        uv = rng.uniform(150, 350, 2).astype(np.float32)
        z, wz = np.float32(4.8), np.float32(0.7 * sel)
        oj = Jf.reproj_depth_residual_rig(
            cl.kind, cl.params, cr.params, jnp.asarray(R_RL), jnp.asarray(T_RL),
            jnp.asarray(sel), jnp.asarray(R), jnp.asarray(t), jnp.asarray(p_w),
            jnp.asarray(uv), jnp.asarray(z), jnp.asarray(wz))
        ot = Tf.reproj_depth_residual_rig(
            cl.kind, T(cl.params), T(cr.params), T(R_RL), T(T_RL), torch.tensor(sel), T(R),
            T(t), T(p_w), T(uv), torch.tensor(z), torch.tensor(wz))
        for a, b, name in zip(ot, oj, ("r", "J_pose", "J_point", "depth")):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                       atol=1e-5 * max(1.0, float(np.abs(b).max())),
                                       err_msg=name)


def _ba_problem():
    """tests/test_rig.py:95's problem: two keyframes, 30% of the points seen
    only by the right cameras."""
    import sys
    import os
    sys.path.insert(0, os.path.dirname(__file__))
    from test_rig import TestRigBA

    prob, R_gt, t_gt, pts, right_only = TestRigBA()._problem()
    return prob, pts, right_only


def _port_problem(prob):
    d = {k: (None if v is None else T(v)) for k, v in prob._asdict().items()}
    for k in ("kf_idx", "pt_idx"):
        d[k] = d[k].long()
    return Tba.BAProblem(**d)


@pytest.mark.parametrize("right_edges", [True, False])
def test_rig_bundle_adjust_matches_reference(right_edges):
    prob, pts, right_only = _ba_problem()
    if not right_edges:  # tests/test_rig.py's control: the right edges invalid
        valid = np.asarray(prob.valid).copy()
        valid[np.asarray(prob.cam_sel) > 0.5] = False
        prob = prob._replace(valid=jnp.asarray(valid))
    rounds = ((5, True), (15, False))
    oj = Jba.bundle_adjust(CAM_L.kind, CAM_L.params, prob, rounds=rounds)
    ot = Tba.bundle_adjust(TCAM_L.kind, TCAM_L.params, _port_problem(prob), rounds=rounds)
    np.testing.assert_allclose(ot.poses_R.numpy(), np.asarray(oj.poses_R), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ot.poses_t.numpy(), np.asarray(oj.poses_t), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ot.points.numpy(), np.asarray(oj.points), rtol=1e-3, atol=1e-4)
    np.testing.assert_array_equal(ot.valid.numpy(), np.asarray(oj.valid))
    err = np.linalg.norm(ot.points.numpy() - pts, axis=1)[right_only]
    if right_edges:
        assert err.max() < 2e-2, err.max()   # right-only points converge
    else:
        assert err.max() > 2e-2, err.max()   # blind without their edges


def _right_bank_ops(MapStore):
    """Set, query, grow, remove_keyframe and remove_points on a right bank."""
    rng = np.random.default_rng(3)
    s = MapStore(4, 64, 16, 8, 8)
    s.enable_right_bank()
    out = {}
    for k in range(3):
        s.kf_valid[k] = True
        s.n_kf += 1
        slots = rng.choice(16, 6, replace=False)
        s.set_right_observations(k, slots, rng.integers(0, 40, 6),
                                 rng.uniform(0, 600, (6, 2)), rng.integers(0, 3, 6))
    out["query"] = s.right_observing_slots(np.arange(0, 40, 2))
    s.grow_keyframes()
    s.set_right_observations(5, [1, 2], [7, 9], [[1.0, 2.0], [3.0, 4.0]], [1, 2])
    s.kf_valid[5] = True
    s.remove_keyframe(1)
    s.remove_points(np.array([7, 11, 20]))
    out["query_after"] = s.right_observing_slots(np.arange(40))
    out["obs_count"] = s.mp_obs_count.copy()
    for f in ("kf_xy_r", "kf_oct_r", "kf_obs_r"):
        out[f] = getattr(s, f).copy()
    return out


def test_right_bank_matches_reference():
    from hfnet_slam_tpu.slam.map import MapStore as JMapStore
    from hfnet_slam_torch.slam.map import MapStore as TMapStore

    oj, ot = _right_bank_ops(JMapStore), _right_bank_ops(TMapStore)
    assert ot.keys() == oj.keys()
    for k in oj:
        for a, b in zip(np.atleast_1d(ot[k]) if k.startswith("query") else [ot[k]],
                        np.atleast_1d(oj[k]) if k.startswith("query") else [oj[k]]):
            np.testing.assert_array_equal(a, b, err_msg=k)
            assert np.asarray(a).dtype == np.asarray(b).dtype, k
    assert ot["kf_obs_r"].shape[0] == 8 and (ot["obs_count"] == 0).all()


def _jax_rig_system(R_lr, t_lr):
    """tests/test_rig.py:182's reference system, from the port's scene spec
    and with the port's extrinsic (the same float32 bits in both)."""
    from hfnet_slam_tpu.models.fake import FakeExtractor, SyntheticWorld
    from hfnet_slam_tpu.slam.local_mapping import MapperConfig
    from hfnet_slam_tpu.slam.system import SLAMSystem, SystemConfig
    from hfnet_slam_tpu.slam.tracking import TrackerConfig
    from hfnet_slam_torch.scenes import RIG_SMALL, PoseRig, rig_spec

    sp = rig_spec(RIG_SMALL)
    cam_l, cam_r = Jcam.kb8(*sp["cam_l"]), Jcam.kb8(*sp["cam_r"])
    world = SyntheticWorld.cloud(**sp["world"])
    ext_l = FakeExtractor(world, cam_l, **sp["ext"])
    ext_r = FakeExtractor(world, cam_r, **dict(sp["ext"], seed=8))
    cfg = SystemConfig(**sp["system"], baseline=float(np.linalg.norm(t_lr)), cam_right=cam_r,
                       T_lr=(R_lr, t_lr), tracker=TrackerConfig(**sp["tracker"]),
                       mapper=MapperConfig(**sp["mapper"]))
    return SLAMSystem(cam_l, PoseRig(ext_l, ext_r), cfg)


def _drive_rig(sys_, R_rl, t_rl, size):
    """Track the rig's frames through track_stereo: per frame (state,
    keyframe count, camera centre or None), and per keyframe its right-bank
    observation count."""
    from hfnet_slam_torch.scenes import rig_pose, stereo_images

    rows, right = [], {}
    for i in range(size["frames"]):
        R, t = rig_pose(i, size["step"])
        st, Re, te = sys_.track_stereo(*stereo_images(R, t, R_rl, t_rl), 0.1 * i)
        s = sys_.store
        rows.append((int(st), int(s.kf_valid.sum()),
                     None if Re is None else -np.asarray(Re).T @ np.asarray(te)))
        for k in s.valid_kf_ids():
            right[int(s.kf_uid[k])] = int((s.kf_obs_r[k] >= 0).sum())
    return rows, right


def test_rig_run_matches_reference_in_lockstep(tmp_path):
    """tests/test_rig.py:182's fisheye-rig run (14 frames) through
    track_stereo in both packages: right keypoints become right-bank
    observations and ride local BA as ToBody edges."""
    from hfnet_slam_torch.evaluation import ate
    from hfnet_slam_torch.scenes import RIG_SMALL, rig_pose, rig_system

    sys_t, _, (R_rl, t_rl) = rig_system(RIG_SMALL, "cpu")
    R_lr, t_lr = sys_t.cfg.T_lr
    sys_j = _jax_rig_system(R_lr, t_lr)
    assert sys_t.store.has_right and sys_j.store.has_right
    np.testing.assert_array_equal(sys_t.cfg.mapper.rig[0], sys_j.cfg.mapper.rig[0])
    rows_t, right_t = _drive_rig(sys_t, R_rl, t_rl, RIG_SMALL)
    rows_j, right_j = _drive_rig(sys_j, R_rl, t_rl, RIG_SMALL)
    assert [r[:2] for r in rows_t] == [r[:2] for r in rows_j]
    assert right_t == right_j
    et = np.array([r[2] for r in rows_t if r[2] is not None])
    ej = np.array([r[2] for r in rows_j if r[2] is not None])
    np.testing.assert_allclose(et, ej, atol=1e-3)
    gt = np.array([-rig_pose(i, RIG_SMALL["step"])[0].T @ rig_pose(i, RIG_SMALL["step"])[1]
                   for i, r in enumerate(rows_t) if r[2] is not None])
    m_t, m_j = ate.ate_rmse(et, gt, with_scale=False), ate.ate_rmse(ej, gt, with_scale=False)
    print(f"rig: metric ATE port {m_t:.5f} m, reference {m_j:.5f} m, keyframes "
          f"{rows_t[-1][1]}, right-bank observations {right_t}")
    # tests/test_rig.py's bounds
    assert rows_t[-1][0] == 1 and rows_t[-1][1] >= 2
    assert sum(right_t.values()) > 50
    assert np.linalg.norm(et - gt, axis=1).max() < 0.05
    assert sys_t.mapper.stats.get("right_edges", 0) > 0
    # the reference's map, with the right bank its snapshot does not hold,
    # converts into the port's run's map
    from hfnet_slam_torch.convert import store_from_reference

    path = str(tmp_path / "map.npz")
    sj = sys_j.store
    sj.save(path)
    conv = store_from_reference(path, right_bank=(sj.kf_xy_r, sj.kf_oct_r, sj.kf_obs_r))
    for f in ("kf_obs", "kf_oct_r", "kf_obs_r"):
        np.testing.assert_array_equal(getattr(conv, f), getattr(sys_t.store, f), err_msg=f)
    # the fake extractors' KB8 projections agree to the last bit or two
    np.testing.assert_allclose(conv.kf_xy_r, sys_t.store.kf_xy_r, rtol=0, atol=1e-4)
