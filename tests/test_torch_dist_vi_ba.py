"""The port's distributed joint visual-inertial BA
(hfnet_slam_torch/parallel/dist_vi_ba.py) against the port's single joint
solve and the JAX reference's distributed solve, mirroring
tests/test_dist_vi_ba.py on tests/test_vi_ba.py's problems (same jax keys),
with 8 shards on the CPU.

Tolerances: the reference test's own (both engines recover the trajectory:
positions within 0.05 m, rotations within 0.01 rad; single and distributed
agree: positions 0.02 m, velocities 0.05 m/s; landmarks median 0.03 m),
and against the reference's distributed solve the port's VI-BA parity
tolerances (tests/test_torch_vi_ba.py): states within 1e-4, landmarks 1e-3
relative, validity equal.
"""
import numpy as np
import pytest

import jax

from hfnet_slam_tpu.parallel import dist_vi_ba as Jdv

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from jax.sharding import Mesh as JMesh  # noqa: E402

from hfnet_slam_torch.optim import vi_ba as Tvb  # noqa: E402
from hfnet_slam_torch.parallel import dist_vi_ba as Tdv  # noqa: E402
from hfnet_slam_torch.parallel.multihost import Mesh  # noqa: E402
from test_torch_vi_ba import CAM_T, assert_same, to_port  # noqa: E402
from test_vi_ba import CAM, make_problem, pose_err  # noqa: E402

MESH8 = Mesh(torch.device("cpu"), 8)


def _np(out):
    return out._replace(**{k: getattr(out, k).numpy()
                           for k in ("R_wb", "p_wb", "v", "points", "valid")})


def test_matches_single_joint_and_reference():
    prob, R_gt, p_gt, v_gt, pts_gt = make_problem(jax.random.PRNGKey(3), n_kf=12, m=96,
                                                  noise_px=0.3, perturb=0.02)
    rounds = ((6, True), (8, False))
    pt = to_port(prob)
    single = Tvb.vi_bundle_adjust(CAM_T.kind, CAM_T.params, pt, rounds=rounds)
    dist = Tdv.dist_vi_bundle_adjust(CAM_T.kind, CAM_T.params, pt, MESH8, rounds=rounds)
    ang_s, dp_s = pose_err(_np(single), R_gt, p_gt)
    ang_d, dp_d = pose_err(_np(dist), R_gt, p_gt)
    assert dp_s < 0.05 and dp_d < 0.05 and ang_d < 0.01, (ang_s, dp_s, ang_d, dp_d)
    assert float(np.linalg.norm(single.p_wb.numpy() - dist.p_wb.numpy(), axis=-1).max()) < 0.02
    assert float(np.linalg.norm(single.v.numpy() - dist.v.numpy(), axis=-1).max()) < 0.05
    assert float(np.median(np.linalg.norm(dist.points.numpy() - pts_gt, axis=-1))) < 0.03
    ref = Jdv.dist_vi_bundle_adjust(CAM.kind, CAM.params, prob,
                                    JMesh(np.asarray(jax.devices()[:8]), ("ba",)),
                                    rounds=rounds)
    assert_same(dist, ref)


def test_gauge_anchor_respected():
    prob, *_ = make_problem(jax.random.PRNGKey(5), n_kf=8, m=64, perturb=0.015)
    pt = to_port(prob)
    out = Tdv.dist_vi_bundle_adjust(CAM_T.kind, CAM_T.params, pt, MESH8, rounds=((5, True),))
    np.testing.assert_allclose(out.R_wb[0].numpy(), pt.R_wb[0].numpy(), atol=1e-6)
    np.testing.assert_allclose(out.p_wb[0].numpy(), pt.p_wb[0].numpy(), atol=1e-6)


def test_shard_caps_match_reference():
    for args in ((8, 96, 700), (1, 4911, 30000), (4, 1, 1), (3, 1000, 4097)):
        assert Tdv._shard_caps(*args) == Jdv._shard_caps(*args)


def test_mapper_routes_past_joint_cap(monkeypatch):
    """full_inertial_ba with fiba_dist hands one joint solve to the
    distributed engine when the map exceeds fiba_max_joint."""
    import types

    from hfnet_slam_torch.geometry import cameras as C
    from hfnet_slam_torch.slam.local_mapping import LocalMapper, MapperConfig
    from hfnet_slam_torch.slam.map import MapStore

    cam = C.pinhole(100.0, 100.0, 64.0, 64.0, 128, 128, device="cpu")
    store = MapStore(k_max=16, m_max=256, n_slots=32, desc_dim=8, gdesc_dim=8)
    mapper = LocalMapper(cam, store, MapperConfig(fiba_max_joint=4, fiba_dist=True),
                         device="cpu")
    seen = {}

    def fake_run(opt_ids, fixed_ids, vim, mp_ids, rounds, kf_cap, **kw):
        seen["use_dist"] = kw.get("use_dist", False)
        seen["n_opt"] = len(opt_ids)
        return {}

    monkeypatch.setattr(mapper, "_run_inertial_ba", fake_run)
    rng = np.random.default_rng(0)
    for i in range(8):
        f = types.SimpleNamespace(
            xy=rng.uniform(0, 100, (32, 2)).astype(np.float32),
            desc=np.eye(32, 8, dtype=np.float32), score=np.ones(32, np.float32),
            octave=np.zeros(32, np.int32), mask=np.ones(32, bool),
            global_desc=np.ones(8, np.float32))
        store.add_keyframe(np.eye(3, dtype=np.float32), np.zeros(3, np.float32), f, float(i))
    mapper.full_inertial_ba(vim=None)
    assert seen == {"use_dist": True, "n_opt": 8}
