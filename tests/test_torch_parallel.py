"""Parity of the port's mesh layer (hfnet_slam_torch/parallel/) with the JAX
reference's (hfnet_slam_tpu/parallel/), on the CPU. The reference runs on
tests/conftest.py's 8 virtual CPU devices; the port's Mesh computes the same
8 shards batched in one process.

Tolerances (float32; the psum over shards and the segment sums add in
another order):
  * partition_edges: every bucket array identical;
  * one dist_lm_step: poses TOL_STEP, landmarks TOL_STEP relative to their
    distance, the cost TOL_STEP relative; the accept flag equal;
  * 8 LM steps and dist_bundle_adjust: poses TOL_SOLVE, landmarks
    TOL_SOLVE relative, the edge classification equal;
  * sharded retrieval: scores TOL_SCORE of the single-shard scan, the
    candidate order (ties included) equal;
  * run_global_ba through the dist route on one map snapshot: camera
    centres within TOL_GBA m of the reference's, and within TOL_MESH m
    between a 1-shard and a 4-shard mesh: 18 float32 LM iterations on a
    6 m ring, whose near-gauge directions let sums in another order move a
    centre by up to ~1.5e-3 m (chip_smoke.py's phase 18 holds the card to
    TOL_MESH).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402

from hfnet_slam_tpu.parallel import dist_ba as JD  # noqa: E402
from hfnet_slam_tpu.parallel import retrieval as JR  # noqa: E402
from hfnet_slam_torch.geometry import cameras as TC  # noqa: E402
from hfnet_slam_torch.parallel import dist_ba as TD  # noqa: E402
from hfnet_slam_torch.parallel import multihost as TM  # noqa: E402
from hfnet_slam_torch.parallel import retrieval as TR  # noqa: E402
from test_parallel import make_problem  # noqa: E402

TOL_STEP = 1e-4
TOL_SOLVE = 1e-3
TOL_SCORE = 1e-6
TOL_GBA = 1e-3
TOL_MESH = 2e-3
CPU = torch.device("cpu")


def _mesh8():
    return JMesh(np.array(jax.devices()[:8]), ("ba",))


def _cam_t(cam):
    return TC.Camera(cam.kind, torch.tensor(np.asarray(cam.params)), cam.width, cam.height)


def _packed(seed, Ml=16, El=64, outliers=False, depth=False, M=64):
    rng = np.random.default_rng(seed)
    cam, R, t, fixed, pts_true, pts_n, (kf, pt, uv) = make_problem(rng, M=M)
    E = len(kf)
    uv = uv.copy()
    if outliers:  # tests/test_parallel.py's corrupted 5%
        n_out = E // 20
        bad = rng.choice(E, n_out, replace=False)
        uv[bad] += rng.uniform(40, 80, (n_out, 2)).astype(np.float32)
    z = wz = None
    if depth:  # every third edge carries a depth row (RGB-D)
        pc = np.einsum("eij,ej->ei", R[kf], pts_true[pt]) + t[kf]
        z = np.where(np.arange(E) % 3 == 0, pc[:, 2], 0.0).astype(np.float32)
        wz = np.where(z > 0, 45.0 / np.maximum(z, 1e-3) ** 2, 0.0).astype(np.float32)
    args = (8, len(R), Ml, El, R, t, fixed, pts_n.astype(np.float32), kf, pt, uv,
            np.ones(E, np.float32), np.ones(E, bool))
    j, jmaps = JD.partition_edges(*args, z_meas=z, wz=wz)
    p, pmaps = TD.partition_edges(*args, z_meas=z, wz=wz, device="cpu")
    return cam, pts_true, pts_n, (j, jmaps), (p, pmaps)


@pytest.mark.parametrize("caps", [(16, 64), (4, 8)])  # exact and overflowing
def test_partition_edges_buckets_match_reference(caps):
    _, _, _, (j, jmaps), (p, pmaps) = _packed(0, *caps, depth=True)
    for f in TD.ShardedBA._fields:
        np.testing.assert_array_equal(getattr(p, f).numpy(), np.asarray(getattr(j, f)), f)
    for a, b in zip(pmaps, jmaps):
        np.testing.assert_array_equal(a, b)


def _assert_points(p_pts, j_pts, tol):
    j_pts = np.asarray(j_pts)
    err = np.linalg.norm(p_pts.numpy() - j_pts, axis=-1) / np.maximum(
        np.linalg.norm(j_pts, axis=-1), 1.0)
    assert err.max() <= tol, err.max()


@pytest.mark.parametrize("depth", [False, True])
def test_dist_lm_step_matches_reference_8_shards(depth):
    cam, _, _, (j, _), (p, _) = _packed(0, depth=depth)
    mesh_p = TM.Mesh(CPU, 8)
    cam_t = _cam_t(cam)
    jo = JD.dist_lm_step(cam.kind, cam.params, j, _mesh8(), lam=1e-3)
    po = TD.dist_lm_step(cam_t.kind, cam_t.params, p, mesh_p, lam=1e-3)
    np.testing.assert_allclose(po[0].numpy(), np.asarray(jo[0]), atol=TOL_STEP)
    np.testing.assert_allclose(po[1].numpy(), np.asarray(jo[1]), atol=TOL_STEP)
    _assert_points(po[2], jo[2], TOL_STEP)
    assert float(po[3]) == pytest.approx(float(jo[3]), rel=1e-6)
    assert float(po[4]) == pytest.approx(float(jo[4]), rel=TOL_STEP)
    assert bool(po[5]) == bool(jo[5])
    # eight steps in a row, lambda carried as the reference's test does
    lam_j = lam_p = 1e-3
    for _ in range(8):
        R, t, pts, lam_j, _, _ = JD.dist_lm_step(cam.kind, cam.params, j, _mesh8(), lam=lam_j)
        j = j._replace(poses_R=R, poses_t=t, points=pts)
        R, t, pts, lam_p, _, _ = TD.dist_lm_step(cam_t.kind, cam_t.params, p, mesh_p, lam=lam_p)
        p = p._replace(poses_R=R, poses_t=t, points=pts)
    np.testing.assert_allclose(p.poses_t.numpy(), np.asarray(j.poses_t), atol=TOL_SOLVE)
    _assert_points(p.points, j.points, TOL_SOLVE)


def test_dist_lm_step_shard_count_does_not_change_the_step():
    """The same problem packed for 1 and for 8 shards: one step agrees."""
    rng = np.random.default_rng(4)
    cam, R, t, fixed, _, pts_n, (kf, pt, uv) = make_problem(rng)
    E = len(kf)
    cam_t = _cam_t(cam)
    out = []
    for n, Ml, El in ((1, 64, 512), (8, 16, 64)):
        prob, (owner, local, _) = TD.partition_edges(
            n, len(R), Ml, El, R, t, fixed, pts_n.astype(np.float32), kf, pt, uv,
            np.ones(E, np.float32), np.ones(E, bool), device="cpu")
        Rn, tn, pts, _, cost, _ = TD.dist_lm_step(cam_t.kind, cam_t.params, prob,
                                                  TM.Mesh(CPU, n), lam=1e-3)
        out.append((tn.numpy(), pts.numpy()[owner, local], float(cost)))
    np.testing.assert_allclose(out[0][0], out[1][0], atol=TOL_STEP)
    np.testing.assert_allclose(out[0][1], out[1][1], atol=TOL_STEP * 10)
    assert out[0][2] == pytest.approx(out[1][2], rel=TOL_STEP)


def test_dist_bundle_adjust_schedule_matches_reference():
    """tests/test_parallel.py's schedule check on the port, then against the
    reference's run: converges, flags the corrupted 5%, same final state."""
    cam, pts_true, pts_n, (j, (owner, local, _)), (p, _) = _packed(2, outliers=True)
    rounds = ((12, True), (8, False))
    cam_t = _cam_t(cam)
    po, pv, pc = TD.dist_bundle_adjust(cam_t.kind, cam_t.params, p, TM.Mesh(CPU, 8),
                                       rounds=rounds)
    jo, jv, jc = JD.dist_bundle_adjust(cam.kind, cam.params, j, _mesh8(), rounds=rounds)
    assert pc[-1] < pc[0] * 0.5, pc
    n_in = int(p.valid.sum())
    assert 0.8 * n_in < int(pv.sum()) < n_in
    rec = po.points.numpy()[owner, local]
    assert np.linalg.norm(rec - pts_true, axis=1).mean() < \
        0.55 * np.linalg.norm(pts_n - pts_true, axis=1).mean()
    np.testing.assert_array_equal(pv, np.asarray(jv))
    np.testing.assert_allclose(po.poses_t.numpy(), np.asarray(jo.poses_t), atol=TOL_SOLVE)
    _assert_points(po.points, jo.points, TOL_SOLVE)
    np.testing.assert_allclose(pc, jc, rtol=TOL_SOLVE)


def test_dist_bundle_adjust_abort_stops_between_iterations():
    cam, _, _, _, (p, _) = _packed(3)
    cam_t = _cam_t(cam)
    calls = []

    def abort():
        calls.append(1)
        return len(calls) > 3

    _, _, costs = TD.dist_bundle_adjust(cam_t.kind, cam_t.params, p, TM.Mesh(CPU, 8),
                                        rounds=((5, True), (5, True)), should_abort=abort)
    assert len(costs) == 1 + 3  # the initial cost and the three iterations run


# -- multihost helpers and sharded retrieval ---------------------------------

def test_initialize_is_noop_single_process():
    assert TM.initialize() is False


def test_meshes_and_process_shard():
    mesh = TM.make_mesh(device="cpu", n_local=8)
    assert mesh.axis_names == ("kf",) and mesh.size == 8 and mesh.shape == {"kf": 8}
    hm = TM.make_hybrid_mesh(device="cpu", n_local=4)
    assert hm.axis_names == ("host", "kf") and hm.shape == {"host": 1, "kf": 4}
    assert TM.process_shard(256) == (0, 256)
    spans = [TM.process_shard(100, i, 3) for i in range(3)]
    assert spans[0][0] == 0 and spans[-1][1] == 100
    assert all(b == c for (_, b), (c, _) in zip(spans, spans[1:]))
    # the psum of per-shard terms is their sum
    x = torch.arange(24.0).reshape(8, 3)
    np.testing.assert_array_equal(mesh.psum(x).numpy(), x.sum(0).numpy())


def _table(rng, K=64, G=16, dup=((5, 9), (20, 3))):
    rows = rng.normal(size=(K, G)).astype(np.float32)
    for a, b in dup:  # equal rows: equal scores, ties in keyframe order
        rows[b] = rows[a]
    return rows / np.linalg.norm(rows, axis=1, keepdims=True)


@pytest.mark.parametrize("K", [64, 61])
def test_sharded_retrieval_matches_single_scan_and_reference(K):
    from hfnet_slam_torch.ops import matching as TMat

    rng = np.random.default_rng(0)
    rows = _table(rng, K)
    valid = rng.uniform(size=K) > 0.1
    queries = rows[[5, 20, 33]] + 0.01 * rng.normal(size=(3, rows.shape[1])).astype(np.float32)
    mesh = TM.make_mesh(device="cpu", n_local=8)
    db, vm = TR.make_sharded_db(mesh, rows, valid)
    sc = TR.sharded_scores(mesh, queries, db, vm)[:, :K]
    single = TMat.global_scores_batch(torch.tensor(queries), torch.tensor(rows),
                                      torch.tensor(valid))
    np.testing.assert_allclose(sc.numpy(), single.numpy(), atol=TOL_SCORE)
    idx, vals = TR.top_candidates(mesh, queries, db, vm, n=5)
    order = np.argsort(-single.numpy(), axis=1, kind="stable")[:, :5]
    np.testing.assert_array_equal(idx.numpy(), order)
    if K % 8 == 0:  # the reference needs K to be a multiple of the mesh
        jdb, jvm = JR.make_sharded_db(_mesh8(), rows, valid)
        jidx, _ = JR.top_candidates(_mesh8(), jnp.asarray(queries), jdb, jvm, n=5)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


def test_global_array_and_sharded_retrieval():
    """tests/test_parallel.py's TestMultihost retrieval check on the port."""
    mesh = TM.make_mesh(device="cpu", n_local=8)
    rng = np.random.default_rng(0)
    rows = rng.normal(size=(64, 16)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    g = TM.global_array(rows, mesh)
    assert g.shape == (8, 8, 16)
    np.testing.assert_allclose(g.reshape(64, 16).numpy(), rows, rtol=1e-6)
    db, vm = TR.make_sharded_db(mesh, rows, np.ones(64, bool))
    idx, _ = TR.top_candidates(mesh, rows[:2], db, vm, n=3)
    assert int(idx[0, 0]) == 0 and int(idx[1, 0]) == 1


# -- the mapper's dist route on one map snapshot -------------------------------

@pytest.fixture(scope="module")
def ring(tmp_path_factory):
    """tests/test_gba.py's 60-keyframe ring, three anchors at ground truth."""
    from test_gba import circle_store
    store_j, cam_j, gt_R, gt_t = circle_store(K=60, P=500, obs_per_kf=25, seed=2)
    for a in (0, 20, 40):
        store_j.kf_R[a], store_j.kf_t[a] = gt_R[a], gt_t[a]
    path = str(tmp_path_factory.mktemp("ring") / "ring.npz")
    store_j.save(path)
    return path, cam_j


def _port_gba(path, cam_j, mesh=None, mesh_kfs=48):
    from hfnet_slam_torch.convert import store_from_reference
    from hfnet_slam_torch.slam.local_mapping import LocalMapper, MapperConfig

    store = store_from_reference(path)
    mapper = LocalMapper(_cam_t(cam_j), store, MapperConfig(), device="cpu")
    if mesh is not None:
        mapper.mesh, mapper.dist_min_kfs = mesh, mesh_kfs
    mapper.run_global_ba(fixed_ids=[0, 20, 40], rounds=((10, True), (8, False)))
    return store, mapper.stats


def _centres(store, ids):
    return np.einsum("kji,kj->ki", store.kf_R[ids], -store.kf_t[ids])


def test_run_global_ba_dist_route_matches_reference(ring):
    """Past ba_kf_cap both packages route the ring through their distributed
    solver on a one-shard mesh: the same poses, and dist_gba counted."""
    from hfnet_slam_tpu.slam.local_mapping import LocalMapper as JMapper
    from hfnet_slam_tpu.slam.local_mapping import MapperConfig as JCfg
    from hfnet_slam_tpu.slam.map import MapStore as JStore

    path, cam_j = ring
    store_j = JStore.load(path)
    jm = JMapper(cam_j, store_j, JCfg())
    jm.run_global_ba(fixed_ids=[0, 20, 40], rounds=((10, True), (8, False)))
    store_t, stats = _port_gba(path, cam_j)
    assert stats.get("dist_gba") == 1 and jm.stats.get("dist_gba") == 1
    ids = store_j.valid_kf_ids()
    assert np.linalg.norm(_centres(store_t, ids) - _centres(store_j, ids), axis=1).max() \
        <= TOL_GBA
    assert int(store_t.mp_valid.sum()) == int(store_j.mp_valid.sum())


def test_run_global_ba_on_a_4_shard_mesh_matches_one_shard(ring):
    path, cam_j = ring
    one, st1 = _port_gba(path, cam_j)
    four, st4 = _port_gba(path, cam_j, mesh=TM.Mesh(CPU, 4), mesh_kfs=48)
    assert st1["dist_gba"] == st4["dist_gba"] == 1
    ids = one.valid_kf_ids()
    assert np.linalg.norm(_centres(one, ids) - _centres(four, ids), axis=1).max() <= TOL_MESH
    # an installed mesh also takes solves under the caps once they reach
    # dist_min_kfs keyframes
    from hfnet_slam_torch.convert import store_from_reference
    from hfnet_slam_torch.slam.local_mapping import LocalMapper, MapperConfig
    mapper = LocalMapper(_cam_t(cam_j), store_from_reference(path),
                         MapperConfig(ba_kf_cap=64, ba_mp_cap=4096, ba_edge_cap=16384),
                         device="cpu")
    mapper.run_global_ba(fixed_ids=[0], rounds=((1, True),))
    assert "dist_gba" not in mapper.stats
    mapper.mesh, mapper.dist_min_kfs = TM.Mesh(CPU, 2), 12
    mapper.run_global_ba(fixed_ids=[0], rounds=((1, True),))
    assert mapper.stats["dist_gba"] == 1
