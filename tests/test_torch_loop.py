"""Loop closing of the port against the JAX reference (port on the CPU):
Sim3 lie algebra, global retrieval scores and candidates, the Sim3 solver
(Horn, RANSAC with the reference's own Gumbel picks, refinement), the Sim3
and 4-DoF pose graph, the loop-correction fuse, global BA, one whole loop
correction on a shared snapshot, and the SMALL loop circuit end to end.

Tolerances: indices and inlier masks exactly; Sim3 R, t, s and pose-graph
poses within 1e-4 (float32 solvers, the same iteration counts, Jacobians
from forward-mode autodiff on both sides)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import T, cams, gumbel_picks  # noqa: E402
from hfnet_slam_tpu import lie as JL  # noqa: E402
from hfnet_slam_torch import lie as TL  # noqa: E402


# ---------------------------------------------------------------------------
# Sim3 lie algebra
# ---------------------------------------------------------------------------

def _xis():
    rng = np.random.default_rng(0)
    xi = rng.normal(0, 0.4, (8, 7)).astype(np.float32)
    xi[0, 3:6] = 0.0    # small theta branch
    xi[1, 6] = 0.0      # small sigma branch
    xi[2, 3:] = 0.0     # both small
    xi[3] *= 1e-6
    return xi


def test_sim3_exp_log_inverse_mul_apply_match_reference():
    xi = _xis()
    Rj, tj, sj = JL.sim3_exp(jnp.asarray(xi))
    Rt, tt, st = TL.sim3_exp(T(xi))
    for a, b in ((Rj, Rt), (tj, tt), (sj, st)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)
    np.testing.assert_allclose(TL.sim3_log(Rt, tt, st).numpy(),
                               np.asarray(JL.sim3_log(Rj, tj, sj)), atol=2e-5)
    for a, b in zip(JL.sim3_inverse(Rj, tj, sj), TL.sim3_inverse(Rt, tt, st)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)
    Rj2, tj2, sj2 = Rj[::-1], tj[::-1], sj[::-1]
    Rt2, tt2, st2 = Rt.flip(0), tt.flip(0), st.flip(0)
    for a, b in zip(JL.sim3_mul(Rj, tj, sj, Rj2, tj2, sj2),
                    TL.sim3_mul(Rt, tt, st, Rt2, tt2, st2)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5)
    p = np.random.default_rng(1).normal(size=(8, 3)).astype(np.float32)
    np.testing.assert_allclose(TL.sim3_apply(Rt, tt, st, T(p)).numpy(),
                               np.asarray(JL.sim3_apply(Rj, tj, sj, jnp.asarray(p))), atol=1e-5)


def test_normalize_rotation_matches_reference():
    rng = np.random.default_rng(2)
    R = np.asarray(JL.so3_exp(jnp.asarray(rng.normal(size=(6, 3)).astype(np.float32))))
    R = R + rng.normal(0, 1e-3, R.shape).astype(np.float32)
    # an improper input with distinct singular values (a unique nearest
    # rotation): the det-sign fix must act
    R[0] = R[0] @ np.diag([1.0, 0.8, -0.6]).astype(np.float32)
    out = TL.normalize_rotation(T(R)).numpy()
    np.testing.assert_allclose(out, np.asarray(JL.normalize_rotation(jnp.asarray(R))), atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(out), 1.0, atol=1e-5)


# ---------------------------------------------------------------------------
# global retrieval scores and candidates
# ---------------------------------------------------------------------------

def test_global_scores_match_reference():
    """Away from the sqrt(2 - 2s) singularity at an exact self-match (a one
    ulp change of s moves the score by 3e-4 there): queries are noisy."""
    from hfnet_slam_tpu.ops import matching as JM
    from hfnet_slam_torch.ops import matching as TM

    rng = np.random.default_rng(0)
    db = rng.normal(size=(40, 4096)).astype(np.float32)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    q = db[:5] + 0.3 * rng.normal(size=(5, 4096)).astype(np.float32) / 64.0
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    mask = rng.uniform(size=40) > 0.2
    for i in range(5):
        np.testing.assert_allclose(
            TM.global_scores(T(q[i]), T(db), T(mask)).numpy(),
            np.asarray(JM.global_scores(jnp.asarray(q[i]), jnp.asarray(db), jnp.asarray(mask))),
            atol=1e-5)
    np.testing.assert_allclose(
        TM.global_scores_batch(T(q), T(db), T(mask)).numpy(),
        np.asarray(JM.global_scores_batch(jnp.asarray(q), jnp.asarray(db), jnp.asarray(mask))),
        atol=1e-5)
    # an exact self-match: within the stated 1e-3 at the singular point
    np.testing.assert_allclose(
        TM.global_scores(T(db[3]), T(db), T(mask)).numpy(),
        np.asarray(JM.global_scores(jnp.asarray(db[3]), jnp.asarray(db), jnp.asarray(mask))),
        atol=1e-3)


def _retrieval_stores(K=20, dim=64, seed=0):
    from hfnet_slam_tpu.slam.map import MapStore as JMapStore
    from hfnet_slam_torch.slam.map import MapStore as TMapStore

    rng = np.random.default_rng(seed)
    g = rng.standard_normal((K, dim)).astype(np.float32)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    out = []
    for cls in (JMapStore, TMapStore):
        store = cls(k_max=32, m_max=64, n_slots=8, desc_dim=8, gdesc_dim=dim)
        store.kf_valid[:K] = True
        store.kf_gdesc[:K] = g
        store.n_kf = K
        # a covisibility ring, so the group accumulation has groups
        for k in range(K):
            store.covis[k, (k + 1) % K] = store.covis[(k + 1) % K, k] = 20 + k
        out.append(store)
    return out, g


@pytest.mark.parametrize("case", ["score_all", "n_best", "n_best_dup", "reloc"])
def test_retrieval_matches_reference(case):
    from hfnet_slam_tpu.slam import retrieval as JR
    from hfnet_slam_torch.slam import retrieval as TR

    (sj, st), g = _retrieval_stores()
    if case == "score_all":
        q = g[3] + 0.05 * g[4]
        q /= np.linalg.norm(q)
        np.testing.assert_allclose(TR.score_all(st, q, device="cpu"), JR.score_all(sj, q), atol=1e-5)
        return
    if case.startswith("n_best"):
        q = g[3] + g[9] + 0.5 * g[10]
        if case == "n_best_dup":
            q = g[3]
            for s in (sj, st):
                s.kf_gdesc[7] = s.kf_gdesc[3]
        q = q / np.linalg.norm(q)
        out_j = JR.detect_n_best_candidates(sj, q, exclude={3}, n=3)
        out_t = TR.detect_n_best_candidates(st, q, exclude={3}, n=3, device="cpu")
        assert out_t == out_j and len(out_t) >= 1
        if case == "n_best_dup":
            assert 7 in out_t and 3 not in out_t
        return
    q = g[5] + 0.05 * g[6]
    q /= np.linalg.norm(q)
    out_j = JR.detect_relocalization_candidates(sj, q)
    out_t = TR.detect_relocalization_candidates(st, q, device="cpu")
    assert out_t == out_j and out_t[0] == 5


# ---------------------------------------------------------------------------
# Sim3 solver
# ---------------------------------------------------------------------------

def _sim3_problem(s_gt=1.3, n_out=30, N=128, seed=0):
    rng = np.random.default_rng(seed)
    cam = cams()[0]
    R_gt = np.asarray(JL.so3_exp(jnp.asarray([0.2, -0.1, 0.3])))
    t_gt = np.array([0.5, -0.2, 0.1], np.float32)
    p2 = rng.uniform(-2, 2, (N, 3)).astype(np.float32) + np.array([0, 0, 6], np.float32)
    p1 = (s_gt * p2 @ R_gt.T + t_gt).astype(np.float32)
    p1[:n_out] += rng.uniform(1, 3, (n_out, 3)).astype(np.float32)
    uv1 = np.asarray(cam.project(jnp.asarray(p1)))
    uv2 = np.asarray(cam.project(jnp.asarray(p2)))
    return (p1, p2, uv1, uv2), (R_gt, t_gt, s_gt)


def test_horn_sim3_matches_reference():
    from hfnet_slam_tpu.optim import sim3 as JS
    from hfnet_slam_torch.optim import sim3 as TS

    (p1, p2, _, _), (R_gt, t_gt, s_gt) = _sim3_problem(n_out=0)
    w = np.random.default_rng(5).uniform(0.2, 1.0, len(p1)).astype(np.float32)
    for kw in (dict(), dict(w=w), dict(fix_scale=True)):
        Rj, tj, sj = JS.horn_sim3(jnp.asarray(p2), jnp.asarray(p1),
                                  **{k: (jnp.asarray(v) if k == "w" else v) for k, v in kw.items()})
        Rt, tt, st = TS.horn_sim3(T(p2), T(p1), **{k: (T(v) if k == "w" else v)
                                                  for k, v in kw.items()})
        np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-5)
        np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)
        np.testing.assert_allclose(float(st), float(sj), atol=1e-5)
    np.testing.assert_allclose(Rt.numpy(), R_gt, atol=1e-4)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_sim3_ransac_and_optimize_match_reference(fix_scale):
    from hfnet_slam_tpu.optim import sim3 as JS
    from hfnet_slam_torch.optim import sim3 as TS

    (p1, p2, uv1, uv2), (R_gt, t_gt, s_gt) = _sim3_problem(s_gt=1.0 if fix_scale else 1.3)
    N = len(p1)
    valid = np.ones(N, bool)
    valid[-5:] = False
    ones = np.ones(N, np.float32)
    key = [3, 4] if fix_scale else [1, 2]
    cj, ct = cams()
    rj = JS.sim3_ransac(cj.kind, cj.params, *(jnp.asarray(x) for x in (p1, p2, uv1, uv2)),
                        jnp.asarray(ones), jnp.asarray(ones), jnp.asarray(valid),
                        jnp.asarray(key, jnp.uint32), n_hyps=128, fix_scale=fix_scale)
    picks = gumbel_picks(key, valid, 128, 3)
    rt = TS.sim3_ransac(ct.kind, ct.params, *(T(x) for x in (p1, p2, uv1, uv2)),
                        T(ones), T(ones), T(valid), T(picks, torch.int64),
                        fix_scale=fix_scale)
    np.testing.assert_array_equal(rt["inliers"].numpy(), np.asarray(rj["inliers"]))
    for k in ("R12", "t12", "s12"):
        np.testing.assert_allclose(rt[k].numpy(), np.asarray(rj[k]), atol=1e-4)
    assert not rt["inliers"].numpy()[:30].any() or fix_scale

    oj = JS.optimize_sim3(cj.kind, cj.params, rj["R12"], rj["t12"], rj["s12"],
                          *(jnp.asarray(x) for x in (p1, p2, uv1, uv2)),
                          jnp.asarray(ones), jnp.asarray(ones), rj["inliers"],
                          fix_scale=fix_scale)
    ot = TS.optimize_sim3(ct.kind, ct.params, rt["R12"], rt["t12"], rt["s12"],
                          *(T(x) for x in (p1, p2, uv1, uv2)), T(ones), T(ones),
                          rt["inliers"], fix_scale=fix_scale)
    np.testing.assert_array_equal(ot["inliers"].numpy(), np.asarray(oj["inliers"]))
    for k in ("R12", "t12", "s12"):
        np.testing.assert_allclose(ot[k].numpy(), np.asarray(oj[k]), atol=1e-4)
    np.testing.assert_allclose(ot["R12"].numpy(), R_gt, atol=1e-3)
    np.testing.assert_allclose(float(ot["s12"]), s_gt, atol=1e-3)


# ---------------------------------------------------------------------------
# essential graph
# ---------------------------------------------------------------------------

def _circle_graph(K=12, noise=0.05, seed=0):
    rng = np.random.default_rng(seed)
    gt_R = np.stack([np.asarray(JL.so3_exp(jnp.asarray([0, 0, 2 * np.pi * k / K], jnp.float32)))
                     for k in range(K)])
    gt_t = np.stack([np.array([np.cos(2 * np.pi * k / K), np.sin(2 * np.pi * k / K), 0],
                              np.float32) for k in range(K)])
    est_t = gt_t + rng.normal(0, noise, (K, 3)).astype(np.float32)
    est_t[0] = gt_t[0]
    return gt_R, gt_t, gt_R.copy(), est_t


@pytest.mark.parametrize("mode,fix_scale", [("sim3", False), ("sim3", True), ("4dof", False)])
def test_pose_graph_matches_reference(mode, fix_scale):
    """Four Gauss-Newton iterations: the ring converges in one. Past that the
    undamped steps of both solvers jitter around the optimum on float32
    round-off, amplified along the weakly observed scale direction (in
    sim3 mode the two drift apart by ~3e-4 after 15 iterations while their
    costs stay equal), so poses are compared where both have converged and
    not yet wandered."""
    from hfnet_slam_tpu.optim import pose_graph as JP
    from hfnet_slam_torch.optim import pose_graph as TP

    gt_R, gt_t, est_R, est_t = _circle_graph()
    K = len(gt_R)
    ones = np.ones(K, np.float32)
    pairs = [(k, k + 1) for k in range(K - 1)]
    Rm, tm, sm, w = JP.make_edges_from_poses(est_R, est_t, ones, pairs)
    edges_t = TP.make_edges_from_poses(est_R, est_t, ones, pairs)
    for a, b in zip((Rm, tm, sm, w), edges_t):
        np.testing.assert_allclose(b, a, atol=1e-6)
    Rl, tl, sl, wl = JP.make_edges_from_poses(gt_R, gt_t, ones, [(0, K - 1)])
    e_i = np.asarray([p[0] for p in pairs] + [0], np.int64)
    e_j = np.asarray([p[1] for p in pairs] + [K - 1], np.int64)
    # padding: an invalid edge and a fixed identity vertex, as loop closing pads
    args = dict(R=np.concatenate([est_R, np.eye(3, dtype=np.float32)[None]]),
                t=np.concatenate([est_t, np.zeros((1, 3), np.float32)]),
                s=np.ones(K + 1, np.float32), fixed=np.arange(K + 1) % K == 0,
                e_i=np.append(e_i, 0), e_j=np.append(e_j, 0),
                e_R=np.concatenate([Rm, Rl, np.eye(3, dtype=np.float32)[None]]),
                e_t=np.concatenate([tm, tl, np.zeros((1, 3), np.float32)]),
                e_s=np.concatenate([sm, sl, [1.0]]).astype(np.float32),
                e_w=np.concatenate([w, wl * 5, [0.0]]).astype(np.float32),
                e_valid=np.arange(K + 1) < K)
    oj, cj = JP.optimize_pose_graph(
        JP.PoseGraphProblem(**{k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
                               for k, v in args.items()}),
        n_iters=4, fix_scale=fix_scale, mode=mode)
    ot, ct = TP.optimize_pose_graph(TP.PoseGraphProblem(**{k: T(v) for k, v in args.items()}),
                                    n_iters=4, fix_scale=fix_scale, mode=mode)
    for a, b in ((oj.R, ot.R), (oj.t, ot.t), (oj.s, ot.s)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-3, atol=1e-6)
    assert float(ct[-1]) < 0.1 * float(ct[0])


# ---------------------------------------------------------------------------
# loop-correction fuse
# ---------------------------------------------------------------------------

def test_fuse_targets_banked_matches_reference():
    """Targets gathered from a keyframe bank, explicit (P,C) candidate ids
    with -1 padding, removed points and an empty target row."""
    from hfnet_slam_tpu.slam import fused as JF
    from hfnet_slam_torch.slam import fused as TF

    rng = np.random.default_rng(4)
    cj, ct = cams()
    K, N, D, M, P, C = 6, 96, 32, 160, 4, 128
    lm = rng.uniform(-3, 3, (M, 3)).astype(np.float32) + np.array([0, 0, 8], np.float32)
    m_desc = rng.normal(size=(M, D)).astype(np.float32)
    m_desc /= np.linalg.norm(m_desc, axis=1, keepdims=True)
    m_valid = rng.uniform(size=M) > 0.1
    poses = [(np.asarray(JL.so3_exp(jnp.asarray(rng.normal(0, 0.03, 3).astype(np.float32)))),
              rng.normal(0, 0.2, 3).astype(np.float32)) for _ in range(K)]
    b_xy = np.zeros((K, N, 2), np.float32)
    b_desc = np.zeros((K, N, D), np.float32)
    b_oct = rng.integers(0, 3, (K, N)).astype(np.int32)
    b_mask = np.zeros((K, N), bool)
    for k, (R, t) in enumerate(poses):
        ids = rng.choice(M, N, replace=False)
        uv = np.asarray(cj.project(jnp.asarray(lm[ids] @ R.T + t)))
        b_xy[k] = uv + rng.normal(0, 1.0, uv.shape)
        d = m_desc[ids] + rng.normal(0, 0.04, (N, D))
        b_desc[k] = d / np.linalg.norm(d, axis=1, keepdims=True)
        b_mask[k] = rng.uniform(size=N) > 0.1
    tgt = np.array([2, 0, 5, -1])
    R_t = np.stack([poses[max(i, 0)][0] for i in tgt])
    t_t = np.stack([poses[max(i, 0)][1] for i in tgt])
    cand = np.full((P, C), -1, np.int64)
    for p in range(P):
        cand[p, : C - 10 * p] = rng.choice(M, C - 10 * p, replace=False)
    args = (R_t, t_t, b_xy, b_desc, b_oct, b_mask, lm, m_desc, m_valid)
    ij = np.asarray(JF.fuse_targets_banked(
        cj.kind, cj.params, 640.0, 480.0, jnp.asarray(tgt.astype(np.int32)),
        jnp.asarray(cand.astype(np.int32)), *(jnp.asarray(a) for a in args),
        radius=8.0, max_dist=0.75))
    it = TF.fuse_targets_banked(ct.kind, ct.params, 640.0, 480.0, T(tgt), T(cand),
                                *(T(a) for a in args), radius=8.0, max_dist=0.75).numpy()
    np.testing.assert_array_equal(it, ij)
    assert (it[:3] >= 0).sum() > 50 and (it[3] < 0).all()


# ---------------------------------------------------------------------------
# global BA
# ---------------------------------------------------------------------------

def test_run_global_ba_matches_reference(tmp_path):
    """tests/test_gba.py's synthetic 60-keyframe ring, past every single-
    solver cap: the reference solves it through its distributed Schur path,
    the port through its single solver sized to the whole problem (the same
    math). Float32 LM with sums in another order: poses within 1e-3 of the
    reference's, and both improve the mean camera error threefold."""
    from test_gba import _pose_err, circle_store
    from hfnet_slam_tpu.slam.local_mapping import LocalMapper as JMapper
    from hfnet_slam_tpu.slam.local_mapping import MapperConfig as JMapperConfig
    from hfnet_slam_torch.convert import store_from_reference
    from hfnet_slam_torch.slam.local_mapping import LocalMapper as TMapper
    from hfnet_slam_torch.slam.local_mapping import MapperConfig as TMapperConfig

    store_j, cam_j, gt_R, gt_t = circle_store(K=60, P=500, obs_per_kf=25, seed=2)
    anchors = [0, 20, 40]
    for a in anchors:
        store_j.kf_R[a] = gt_R[a]
        store_j.kf_t[a] = gt_t[a]
    path = str(tmp_path / "ring.npz")
    store_j.save(path)
    store_t = store_from_reference(path)
    kf_ids = store_j.valid_kf_ids()
    before = _pose_err(store_j, gt_R, gt_t, kf_ids).mean()
    rounds = ((10, True), (8, False))
    JMapper(cam_j, store_j, JMapperConfig()).run_global_ba(fixed_ids=anchors, rounds=rounds)
    TMapper(cams()[1], store_t, TMapperConfig(), device="cpu").run_global_ba(
        fixed_ids=anchors, rounds=rounds)
    np.testing.assert_allclose(store_t.kf_t[kf_ids], store_j.kf_t[kf_ids], atol=1e-3)
    np.testing.assert_allclose(store_t.kf_R[kf_ids], store_j.kf_R[kf_ids], atol=1e-3)
    for s in (store_j, store_t):
        assert _pose_err(s, gt_R, gt_t, kf_ids).mean() < before / 3
    assert store_t.big_change_idx == 1 and store_t.kf_valid.sum() == 60


# ---------------------------------------------------------------------------
# one loop correction on a shared snapshot
# ---------------------------------------------------------------------------

def _drifted_ring(path, K=24, per_lap=20, N=128, D=32, G=16, drift=1.12, j0=18, seed=0):
    """A 24-keyframe ring (20 per lap, so keyframes 20-23 revisit 0-3),
    built with numpy in the reference's MapStore and saved to `path`.
    From keyframe j0 on, keyframes and the points they create live in a
    gauge scaled by `drift` about keyframe j0's centre (monocular scale
    drift); keyframe j0 also observes the gauge-A points it shares with
    j0-1, which a scaling about its own centre leaves unchanged in its
    image. Every observation reprojects to within its 0.3 px noise; the
    revisiting keyframes carry duplicates of the first lap's points."""
    from hfnet_slam_tpu.slam.map import MapStore
    from hfnet_slam_torch.scenes import ring_pose, ring_world

    rng = np.random.default_rng(seed)
    lm, desc, _ = ring_world(1500, D, seed=11)
    poses = [ring_pose(i, per_lap, 2 * np.pi) for i in range(K)]
    c0 = -poses[j0][0].T @ poses[j0][1]
    vis = []
    for R, t in poses:
        pc = lm @ R.T + t
        z = np.maximum(pc[:, 2], 1e-9)
        uv = np.stack([450.0 * pc[:, 0] / z + 320.0, 450.0 * pc[:, 1] / z + 240.0], 1)
        ok = ((pc[:, 2] > 0.5) & (pc[:, 2] < 25) & (uv[:, 0] >= 1) & (uv[:, 0] < 639)
              & (uv[:, 1] >= 1) & (uv[:, 1] < 479))
        ids = np.nonzero(ok)[0]
        vis.append((ids[np.argsort(rng.uniform(size=len(ids)))][: N - 8], uv))
    shared = set(vis[j0 - 1][0].tolist())

    def key(i, l):  # one point per (landmark, gauge)
        return int(l), i >= j0 and not (i == j0 and int(l) in shared)

    keys = {}
    for i, (ids, _) in enumerate(vis):
        for l in ids:
            keys.setdefault(key(i, l), i)
    store = MapStore(k_max=32, m_max=4096, n_slots=N, desc_dim=D, gdesc_dim=G)
    pos = np.asarray([c0 + drift * (lm[l] - c0) if b else lm[l] for l, b in keys], np.float32)
    d = np.asarray([desc[l] for l, _ in keys]) + rng.normal(0, 0.02, (len(keys), D))
    ids_all = store.add_points(pos, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32))
    store.mp_first_kf[ids_all] = list(keys.values())
    loc = {k: int(ids_all[n]) for n, k in enumerate(keys)}

    class F:
        pass

    for i, (ids, uv) in enumerate(vis):
        R, t = poses[i]
        if i >= j0:  # T' = T o S^-1 with S(p) = c0 + s (p - c0), scale folded
            t = drift * (t + R @ c0) - R @ c0
        n = len(ids)
        f = F()
        f.xy = np.zeros((N, 2), np.float32)
        f.xy[:n] = uv[ids] + rng.normal(0, 0.3, (n, 2))
        dd = desc[ids] + rng.normal(0, 0.03, (n, D))
        f.desc = np.zeros((N, D), np.float32)
        f.desc[:n] = dd / np.linalg.norm(dd, axis=1, keepdims=True)
        f.score = np.ones(N, np.float32)
        f.octave = np.zeros(N, np.int32)
        f.mask = np.arange(N) < n
        th = 2 * np.pi * i / per_lap
        g = np.concatenate([[np.cos(m * th), np.sin(m * th)] for m in range(1, G // 2 + 1)])
        g = g + rng.normal(0, 0.05, G)
        f.global_desc = (g / np.linalg.norm(g)).astype(np.float32)
        obs = np.full(N, -1, np.int32)
        obs[:n] = [loc[key(i, l)] for l in ids]
        store.add_keyframe(R, t, f, 0.1 * i, obs=obs)
    store.save(path)


def _snapshot_correction(pkg, path, run_gba, monkeypatch):
    """Load the snapshot into `pkg`, run its LoopCloser on keyframe 23 and
    return (store, the _correct_loop arguments, loop stats). The port gets
    the reference's RANSAC picks: its generator's draws are replaced by the
    Gumbel picks of the keys the reference draws from default_rng(7)."""
    loop_kw = dict(min_pair_matches=30, min_sim3_inliers=15, min_proj_matches=30,
                   consistency_hits=1, n_covis_window=5, window_mp_cap=512, pair_cap=256,
                   ransac_hyps=128, gba_kf_cap=32, gba_mp_cap=2048, gba_edge_cap=4096,
                   run_gba=run_gba)
    cj, ct = cams()
    if pkg == "tpu":
        from hfnet_slam_tpu.slam import loop_closing as LC
        from hfnet_slam_tpu.slam.local_mapping import LocalMapper, MapperConfig
        from hfnet_slam_tpu.slam.map import MapStore
        store = MapStore.load(path)
        lc = LC.LoopCloser(cj, store, LC.LoopCloserConfig(**loop_kw),
                           mapper=LocalMapper(cj, store, MapperConfig()))
    else:
        from hfnet_slam_torch.convert import store_from_reference
        from hfnet_slam_torch.slam import loop_closing as LC
        from hfnet_slam_torch.slam.local_mapping import LocalMapper, MapperConfig
        store = store_from_reference(path)
        lc = LC.LoopCloser(ct, store, LC.LoopCloserConfig(**loop_kw),
                           mapper=LocalMapper(ct, store, MapperConfig(), device="cpu"),
                           device="cpu")
        keys = np.random.default_rng(7)

        def ref_picks(valid, n_hyps, k, generator):
            return T(gumbel_picks(keys.integers(0, 2**31, 2), valid.numpy(), n_hyps, k),
                     torch.int64)
        monkeypatch.setattr(LC.pnp, "draw_picks", ref_picks)
    seen = []
    real = lc._correct_loop
    lc._correct_loop = lambda *a: (seen.append(a), real(*a))[1]
    assert lc.process_keyframe(23)
    return store, seen[0], lc.stats


@pytest.mark.parametrize("run_gba", [False, True])
def test_one_loop_correction_matches_reference_on_a_snapshot(tmp_path, monkeypatch, run_gba):
    """The whole correction path on one shared map: retrieval, brute-force
    association, Sim3 RANSAC + refinement, window propagation, the fuse,
    the essential graph and (run_gba) global BA. Candidate and loop points
    exactly; Sim3 within 1e-4; keyframe poses after the pose graph within
    1e-4; observations after the fuse exactly. After global BA, rotations
    within 1e-3 and translations within 1e-2 m on the 6 m ring: the BA fixes
    only the candidate, so its monocular scale is weakly held, and two
    float32 LMs summing in different orders settle along it differently
    (8 mm apart here)."""
    path = str(tmp_path / "ring.npz")
    _drifted_ring(path)
    sj, aj, stats_j = _snapshot_correction("tpu", path, run_gba, monkeypatch)
    st, at, stats_t = _snapshot_correction("torch", path, run_gba, monkeypatch)
    assert stats_t == stats_j and stats_t["corrected"] == 1
    k, cand, R_cm, t_cm, s_cm, loop_mps = at
    assert (k, cand) == aj[:2] and cand in (2, 3, 4)
    np.testing.assert_array_equal(loop_mps, aj[5])
    for a, b in zip(aj[2:5], (R_cm, t_cm, s_cm)):
        np.testing.assert_allclose(b, a, atol=1e-4)
    assert abs(s_cm - 1.12) < 0.02  # the drift: k lives in the 1.12-scaled gauge
    assert st.loop_edges == sj.loop_edges == [(cand, 23)]
    kfs = sj.valid_kf_ids()
    np.testing.assert_allclose(st.kf_R[kfs], sj.kf_R[kfs], atol=1e-3 if run_gba else 1e-4)
    np.testing.assert_allclose(st.kf_t[kfs], sj.kf_t[kfs], atol=1e-2 if run_gba else 1e-4)
    if not run_gba:
        np.testing.assert_array_equal(st.kf_obs, sj.kf_obs)
        np.testing.assert_array_equal(st.mp_valid, sj.mp_valid)
        assert (st.kf_obs[23] >= 0).sum() > 0


# ---------------------------------------------------------------------------
# the loop circuit end to end
# ---------------------------------------------------------------------------

def test_whole_circuit_matches_reference(monkeypatch):
    """The SMALL loop circuit (tests/test_loop.py's 170-frame run, 512
    slots, 64-d) through SLAMSystem.track_features on both packages, sync
    mode, loop closing on. Both must correct at least one loop, their
    correction counts within +-1; the port's post-correction ATE (bench.py's
    sync protocol, scale-corrected) <= max(2 x the reference's, 0.02 m);
    and loop association must reach search_brute_force at the window width
    (the row_top2 kernel's loop shape on CUDA)."""
    from _torch_parity import LOOP_SMALL, build_loop, run_loop
    from hfnet_slam_torch.slam import search as TS

    sys_j, ext_j = build_loop("tpu")
    pre_j, post_j, n_j = run_loop(sys_j, ext_j, LOOP_SMALL)

    shapes = []
    real = TS.search_brute_force

    def spy(dA, mA, dB, mB, **kw):
        shapes.append((dA.shape[0], dB.shape[0], dA.device.type))
        return real(dA, mA, dB, mB, **kw)

    monkeypatch.setattr(TS, "search_brute_force", spy)
    sys_t, ext_t = build_loop("torch", device="cpu")
    pre_t, post_t, n_t = run_loop(sys_t, ext_t, LOOP_SMALL)

    c_j = sys_j.loop_closer.stats["corrected"]
    c_t = sys_t.loop_closer.stats["corrected"]
    assert c_j >= 1 and c_t >= 1 and abs(c_t - c_j) <= 1, (sys_j.loop_closer.stats,
                                                          sys_t.loop_closer.stats)
    assert len(sys_t.store.loop_edges) >= 1
    assert np.isfinite(post_t) and post_t <= max(2 * post_j, 0.02), (post_t, post_j)
    assert n_t >= n_j - 5
    win = LOOP_SMALL["loop"]["window_mp_cap"]
    assert (512, win, "cpu") in shapes, sorted(set(shapes))
    s = sys_t.store
    assert np.isfinite(s.mp_pos[s.mp_valid]).all() and np.isfinite(s.kf_t[s.kf_valid]).all()
