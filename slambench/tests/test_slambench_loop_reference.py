"""The plain loop-correction solvers (reference/loop.py) against hand
truths: the Sim(3) exponential and logarithm invert each other; the plain
Sim3 refinement lands where the port's does; each excess reads 1 for a
problem's own start and about 0 for the reference's minimum; the global BA
with the points eliminated lands where the dense local BA of reference/ba.py
lands; a share is read problem by problem, rounding reads near 0 and a
small problem left unsolved about 1."""
import pytest
import torch

from slambench.reference import ba as RB
from slambench.reference import loop as RL

from test_slambench_arith import _ba_problem

F64 = torch.float64


def test_sim3_exp_log_round_trip():
    g = torch.Generator().manual_seed(1)
    xi = torch.randn(64, 7, generator=g, dtype=F64) * torch.tensor([1, 1, 1, 0.8, 0.8, 0.8, 0.3],
                                                                   dtype=F64)
    xi[:8] *= 1e-6       # the series branches
    assert torch.allclose(RL.sim3_log(*RL.sim3_exp(xi)), xi, atol=1e-9)
    phi = torch.tensor([[3.1, 0.05, -0.02]], dtype=F64)       # near pi
    assert torch.allclose(RL.so3_log(RL.so3_exp(phi)), phi, atol=1e-7)


def _sim3_problem(n=60, seed=0):
    """Matched points in two cameras related by a Sim3, their pixels with
    0.5 px noise and a tenth of them moved far; the start is the truth
    pushed off."""
    g = torch.Generator().manual_seed(seed)
    cam = torch.tensor([400.0, 400.0, 320.0, 240.0], dtype=F64)
    p1 = torch.rand(n, 3, generator=g, dtype=F64) * torch.tensor([4.0, 3.0, 3.0]) \
        + torch.tensor([-2.0, -1.5, 4.0])
    S = RL.sim3_exp(torch.tensor([0.2, -0.1, 0.3, 0.05, -0.03, 0.02, 0.1], dtype=F64))
    Ri, ti, si = RL.sim3_inverse(*S)
    p2 = si * (p1 @ Ri.T) + ti
    u1 = RL.project(cam, p1) + 0.5 * torch.randn(n, 2, generator=g, dtype=F64)
    u2 = RL.project(cam, p2) + 0.5 * torch.randn(n, 2, generator=g, dtype=F64)
    u1[: n // 10] += 40.0
    start = RL.sim3_mul(*S, *RL.sim3_exp(torch.tensor([0.01, 0.02, -0.01, 0.004, 0.0, -0.003,
                                                       0.02], dtype=F64)))
    ones = torch.ones(n, dtype=F64)
    return cam, start, [p1, p2, u1, u2, ones, ones], torch.ones(n, dtype=torch.bool)


def test_sim3_refine_follows_the_programs_refinement():
    """The plain refinement and the port's optim/sim3.optimize_sim3 (float32,
    on the CPU) from the same start land on the same Sim3 and inliers; with
    no iteration the plain one returns its start."""
    from hfnet_slam_torch.optim import sim3

    cam, start, pairs, valid = _sim3_problem()
    R, t, s, inl = RL.sim3_refine(cam, start, pairs, valid)
    f32 = [x.float() for x in pairs]
    out = sim3.optimize_sim3(0, cam.float(), *(x.float() for x in start), *f32, valid)
    assert torch.equal(out["inliers"], inl) and int(inl.sum()) == 54
    for k, v in (("R12", R), ("t12", t), ("s12", s)):
        assert torch.allclose(out[k].double(), v, atol=1e-5), k
    R0, t0, s0, _ = RL.sim3_refine(cam, start, pairs, valid, n_iters=0)
    assert torch.equal(R0, start[0]) and torch.equal(t0, start[1]) and torch.equal(s0, start[2])
    assert float(torch.max(torch.abs(t - start[1]))) > 1e-3


def test_sim3_excess_reads_one_for_the_start_and_none_for_the_minimum():
    cam, start, pairs, valid = _sim3_problem()
    keep = RL.sim3_refine(cam, start, pairs, valid)[3]
    x, (c_in, c_out, c_ref) = RL.sim3_excess(cam, start, start, pairs, keep)
    assert x == pytest.approx(1.0) and c_in > 2 * c_ref
    best, _ = RL.sim3_minimize(cam, start, _f64(pairs), keep.to(F64), 10.0)
    assert RL.sim3_excess(cam, start, best, pairs, keep)[0] < 1e-9
    half = RL.sim3_mul(*best, *RL.sim3_exp(0.5 * RL.sim3_log(
        *RL.sim3_mul(*RL.sim3_inverse(*best), *start))))
    assert 0.05 < RL.sim3_excess(cam, start, half, pairs, keep)[0] < 0.9


def _f64(xs):
    return [x.to(F64) for x in xs]


def _graph(K=8, seed=0):
    """A ring of K Sim3 vertices with odometry and loop edges measured with
    noise; vertex 0 fixed; the start is the chained odometry."""
    g = torch.Generator().manual_seed(seed)
    xi = torch.randn(K, 7, generator=g, dtype=F64) * 0.3
    V = RL.sim3_exp(xi)
    i = torch.arange(K)
    j = (i + 1) % K
    Rm, tm, sm = RL.sim3_mul(V[0][j], V[1][j], V[2][j], *RL.sim3_inverse(V[0][i], V[1][i], V[2][i]))
    Rm, tm, sm = RL.sim3_mul(*RL.sim3_exp(torch.randn(K, 7, generator=g, dtype=F64) * 0.02),
                             Rm, tm, sm)
    edges = {"i": i, "j": j, "R": Rm, "t": tm, "s": sm, "w": torch.ones(K, dtype=F64),
             "valid": torch.ones(K, dtype=torch.bool)}
    R, t, s = [x.clone() for x in V]
    for k in range(1, K):   # chain the measured odometry from vertex 0
        R[k], t[k], s[k] = RL.sim3_mul(Rm[k - 1], tm[k - 1], sm[k - 1],
                                       R[k - 1], t[k - 1], s[k - 1])
    fixed = torch.zeros(K, dtype=torch.bool)
    fixed[0] = True
    return (R, t, s), edges, fixed


def test_pg_excess_reads_one_for_the_start_and_none_for_the_minimum():
    V0, edges, fixed = _graph()
    x, (c_in, _, c_ref) = RL.pg_excess(V0, V0, edges, fixed)
    assert x == pytest.approx(1.0) and c_in > 10 * c_ref
    e = {k: edges[k] for k in ("i", "j", "R", "t", "s", "w")}
    best, _ = RL.pg_minimize(V0, e, fixed)
    assert RL.pg_excess(V0, best, edges, fixed)[0] < 1e-9
    assert torch.equal(best[0][0], V0[0][0]) and torch.equal(best[1][0], V0[1][0])


def test_gba_with_points_eliminated_lands_where_the_dense_ba_lands():
    cam, prob = _ba_problem()
    e = RB.edges(prob["kf_idx"], prob["pt_idx"], prob["uv"], prob["inv_sigma2"],
                 prob["valid"], prob["z_meas"], prob["wz"])
    (R0, t0, P0), keep0 = RB.bundle_adjust(cam, e, prob["poses_R"], prob["poses_t"],
                                           prob["points"], prob["fixed"])
    (R1, t1, P1), keep1 = RL.gba_minimize(cam, e, prob["poses_R"], prob["poses_t"],
                                          prob["points"], prob["fixed"],
                                          rounds=((5, True), (10, True)))
    assert torch.equal(keep0, keep1)
    assert torch.allclose(R0, R1, atol=1e-9) and torch.allclose(t0, t1, atol=1e-9)
    assert torch.allclose(P0, P1, atol=1e-9)


def test_gba_excess_reads_one_for_the_start():
    cam, prob = _ba_problem()
    p = {"kf_R": prob["poses_R"], "kf_t": prob["poses_t"], "points": prob["points"],
         "fixed": prob["fixed"], "kf": prob["kf_idx"], "pt": prob["pt_idx"], "uv": prob["uv"],
         "s2": prob["inv_sigma2"]}
    mono = dict(prob, wz=torch.zeros_like(prob["wz"]))
    e = RB.edges(mono["kf_idx"], mono["pt_idx"], mono["uv"], mono["inv_sigma2"], mono["valid"],
                 mono["z_meas"], mono["wz"])
    x, (c_in, _, c_ref) = RL.gba_excess(cam, p, p["kf_R"], p["kf_t"], p["points"])
    assert x == pytest.approx(1.0) and c_in > 3 * c_ref
    (R, t, P), _ = RL.gba_minimize(cam, e, p["kf_R"], p["kf_t"], p["points"], p["fixed"])
    assert RL.gba_excess(cam, p, R, t, P)[0] < 1e-9


@pytest.mark.parametrize("c_in, c_out, c_ref, floor_abs, read", [
    (10.0, 10.0, 8.0, 1e-12, 1.0),              # left where it started
    (1000.0, 101.0, 100.0, 1e-12, 1.0 / 900.0),  # solved to rounding
    (50.0, 40.0, 45.0, 1e-12, 0.0),             # better than the reference: no credit
    (100.0, 100.0 - 5e-6, 100.0 - 1e-5, 1e-12, 5e-6 / 0.1),   # 1e-3 of C_in is the least
    (5.3e-9, 5.3e-9, 1.1e-9, RL.PG_FLOOR, 1.0),       # a closed loop's graph left unwritten
    (5.3e-9, 1.1e-9 + 2e-12, 1.1e-9, RL.PG_FLOOR, 2e-12 / 4.2e-9),
    (8e-11, 2.25e-11 + 2.4e-12, 2.25e-11, RL.PG_FLOOR, 2.4e-12 / 3e-10),  # rounding under the floor
    (8e-11, 8e-11, 2.25e-11, RL.PG_FLOOR, 5.75e-11 / 3e-10),  # the same left unwritten
])
def test_share_reads_each_problem_by_what_it_had_to_reduce(c_in, c_out, c_ref, floor_abs, read):
    assert RL.share(c_in, c_out, c_ref, floor_abs=floor_abs) == pytest.approx(read, rel=1e-6)
