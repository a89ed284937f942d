"""Plain loop-correction solvers in float64: the costs and minimizers of
ORB-SLAM3's OptimizeSim3 (Sim3 between the loop's keyframes), essential
graph (OptimizeEssentialGraph, a Sim3 pose graph) and global BA
(GlobalBundleAdjustemnt), the share of a problem's reducible cost that a
solution left, and, beside them, the port's Sim3 refinement written plainly.

Written from the published definitions: Sim(3) = (R, t, s) acting as
x -> s R x + t, its exponential and logarithm as in Sophus (rho, phi,
sigma), with rho = W^-1 t; the Sim3 cost is the bidirectional Huber
reprojection cost (g2o's EdgeSim3ProjectXYZ and its inverse edge, Huber
delta^2 = chi2_th); the pose graph's edge residual is log(S_ji S_i S_j^-1)
of the measured relative Sim3 S_ji with identity information; global BA is
reference/ba.py's edge and cost, solved by Levenberg-Marquardt with the
points eliminated (Schur complement), so a whole map fits. Each minimizer
runs to convergence from the problem's own start, with Jacobians by central
differences (Sim3, pose graph) or the edge's closed form (BA).
sim3_refine follows the port's optim/sim3.optimize_sim3 (commit 0d99d19):
undamped Gauss-Newton steps, each kept only where it lowers its robust
cost, so it is a diagnostic of that algorithm, not a minimizer (PERF.md).
It imports no module of the program.
"""
from __future__ import annotations

import torch

from . import ba as RB
from .tracking import hat, huber_weight, project

F64 = torch.float64


# ---- SO(3) / Sim(3) ------------------------------------------------------------

def so3_exp(phi):
    th2 = torch.sum(phi * phi, -1)
    th = torch.sqrt(th2)
    small = th2 < 1e-12
    ths = torch.where(small, torch.ones_like(th), th)
    A = torch.where(small, 1.0 - th2 / 6.0, torch.sin(ths) / ths)
    B = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(ths)) / (ths * ths))
    K = hat(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(K.shape)
    return eye + A[..., None, None] * K + B[..., None, None] * (K @ K)


def so3_log(R):
    """Rotation angle from atan2(|v|, cos) with v = vee(R - R^T) / 2; near pi
    the axis comes from the symmetric part."""
    v = 0.5 * torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                           R[..., 1, 0] - R[..., 0, 1]], -1)
    c = torch.clamp(0.5 * (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0), -1.0, 1.0)
    sn = torch.linalg.norm(v, dim=-1)
    th = torch.atan2(sn, c)
    small = th < 1e-6
    f = torch.where(small, 1.0 + th * th / 6.0, th / torch.where(small, torch.ones_like(sn), sn))
    phi = f[..., None] * v
    # near pi: a a^T = ((R + R^T) / 2 - cos I) / (1 - cos), the largest column
    S = 0.5 * (R + R.transpose(-1, -2)) - c[..., None, None] * torch.eye(3, dtype=R.dtype,
                                                                          device=R.device)
    S = S / torch.clamp(1.0 - c, min=1e-12)[..., None, None]
    j = torch.argmax(torch.diagonal(S, dim1=-2, dim2=-1), -1)
    col = torch.gather(S, -1, j[..., None, None].expand(S.shape[:-1] + (1,)))[..., 0]
    axis = col / torch.clamp(torch.linalg.norm(col, dim=-1, keepdim=True), min=1e-300)
    axis = axis * torch.where(torch.sum(axis * v, -1, keepdim=True) < 0, -1.0, 1.0)
    near_pi = c < -0.99
    return torch.where(near_pi[..., None], th[..., None] * axis, phi)


def sim3_W(phi, sigma):
    """W of the Sim(3) exponential, t = W rho: C I + A hat(phi) + B hat(phi)^2
    (Sophus calcW), with the series where theta or sigma is near 0."""
    th2 = torch.sum(phi * phi, -1)
    th = torch.sqrt(th2)
    s = torch.exp(sigma)
    small_s = torch.abs(sigma) < 1e-5
    small_t = th2 < 1e-8
    sg = torch.where(small_s, torch.ones_like(sigma), sigma)
    ths = torch.where(small_t, torch.ones_like(th), th)
    C = torch.where(small_s, 1.0 + sigma / 2.0 + sigma * sigma / 6.0, (s - 1.0) / sg)
    a, b = s * torch.sin(ths), s * torch.cos(ths)
    c = ths * ths + sigma * sigma
    A = torch.where(small_t,
                    torch.where(small_s, 0.5 + sigma / 3.0, ((sigma - 1.0) * s + 1.0) / (sg * sg)),
                    (a * sigma + (1.0 - b) * ths) / (ths * c))
    B = torch.where(small_t,
                    torch.where(small_s, 1.0 / 6.0 + sigma / 8.0,
                                (s * (sigma * sigma / 2.0 - sigma + 1.0) - 1.0) / sg ** 3),
                    (C - ((b - 1.0) * sigma + a * ths) / c) / (ths * ths))
    K = hat(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(K.shape)
    return C[..., None, None] * eye + A[..., None, None] * K + B[..., None, None] * (K @ K)


def sim3_exp(xi):
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    return so3_exp(phi), (sim3_W(phi, sigma) @ rho[..., None])[..., 0], torch.exp(sigma)


def sim3_log(R, t, s):
    phi = so3_log(R)
    sigma = torch.log(s)
    rho = torch.linalg.solve(sim3_W(phi, sigma), t[..., None])[..., 0]
    return torch.cat([rho, phi, sigma[..., None]], -1)


def sim3_mul(R1, t1, s1, R2, t2, s2):
    return R1 @ R2, s1[..., None] * (R1 @ t2[..., None])[..., 0] + t1, s1 * s2


def sim3_inverse(R, t, s):
    Rt = R.transpose(-1, -2)
    return Rt, -(Rt @ t[..., None])[..., 0] / s[..., None], 1.0 / s


def share(c_in, c_out, c_ref, floor=1e-3, floor_abs=1e-12):
    """Share of a problem's reducible cost that a solution left:
    (C_out - C_ref) / (C_in - C_ref), with C_in the cost at the problem's
    own state, C_out at the program's solution and C_ref at the reference's
    (taken no higher than C_in): 0 where the program did at least as well,
    1 for a solve that returned its input. A problem with less than `floor`
    of its cost, or less than `floor_abs`, to reduce divides by that
    instead, so that its rounding reads near 0 (reference/ba.excess's
    rule)."""
    c_ref = min(c_ref, c_in)
    return max(c_out - c_ref, 0.0) / max(c_in - c_ref, floor * c_in, floor_abs)


def _f64(*xs):
    return [torch.as_tensor(x).to(F64) for x in xs]


def _lm(cost, step, state, iters=200, tol=1e-15):
    """Levenberg-Marquardt on a retraction: `cost(state)` is a float,
    `step(state, lam)` the state after the Gauss-Newton step damped by
    `lam` (None where it is not finite). Runs until two steps in a row
    improve the cost by at most `tol` of it, or the damping grows past 1e12.
    Returns (state, cost)."""
    c = cost(state)
    lam, small = 1e-6, 0
    for _ in range(iters):
        nxt = step(state, lam)
        if nxt is None:
            lam *= 10.0
        else:
            cn = cost(nxt)
            if cn < c:
                small = small + 1 if c - cn <= tol * c else 0
                state, c, lam = nxt, cn, max(lam * 0.1, 1e-12)
                if small >= 2:
                    break
            else:
                lam *= 10.0
        if lam > 1e12:
            break
    return state, c


# ---- OptimizeSim3 --------------------------------------------------------------

def sim3_residuals(cam, R, t, s, p1, p2, u1, u2):
    """(e1, e2, z1, z2): frame 2's points through S12 = (R, t, s) into frame 1
    against frame 1's pixels, and frame 1's through S12^-1 against frame 2's
    (S12 may carry leading batch dimensions), with the depths they land at."""
    p2_in1 = s[..., None, None] * (p2 @ R.transpose(-1, -2)) + t[..., None, :]
    Ri, ti, si = sim3_inverse(R, t, s)
    p1_in2 = si[..., None, None] * (p1 @ Ri.transpose(-1, -2)) + ti[..., None, :]
    return (project(cam, p2_in1) - u1, project(cam, p1_in2) - u2, p2_in1[..., 2],
            p1_in2[..., 2])


def huber(c, delta2):
    """g2o's Huber on a squared error c: c inside delta^2, 2 sqrt(delta^2 c) -
    delta^2 beyond."""
    return torch.where(c <= delta2, c, 2.0 * torch.sqrt(delta2 * torch.clamp(c, min=0.0)) - delta2)


def sim3_cost(cam, S, pb, keep, chi2_th):
    """Bidirectional Huber reprojection cost of S12 over the pairs in `keep`."""
    e1, e2 = sim3_residuals(cam, *S, *pb[:4])[:2]
    c1 = torch.sum(e1 * e1, -1) * pb[4]
    c2 = torch.sum(e2 * e2, -1) * pb[5]
    return float(torch.sum((huber(c1, chi2_th) + huber(c2, chi2_th)) * keep))


def sim3_minimize(cam, S0, pb, keep, chi2_th, fix_scale=False, h=1e-7):
    """OptimizeSim3's cost minimized from S0 by LM on S exp(xi)."""
    dim = 6 if fix_scale else 7

    def retract(S, xi):
        x = torch.zeros(xi.shape[:-1] + (7,), dtype=F64, device=xi.device)
        x[..., :dim] = xi
        return sim3_mul(*S, *sim3_exp(x))

    def rvec(S):
        e1, e2 = sim3_residuals(cam, *S, *pb[:4])[:2]
        return torch.cat([e1, e2], -2), torch.cat([torch.sum(e1 * e1, -1) * pb[4],
                                                   torch.sum(e2 * e2, -1) * pb[5]], -1)

    def step(S, lam):
        r, c = rvec(S)
        d = h * torch.cat([torch.eye(dim, dtype=F64), -torch.eye(dim, dtype=F64)])
        rp = rvec(retract(S, d.to(r.device)))[0]                    # (2 dim, 2N, 2)
        J = ((rp[:dim] - rp[dim:]) / (2 * h)).permute(1, 2, 0)      # (2N, 2, dim)
        w = (torch.cat([pb[4], pb[5]]) * huber_weight(c, chi2_th)
             * torch.cat([keep, keep]))[:, None, None]
        H = torch.einsum("nai,naj->ij", J * w, J)
        g = torch.einsum("nai,na->i", J * w, r)
        dx = torch.linalg.solve(H + torch.diag(lam * torch.diagonal(H) + 1e-12), -g)
        return retract(S, dx) if bool(torch.isfinite(dx).all()) else None

    return _lm(lambda S: sim3_cost(cam, S, pb, keep, chi2_th), step, S0)


def sim3_excess(cam, S_in, S_out, pairs, keep, chi2_th=10.0, fix_scale=False):
    """Share of an OptimizeSim3 call's reducible cost that S_out left, on the
    pairs in `keep` (the program's final inliers): (share, (C_in, C_out,
    C_ref)). pairs: P1, P2 (N,3) camera-frame points, U1, U2 (N,2) pixels,
    IS1, IS2 (N,) inverse variances."""
    pb = _f64(*pairs)
    keep = torch.as_tensor(keep).to(F64)
    S_in, S_out = _f64(*S_in), _f64(*S_out)
    c_in = sim3_cost(cam, S_in, pb, keep, chi2_th)
    c_out = sim3_cost(cam, S_out, pb, keep, chi2_th)
    _, c_ref = sim3_minimize(cam, S_in, pb, keep, chi2_th, fix_scale)
    return share(c_in, c_out, c_ref), (c_in, c_out, min(c_ref, c_in))


def sim3_refine(cam, S0, pairs, valid, chi2_th=10.0, n_iters=20, fix_scale=False, h=1e-7):
    """The port's Sim3 refinement written plainly, in float64: `n_iters` Gauss-Newton steps on S exp(xi) over the pairs in
    `valid` (bidirectional reprojection, Huber weights of threshold
    chi2_th, points behind a camera weighted 0, the normal matrix damped by
    1e-6), each kept only where it lowers sum min(c, th + sqrt(th (c - th)))
    over both directions, then the inlier sweep (both chi2 within the
    threshold, both depths positive). Returns (R, t, s, inliers). Jacobians
    by central differences; the program takes forward-mode ones."""
    p1, p2, u1, u2, is1, is2 = pairs
    inl = valid.to(F64)
    dim = 6 if fix_scale else 7
    eye = torch.eye(7, dtype=F64, device=p1.device)

    def at(S):
        e1, e2, z1, z2 = sim3_residuals(cam, *S, p1, p2, u1, u2)
        return e1, e2, z1, z2, torch.sum(e1 * e1, -1) * is1, torch.sum(e2 * e2, -1) * is2

    def rob(c):
        return torch.minimum(c, chi2_th + torch.sqrt(chi2_th * torch.clamp(c - chi2_th, min=0.0)))

    S = list(S0)
    d = h * torch.cat([eye, -eye])
    for _ in range(n_iters):
        e1, e2, z1, z2, c1, c2 = at(S)
        ep1, ep2 = at(sim3_mul(*S, *sim3_exp(d)))[:2]
        rp = torch.cat([ep1.reshape(14, -1), ep2.reshape(14, -1)], -1)   # (14, 4N)
        J = ((rp[:7] - rp[7:]) / (2 * h)).T                                 # (4N, 7)
        w1 = inl * is1 * huber_weight(c1, chi2_th) * (z1 > 0)
        w2 = inl * is2 * huber_weight(c2, chi2_th) * (z2 > 0)
        w = torch.cat([torch.repeat_interleave(w1, 2), torch.repeat_interleave(w2, 2)])
        r = torch.cat([e1.reshape(-1), e2.reshape(-1)])
        H = torch.einsum("ni,n,nj->ij", J, w, J)
        b = torch.einsum("ni,n->i", J, w * r)
        if dim == 6:
            H[6, :], H[:, 6], H[6, 6], b[6] = 0.0, 0.0, 1.0, 0.0
        dx = -torch.linalg.solve(H + 1e-6 * eye, b)
        S_n = sim3_mul(*S, *sim3_exp(dx))
        c1n, c2n = at(S_n)[4:]
        dcost = torch.sum((rob(c1n) - rob(c1)) * inl) + torch.sum((rob(c2n) - rob(c2)) * inl)
        if bool(dcost < 0) and bool(torch.isfinite(dx).all()):
            S = list(S_n)
    e1, e2, z1, z2, c1, c2 = at(S)
    return S[0], S[1], S[2], valid & (c1 <= chi2_th) & (c2 <= chi2_th) & (z1 > 0) & (z2 > 0)


# ---- the essential graph -------------------------------------------------------

def pg_residuals(R, t, s, e):
    """(E,7) edge residuals log(S_ji S_i S_j^-1) of vertex Sim3s (world to
    camera) against the measured edges e (i, j, and S_ji as R, t, s)."""
    i, j = e["i"], e["j"]
    Ra = sim3_mul(e["R"], e["t"], e["s"], R[i], t[i], s[i])
    return sim3_log(*sim3_mul(*Ra, *sim3_inverse(R[j], t[j], s[j])))


def pg_cost(V, e):
    r = pg_residuals(*V, e)
    return float(torch.sum(r * r * e["w"][:, None]))


def pg_minimize(V0, e, fixed, h=1e-6):
    """The essential graph's cost minimized over the free vertices by LM on
    exp(xi) S."""
    K = V0[0].shape[0]
    free = torch.nonzero(~fixed).flatten()
    nf = len(free)
    loc = torch.full((K,), -1, dtype=torch.long, device=free.device)
    loc[free] = torch.arange(nf, device=free.device)
    i, j = e["i"], e["j"]

    def retract(V, xi):
        R, t, s = V
        d = torch.zeros((K, 7), dtype=F64, device=R.device)
        d[free] = xi
        return sim3_mul(*sim3_exp(d), R, t, s)

    def edge_res(Vi, Vj):
        Ra = sim3_mul(e["R"], e["t"], e["s"], *Vi)
        return sim3_log(*sim3_mul(*Ra, *sim3_inverse(*Vj)))

    def step(V, lam):
        Vi = [x[i] for x in V]
        Vj = [x[j] for x in V]
        r = edge_res(Vi, Vj)
        d = h * torch.cat([torch.eye(7, dtype=F64), -torch.eye(7, dtype=F64)]).to(r.device)
        D = sim3_exp(d[:, None, :].expand(14, len(i), 7))             # (14, E, ...)
        ri = edge_res(sim3_mul(*D, *Vi), Vj)
        rj = edge_res(Vi, sim3_mul(*D, *Vj))
        Ji = ((ri[:7] - ri[7:]) / (2 * h)).permute(1, 2, 0)           # (E, 7, 7)
        Jj = ((rj[:7] - rj[7:]) / (2 * h)).permute(1, 2, 0)
        w = e["w"][:, None, None]
        H = torch.zeros((nf * nf, 7, 7), dtype=F64, device=r.device)
        g = torch.zeros((nf, 7), dtype=F64, device=r.device)
        li, lj = loc[i], loc[j]
        for la, Ja, lb, Jb in ((li, Ji, li, Ji), (li, Ji, lj, Jj), (lj, Jj, li, Ji),
                               (lj, Jj, lj, Jj)):
            ok = (la >= 0) & (lb >= 0)
            H.index_add_(0, (la * nf + lb)[ok], (Ja.transpose(1, 2) @ (w * Jb))[ok])
        for la, Ja in ((li, Ji), (lj, Jj)):
            ok = la >= 0
            g.index_add_(0, la[ok], (Ja.transpose(1, 2) @ (w * r[..., None]))[..., 0][ok])
        H = H.reshape(nf, nf, 7, 7).permute(0, 2, 1, 3).reshape(7 * nf, 7 * nf)
        dx = torch.linalg.solve(H + torch.diag(lam * torch.diagonal(H) + 1e-12),
                                -g.reshape(-1))
        return retract(V, dx.reshape(nf, 7)) if bool(torch.isfinite(dx).all()) else None

    return _lm(lambda V: pg_cost(V, e), step, V0)


PG_FLOOR = 3e-10   # reducible pose-graph cost below which a problem is rounding (PERF.md)


def pg_excess(V_in, V_out, edges, fixed):
    """Share of an essential-graph problem's reducible cost that the vertex
    state V_out = (R, t, s) left: (share, (C_in, C_out, C_ref)), dividing by
    no less than PG_FLOOR. edges: i, j (E,), R (E,3,3), t (E,3), s (E,) of
    the measured S_ji, w (E,) weights, valid (E,)."""
    v = torch.as_tensor(edges["valid"]).bool()
    e = {k: torch.as_tensor(edges[k])[v] for k in ("i", "j")}
    e.update({k: torch.as_tensor(edges[k])[v].to(F64) for k in ("R", "t", "s", "w")})
    V_in, V_out = _f64(*V_in), _f64(*V_out)
    c_in, c_out = pg_cost(V_in, e), pg_cost(V_out, e)
    _, c_ref = pg_minimize(V_in, e, torch.as_tensor(fixed).bool())
    return share(c_in, c_out, c_ref, floor_abs=PG_FLOOR), (c_in, c_out, min(c_ref, c_in))


# ---- global BA -----------------------------------------------------------------

def _chi2_cost(cam, e, R, t, P, valid, robust):
    _, _, depth, chi2, d2 = RB._terms(cam, e, R, t, P)
    c = torch.where(chi2 <= d2, chi2, 2.0 * torch.sqrt(d2 * chi2) - d2) if robust else chi2
    return torch.sum(c * (depth > 0) * valid)


def gba_minimize(cam, e, R, t, P, fixed, rounds=((10, True), (8, False))):
    """Global BA from (R, t, P): each round `n` LM iterations on the Huber
    (`robust`) or plain chi2 cost of the current inliers, then the edges past
    their chi2 threshold or behind their camera dropped, at reference/ba.py's
    damping and step bounds, with the points eliminated. Returns the state it
    ends at and the edges it keeps as inliers there."""
    R, t, P = R.to(F64), t.to(F64), P.to(F64)
    dev = R.device
    nk, npt = R.shape[0], P.shape[0]
    free = torch.nonzero(~fixed.bool()).flatten()
    nf = len(free)
    col = torch.full((nk,), -1, dtype=torch.long, device=dev)
    col[free] = torch.arange(nf, device=dev)
    ck = col[e["kf"]]
    fk = ck >= 0
    kf_f, pt_f = ck[fk], e["pt"][fk]
    ar = torch.arange(nf, device=dev)
    eye3 = torch.eye(3, dtype=F64, device=dev)
    eye6 = torch.eye(6, dtype=F64, device=dev)
    valid = torch.ones(len(ck), dtype=torch.bool, device=dev)
    for n_iters, robust in rounds:
        lam = RB.LAM0
        for _ in range(n_iters):
            r, J, depth, chi2, d2 = RB._terms(cam, e, R, t, P)
            wgt = e["s2"] * valid * (depth > 0)
            if robust:
                wgt = wgt * huber_weight(chi2, d2)
            w = wgt[:, None, None]
            Jc, Jp = J, J[..., :3] @ R[e["kf"]]
            JcW, JpW = (Jc * w).transpose(1, 2), (Jp * w).transpose(1, 2)
            Hpp = torch.zeros((npt, 3, 3), dtype=F64, device=dev).index_add_(0, e["pt"], JpW @ Jp)
            gp = torch.zeros((npt, 3), dtype=F64, device=dev).index_add_(
                0, e["pt"], (JpW @ r[..., None])[..., 0])
            Hcc = torch.zeros((nf, 6, 6), dtype=F64, device=dev).index_add_(
                0, kf_f, (JcW @ Jc)[fk])
            gc = torch.zeros((nf, 6), dtype=F64, device=dev).index_add_(
                0, kf_f, (JcW @ r[..., None])[..., 0][fk])
            Wcp = torch.zeros((npt * nf, 6, 3), dtype=F64, device=dev).index_add_(
                0, pt_f * nf + kf_f, (JcW @ Jp)[fk]).reshape(npt, nf, 6, 3)
            Hpp_d = Hpp + (lam * torch.diagonal(Hpp, dim1=-2, dim2=-1) + 1e-8)[..., None] * eye3
            Hcc_d = Hcc + (lam * torch.diagonal(Hcc, dim1=-2, dim2=-1) + 1e-8)[..., None] * eye6
            Hinv = torch.linalg.inv(Hpp_d)
            WH = torch.einsum("pkac,pcd->pkad", Wcp, Hinv)
            S = -torch.einsum("pkad,pled->kale", WH, Wcp)
            S[ar, :, ar, :] += Hcc_d
            rhs = -gc + torch.einsum("pkad,pd->ka", WH, gp)
            dc = torch.linalg.solve(S.reshape(6 * nf, 6 * nf), rhs.reshape(-1)).reshape(nf, 6)
            # the keyframe step bound, then the points' step from the bounded one
            big = torch.sqrt(torch.sum(dc * dc, -1)).max() if nf else torch.zeros((), dtype=F64)
            dc = dc * torch.clamp(RB.MAX_STEP / torch.clamp(big, min=1e-12), max=1.0)
            dp = (Hinv @ -(gp + torch.einsum("pkac,ka->pc", Wcp, dc))[..., None])[..., 0]
            pstep = torch.sqrt(torch.sum(dp * dp, -1))
            dp = dp * torch.clamp(RB.MAX_STEP / torch.clamp(pstep, min=1e-12), max=1.0)[:, None]
            R2, t2 = R.clone(), t.clone()
            R2[free], t2[free] = RB.se3_retract(R[free], t[free], dc)
            P2 = P + dp
            old = _chi2_cost(cam, e, R, t, P, valid, robust)
            new = _chi2_cost(cam, e, R2, t2, P2, valid, robust)
            finite = bool(torch.isfinite(dc).all()) and bool(torch.isfinite(dp).all())
            if bool(new < old) and finite:
                R, t, P, lam = R2, t2, P2, max(lam * 0.33, RB.LAM_MIN)
            else:
                lam = min(lam * 4.0, 1e4)
        valid = RB.inliers(cam, e, R, t, P)
    return (R, t, P), valid


def gba_excess(cam, prob, R_out, t_out, P_out, rounds=((10, True), (8, False))):
    """Share of a global BA problem's reducible cost that the program's
    solution left, over the edges this reference keeps as inliers:
    (share, (C_in, C_out, C_ref)), by reference/ba.py's Huber cost. prob:
    kf_R, kf_t (K,...), fixed (K,), points (M,3), and the edges kf, pt (E,)
    into them, uv (E,2), s2 (E,) inverse variances."""
    z = torch.zeros_like(prob["s2"], dtype=F64)
    e = {"kf": prob["kf"].long(), "pt": prob["pt"].long(), "uv": prob["uv"].to(F64),
         "s2": prob["s2"].to(F64), "z": z, "wz": z}
    R0, t0, P0 = _f64(prob["kf_R"], prob["kf_t"], prob["points"])
    (R1, t1, P1), keep = gba_minimize(cam, e, R0, t0, P0, prob["fixed"], rounds)
    c_in = RB.cost(cam, e, R0, t0, P0, keep)
    c_ref = RB.cost(cam, e, R1, t1, P1, keep)
    c_out = RB.cost(cam, e, *_f64(R_out, t_out, P_out), keep)
    return share(c_in, c_out, c_ref), (c_in, c_out, min(c_ref, c_in))
