"""Two-view reconstruction (monocular map initialization) on torch tensors.

Counterpart of hfnet_slam_tpu/geometry/twoview.py: parallel H and F RANSAC
over a hypothesis batch, model selection, motion recovery and triangulation,
all in normalized image coordinates.

The reference draws the RANSAC samples inside the jitted function with
jax.random.categorical. Here the core takes the (n_hyp, 8) sample indices as
an argument: `draw_samples` makes them from a torch.Generator at run time,
and a parity test can pass the reference's own draws.
"""
from __future__ import annotations

import torch

from .triangulation import cheirality_and_error, triangulate_dlt

TH_F = 3.841
TH_H = 5.991
TH_SCORE = 5.991


def draw_samples(mask, n_hyp: int, generator: torch.Generator):
    """(n_hyp, 8) indices drawn uniformly with replacement among the valid
    matches (the reference's categorical over a 0/-inf logit mask)."""
    valid = torch.nonzero(mask.cpu(), as_tuple=False)[:, 0]
    pick = torch.randint(0, max(len(valid), 1), (n_hyp, 8), generator=generator)
    return valid[pick].to(mask.device)


def _normalize_pts(x, mask):
    """Hartley normalization over valid points: zero mean, unit mean abs dev.
    x (...,N,2), mask (...,N)."""
    m = mask[..., None].to(x.dtype)
    n = torch.clamp(torch.sum(m, -2), min=1.0)
    mean = torch.sum(x * m, -2, keepdim=True) / n[..., None, :]
    mean_dev = torch.sum(torch.abs(x - mean) * m, -2) / n
    s = 1.0 / torch.clamp(mean_dev, min=1e-8)
    return (x - mean) * s[..., None, :], mean[..., 0, :], s


def _T(s, c):
    """(...,3,3) normalizing transforms from scale s (...,2) and centroid c."""
    z = torch.zeros_like(s[..., 0])
    o = torch.ones_like(z)
    return torch.stack([
        torch.stack([s[..., 0], z, -s[..., 0] * c[..., 0]], -1),
        torch.stack([z, s[..., 1], -s[..., 1] * c[..., 1]], -1),
        torch.stack([z, z, o], -1),
    ], -2)


def _null_vec(A):
    """Right singular vector of the smallest singular value, (...,9)."""
    # full V only when A has fewer rows than columns (the 8-point samples):
    # the refit systems have N >> 9 rows and need no N x N U
    _, _, Vh = torch.linalg.svd(A, full_matrices=A.shape[-2] < A.shape[-1])
    return Vh[..., -1, :]


def _eight_point_F(p1, p2, mask):
    """Normalized 8-point F, rank 2 enforced. p (...,N,2), mask (...,N)."""
    p1n, c1, s1 = _normalize_pts(p1, mask)
    p2n, c2, s2 = _normalize_pts(p2, mask)
    x1, y1 = p1n[..., 0], p1n[..., 1]
    x2, y2 = p2n[..., 0], p2n[..., 1]
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                     torch.ones_like(x1)], -1) * mask[..., None].to(p1.dtype)
    F = _null_vec(A).reshape(A.shape[:-2] + (3, 3))
    U, S, Vh = torch.linalg.svd(F)
    S = torch.stack([S[..., 0], S[..., 1], torch.zeros_like(S[..., 2])], -1)
    F = (U * S[..., None, :]) @ Vh
    return _T(s2, c2).transpose(-1, -2) @ F @ _T(s1, c1)


def _dlt_H(p1, p2, mask):
    """DLT homography from N >= 4 correspondences. p (...,N,2), mask (...,N)."""
    p1n, c1, s1 = _normalize_pts(p1, mask)
    p2n, c2, s2 = _normalize_pts(p2, mask)
    x1, y1 = p1n[..., 0], p1n[..., 1]
    x2, y2 = p2n[..., 0], p2n[..., 1]
    z = torch.zeros_like(x1)
    o = torch.ones_like(x1)
    r1 = torch.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], -1)
    r2 = torch.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], -1)
    m = torch.cat([mask, mask], -1)[..., None].to(p1.dtype)
    A = torch.cat([r1, r2], -2) * m
    Hn = _null_vec(A).reshape(A.shape[:-2] + (3, 3))
    return torch.linalg.inv(_T(s2, c2)) @ Hn @ _T(s1, c1)


def _homog(x):
    return torch.cat([x, torch.ones_like(x[..., :1])], -1)


def _score_F(F, x1, x2, mask, sigma2):
    """Symmetric epipolar score (CheckFundamental). F (...,3,3) against all
    matches x (N,2). Returns (score (...,), inlier (...,N))."""
    p1, p2 = _homog(x1), _homog(x2)
    l2 = p1 @ F.transpose(-1, -2)  # epilines in image 2
    l1 = p2 @ F
    d2 = torch.sum(p2 * l2, -1) ** 2 / torch.clamp(l2[..., 0] ** 2 + l2[..., 1] ** 2, min=1e-12)
    d1 = torch.sum(p1 * l1, -1) ** 2 / torch.clamp(l1[..., 0] ** 2 + l1[..., 1] ** 2, min=1e-12)
    c1, c2 = d1 / sigma2, d2 / sigma2
    in1, in2 = c1 < TH_F, c2 < TH_F
    score = torch.where(in1, TH_SCORE - c1, 0.0) + torch.where(in2, TH_SCORE - c2, 0.0)
    return torch.sum(score * mask, -1), in1 & in2 & mask


def _score_H(H, x1, x2, mask, sigma2):
    Hinv = torch.linalg.inv(H)
    p1, p2 = _homog(x1), _homog(x2)

    def dehom(q):
        w = q[..., 2:]
        return q[..., :2] / torch.where(torch.abs(w) < 1e-12, 1e-12, w)

    q2 = dehom(p1 @ H.transpose(-1, -2))
    q1 = dehom(p2 @ Hinv.transpose(-1, -2))
    d2 = torch.sum((q2 - x2) ** 2, -1) / sigma2
    d1 = torch.sum((q1 - x1) ** 2, -1) / sigma2
    in1, in2 = d1 < TH_H, d2 < TH_H
    score = torch.where(in1, TH_SCORE - d1, 0.0) + torch.where(in2, TH_SCORE - d2, 0.0)
    return torch.sum(score * mask, -1), in1 & in2 & mask


def _decompose_E(E):
    """E -> 4 motion hypotheses (R (4,3,3), t (4,3) unit norm)."""
    U, _, Vh = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))
    Vh = Vh * torch.sign(torch.linalg.det(Vh))
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vh
    R2 = U @ W.T @ Vh
    t = U[:, 2]
    t = t / torch.clamp(torch.linalg.norm(t), min=1e-12)
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def _decompose_H(H):
    """Faugeras SVD decomposition -> 8 motion hypotheses (R (8,3,3), t (8,3))."""
    U, S, Vh = torch.linalg.svd(H)
    s = torch.linalg.det(U) * torch.linalg.det(Vh)
    d1, d2, d3 = S[0], S[1], S[2]
    eps = 1e-8
    den13 = torch.clamp(d1 * d1 - d3 * d3, min=eps)
    aux1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / den13, min=0.0))
    aux3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / den13, min=0.0))
    x1s = torch.stack([aux1, aux1, -aux1, -aux1])
    x3s = torch.stack([aux3, -aux3, aux3, -aux3])
    root = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0.0))
    aux_st = root / torch.clamp((d1 + d3) * d2, min=eps)
    ct = (d2 * d2 + d1 * d3) / torch.clamp((d1 + d3) * d2, min=eps)
    aux_sp = root / torch.clamp((d1 - d3) * d2, min=eps)
    cp = (d1 * d3 - d2 * d2) / torch.clamp((d1 - d3) * d2, min=eps)
    signs = torch.tensor([1.0, -1.0, -1.0, 1.0], dtype=H.dtype, device=H.device)
    zero = torch.zeros_like(d1)
    one = torch.ones_like(d1)

    def unit(t):
        return t / torch.clamp(torch.linalg.norm(t), min=1e-12)

    Rs, ts = [], []
    for i in range(4):  # case d' > 0
        st = aux_st * signs[i]
        Rp = torch.stack([torch.stack([ct, zero, -st]), torch.stack([zero, one, zero]),
                          torch.stack([st, zero, ct])])
        tp = (d1 - d3) * torch.stack([x1s[i], zero, -x3s[i]])
        Rs.append(s * U @ Rp @ Vh)
        ts.append(unit(U @ tp))
    for i in range(4):  # case d' < 0
        sp = aux_sp * signs[i]
        Rp = torch.stack([torch.stack([cp, zero, sp]), torch.stack([zero, -one, zero]),
                          torch.stack([sp, zero, -cp])])
        tp = (d1 + d3) * torch.stack([x1s[i], zero, x3s[i]])
        Rs.append(s * U @ Rp @ Vh)
        ts.append(unit(U @ tp))
    return torch.stack(Rs), torch.stack(ts)


def _check_motion(R21, t21, x1, x2, mask, th2):
    """Triangulate all matches under one motion and score it.
    Returns (n_good, parallax_deg, points, good, median parallax deg)."""
    p1 = triangulate_dlt(x1, x2, R21, t21)
    good, cosp = cheirality_and_error(p1, x1, x2, R21, t21, th2)
    good = good & mask
    n_good = torch.sum(good)
    cos_masked = torch.where(good, cosp, 1.0)
    sorted_cos, _ = torch.sort(cos_masked)
    last = cos_masked.shape[0] - 1
    k = torch.clamp(torch.clamp(n_good, max=50) - 1, 0, last)
    parallax = torch.rad2deg(torch.arccos(torch.clamp(sorted_cos[k], -1.0, 1.0)))
    med = torch.rad2deg(torch.arccos(torch.clamp(
        sorted_cos[torch.clamp(n_good // 2, 0, last)], -1.0, 1.0)))
    return n_good, parallax, p1, good, med


def _eval_family(Rs, ts, x1, x2, inl, th2, min_parallax_deg):
    res = [_check_motion(Rs[i], ts[i], x1, x2, inl, th2) for i in range(Rs.shape[0])]
    n_goods = torch.stack([r[0] for r in res])
    best = torch.argmax(n_goods)
    n_best = n_goods[best]
    n_second = torch.max(torch.where(
        torch.arange(len(res), device=n_goods.device) == best, -1, n_goods))
    n_min = torch.clamp(0.5 * torch.sum(inl), min=50.0)
    parallax = torch.stack([r[1] for r in res])[best]
    ok = (n_best > n_min) & (n_second < 0.75 * n_best) & (parallax > min_parallax_deg)
    p3d = torch.stack([r[2] for r in res])[best]
    good = torch.stack([r[3] for r in res])[best]
    med = torch.stack([r[4] for r in res])[best]
    return ok, Rs[best], ts[best], p3d, good, n_best, parallax, med


def reconstruct_two_views(x1, x2, mask, sample_idx, sigma_n, min_parallax_deg=1.0):
    """Full two-view reconstruction from matched normalized coords.

    x1, x2: (N,2); mask: (N,) bool; sample_idx: (n_hyp, 8) int64 RANSAC
    samples (see draw_samples); sigma_n: 1-pixel noise in normalized units.
    Returns the reference's dict: ok, R21, t21, points (N,3) in cam-1 frame,
    good (N,), n_good, used_H, parallax_deg, med_parallax_deg, score_F,
    score_H. Nothing here reads a tensor back to the host.
    """
    sigma2 = float(sigma_n) ** 2
    s1, s2 = x1[sample_idx], x2[sample_idx]  # (n_hyp, 8, 2)
    smask = torch.ones(s1.shape[:-1], dtype=torch.bool, device=x1.device)
    Fs = _eight_point_F(s1, s2, smask)
    Hs = _dlt_H(s1, s2, smask)
    scores_F, inliers_F = _score_F(Fs, x1, x2, mask, sigma2)
    scores_H, inliers_H = _score_H(Hs, x1, x2, mask, sigma2)
    bF = torch.argmax(scores_F)
    bH = torch.argmax(scores_H)
    SF, SH = scores_F[bF], scores_H[bH]
    use_H = SH / torch.clamp(SH + SF, min=1e-12) > 0.5

    # refit on the consensus set (gold-standard step)
    F_best = _eight_point_F(x1, x2, inliers_F[bF])
    H_best = _dlt_H(x1, x2, inliers_H[bH])
    _, inl_F = _score_F(F_best, x1, x2, mask, sigma2)
    _, inl_H = _score_H(H_best, x1, x2, mask, sigma2)

    # in normalized coords F is E; enforce the essential constraint
    U, _, Vh = torch.linalg.svd(F_best)
    E = (U * torch.tensor([1.0, 1.0, 0.0], dtype=U.dtype, device=U.device)) @ Vh
    R_E, t_E = _decompose_E(E)
    R_H, t_H = _decompose_H(H_best)
    th2 = 4.0 * sigma2
    res_E = _eval_family(R_E, t_E, x1, x2, inl_F, th2, min_parallax_deg)
    res_H = _eval_family(R_H, t_H, x1, x2, inl_H, th2, min_parallax_deg)

    # prefer the score-selected model; fall back to the other if only it passes
    ok_E, ok_H = res_E[0], res_H[0]
    pick_H = torch.where(use_H, ok_H | ~ok_E, ok_H & ~ok_E)

    def pick(i):
        return torch.where(pick_H, res_H[i], res_E[i])

    ok = torch.where(pick_H, ok_H, ok_E)
    return {
        "ok": ok, "R21": pick(1), "t21": pick(2), "points": pick(3),
        "good": pick(4) & ok, "n_good": pick(5), "used_H": pick_H,
        "parallax_deg": pick(6), "med_parallax_deg": pick(7),
        "score_F": SF, "score_H": SH,
    }

