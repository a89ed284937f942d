"""Absolute trajectory error (ATE) evaluation.

The port's own copy of hfnet_slam_tpu/evaluation/ate.py (numpy only): the
ORB-SLAM evaluate_ate_scale protocol -- Horn alignment of estimated to
ground-truth positions, optional scale correction, RMSE of translational
differences.
"""
from __future__ import annotations

import numpy as np


def align_horn(est, gt, with_scale=False):
    """Horn's closed-form alignment est -> gt.

    Args:
      est, gt: (N,3) matched positions.
      with_scale: also estimate a similarity scale (the reference's
        scale-corrected variant).
    Returns (R (3,3), t (3,), s float) with  gt ~ s * R @ est + t.
    """
    est = np.asarray(est, dtype=np.float64)
    gt = np.asarray(gt, dtype=np.float64)
    mu_e = est.mean(axis=0)
    mu_g = gt.mean(axis=0)
    E = est - mu_e
    G = gt - mu_g
    W = G.T @ E
    U, _, Vt = np.linalg.svd(W)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        # Umeyama scale: trace(D S) / var(est)
        var_e = (E ** 2).sum() / len(est)
        D = np.diag(np.linalg.svd(W / len(est))[1])
        s = float(np.trace(D @ S) / var_e)
    else:
        s = 1.0
    t = mu_g - s * R @ mu_e
    return R, t, s


def ate_rmse(est, gt, with_scale=False):
    """Aligned RMSE in meters. est/gt: (N,3) time-associated positions."""
    R, t, s = align_horn(est, gt, with_scale)
    aligned = (s * (R @ np.asarray(est, np.float64).T)).T + t
    err = aligned - np.asarray(gt, np.float64)
    return float(np.sqrt((err ** 2).sum(axis=1).mean()))


def associate(t_est, t_gt, max_dt=0.02):
    """Greedy nearest-timestamp association (evaluation/associate.py
    semantics). Returns (idx_est, idx_gt)."""
    t_est = np.asarray(t_est)
    t_gt = np.asarray(t_gt)
    ie, ig = [], []
    j = 0
    for i, te in enumerate(t_est):
        j = int(np.argmin(np.abs(t_gt - te)))
        if abs(t_gt[j] - te) <= max_dt:
            ie.append(i)
            ig.append(j)
    return np.array(ie, int), np.array(ig, int)
