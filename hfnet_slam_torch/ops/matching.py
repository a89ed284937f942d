"""Descriptor matching as similarity matmuls, on torch tensors.

Counterpart of hfnet_slam_tpu/ops/matching.py. Descriptors are L2-normalized,
so d^2 = 2 - 2<a, b> and the reference's TH_HIGH / TH_LOW distance gates
become similarity gates.

Tie rule: every argmax here is torch.argmax, which returns the FIRST maximal
index on both CPU and CUDA, as jnp.argmax does (tests/test_torch_matching.py
holds it on exact ties).
"""
from __future__ import annotations

import torch

TH_HIGH = 0.75
TH_LOW = 0.6

_NEG = -1e9


def similarity(dA, dB):
    """(NA,D) x (NB,D) -> (NA,NB) cosine similarity."""
    return dA @ dB.transpose(-1, -2)


def dist2_from_sim(s):
    return torch.clamp(2.0 - 2.0 * s, min=0.0)


def _top2(S):
    """Row-wise (best_idx, best, second): second is the row max with only
    the argmax column knocked out, so an exact tie gives second == best."""
    best_idx = torch.argmax(S, -1)
    best = torch.gather(S, -1, best_idx[..., None])[..., 0]
    S2 = S.scatter(-1, best_idx[..., None], _NEG)
    return best_idx, best, torch.max(S2, -1).values


def match_descriptors(dA, maskA, dB, maskB, max_dist: float = TH_LOW,
                      ratio: float = 1.0, mutual: bool = True, allowed=None):
    """Generic mutual matcher. Returns (idx (NA,) int32 into B or -1,
    dist (NA,) matched L2 distance, 0 where unmatched)."""
    S = similarity(dA, dB)
    gate = maskA[:, None] & maskB[None, :]
    if allowed is not None:
        gate = gate & allowed
    S = torch.where(gate, S, _NEG)
    idxB, bestA, secondA = _top2(S)
    ok = bestA > _NEG / 2
    d = torch.sqrt(dist2_from_sim(torch.clamp(bestA, -1.0, 1.0)))
    d2nd = torch.sqrt(dist2_from_sim(torch.clamp(secondA, -1.0, 1.0)))
    ok &= d < max_dist
    if ratio < 1.0:
        ok &= d < ratio * d2nd
    if mutual:
        idxA_of_B = torch.argmax(S, 0)
        ok &= idxA_of_B[idxB] == torch.arange(dA.shape[0], device=dA.device)
    idx = torch.where(ok & maskA, idxB, -1).to(torch.int32)
    return idx, torch.where(idx >= 0, d, 0.0)


def window_allowed(xyA, xyB, radius):
    """(NA,NB) bool: |xyA_i - xyB_j|_inf < radius."""
    return torch.all(torch.abs(xyA[:, None, :] - xyB[None, :, :]) < radius, -1)


def radius_allowed(xyA, xyB, radii_A):
    """Per-A-row circular windows: |xyA_i - xyB_j|_2 < radii_A[i]."""
    d2 = torch.sum((xyA[:, None, :] - xyB[None, :, :]) ** 2, -1)
    return d2 < radii_A[:, None] ** 2


def octave_allowed(octA, octB, tol: int = 1):
    """Scale-consistency gate: |octave difference| <= tol."""
    return torch.abs(octA[:, None] - octB[None, :]) <= tol


def global_scores(query, db, db_mask):
    """Place-recognition scores of `query` (G,) against a database (K,G):
    max(0, 1 - |g_q - g_i|) (KeyFrameDatabase.cc:85-96), 0 on invalid rows."""
    d2 = torch.clamp(2.0 - 2.0 * (db @ query), min=0.0)
    return torch.where(db_mask, torch.clamp(1.0 - torch.sqrt(d2), min=0.0), 0.0)


def global_scores_batch(queries, db, db_mask):
    """(Q,G) x (K,G) -> (Q,K) retrieval scores."""
    d = torch.sqrt(torch.clamp(2.0 - 2.0 * (queries @ db.T), min=0.0))
    return torch.where(db_mask[None, :], torch.clamp(1.0 - d, min=0.0), 0.0)


def distinctive_descriptors(descs, mask):
    """Per point, the observation whose median squared distance to the
    point's other observations is smallest (MapPoint::
    ComputeDistinctiveDescriptors). descs (P,O,D), mask (P,O) -> (P,D),
    zeros where a point has no valid observation."""
    sim = descs @ descs.transpose(-1, -2)
    d2 = torch.clamp(2.0 - 2.0 * sim, min=0.0)
    pair_ok = mask[:, :, None] & mask[:, None, :]
    d2 = torch.where(pair_ok, d2, 8.0)  # invalid entries sort to the end
    d2s, _ = torch.sort(d2, -1)
    med_idx = torch.clamp(mask.sum(1) // 2, 0, d2.shape[2] - 1)
    med = torch.gather(d2s, 2, med_idx[:, None, None].expand(d2s.shape[:2] + (1,)))[..., 0]
    med = torch.where(mask, med, torch.inf)
    best = torch.argmin(med, 1)
    out = torch.gather(descs, 1, best[:, None, None].expand(-1, 1, descs.shape[2]))[:, 0]
    return torch.where(mask.any(1)[:, None], out, 0.0)
