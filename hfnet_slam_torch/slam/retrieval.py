"""Place recognition over global descriptors.

Counterpart of hfnet_slam_tpu/slam/retrieval.py (the reference's
KeyFrameDatabase): score = max(0, 1 - |g_q - g_i|) against every keyframe
(:85-96) as one matrix-vector product on the caller's device
(ops/matching.global_scores), candidates above 0.8x the best (:190-191),
each candidate's score accumulated over its 10 best covisible keyframes with
the best of the group kept (:107-137), and the top-N groups
(DetectNBestCandidates) or the >0.75x-best-accumulated set for
relocalization (DetectRelocalizationCandidates). The group bookkeeping is
host numpy.

The reference's mesh-sharded scan (parallel/retrieval.py) is ROADMAP.md
Queue 1 item 17.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve
from ..ops import matching as M
from .map import MapStore


@dataclasses.dataclass
class RetrievalConfig:
    n_covisibles: int = 10
    min_score_ratio: float = 0.8
    reloc_floor: float = 0.5
    reloc_acc_ratio: float = 0.75


def score_all(store: MapStore, gdesc, device=None) -> np.ndarray:
    """(K,) retrieval scores of a query global descriptor (numpy) against
    every valid keyframe, computed on `device` (None means CUDA)."""
    device = resolve(device)

    def t(x):  # a copy: retrieval reads the store off the map lock
        return torch.tensor(np.asarray(x), device=device)

    sc = M.global_scores(t(np.asarray(gdesc, np.float32)), t(store.kf_gdesc),
                         t(store.kf_valid))
    return sc.cpu().numpy().copy()


def _group_accumulate(store: MapStore, scores, cand_ids, n_covisibles, score_floor=0.0):
    """Per candidate: (best-scoring member of its covisibility group, the
    group's accumulated score). Every covisible whose own score clears the
    floor counts, not only covisibles that are candidates themselves."""
    best_kf = np.empty(len(cand_ids), np.int64)
    acc = np.empty(len(cand_ids), np.float32)
    for n, c in enumerate(cand_ids):
        group = [int(c)] + [int(j) for j in store.covisible_kfs(int(c), n=n_covisibles,
                                                                 min_weight=1)]
        g_scores = [(scores[j], j) for j in group if scores[j] > score_floor or j == int(c)]
        acc[n] = sum(s for s, _ in g_scores)
        best_kf[n] = max(g_scores)[1]
    return best_kf, acc


def _ordered_unique(best_kf, order, keep=None, n=None):
    out, seen = [], set()
    for i in order:
        if keep is not None and not keep[i]:
            continue
        k = int(best_kf[i])
        if k not in seen:
            out.append(k)
            seen.add(k)
        if n is not None and len(out) >= n:
            break
    return out


def detect_n_best_candidates(store: MapStore, gdesc, exclude, n: int = 3,
                             cfg: RetrievalConfig = None, device=None):
    """Loop/merge candidates for a query descriptor; `exclude` is the query
    keyframe's covisible set and itself. Up to n keyframe ids, best first."""
    cfg = cfg or RetrievalConfig()
    scores = score_all(store, gdesc, device)
    scores[list(exclude)] = 0.0
    best = float(scores.max())
    if best <= 0.0:
        return []
    cand = np.nonzero(scores > cfg.min_score_ratio * best)[0]
    if len(cand) == 0:
        return []
    best_kf, acc = _group_accumulate(store, scores, cand, cfg.n_covisibles,
                                     score_floor=cfg.min_score_ratio * best)
    return _ordered_unique(best_kf, np.argsort(-acc), n=n)


def detect_relocalization_candidates(store: MapStore, gdesc, cfg: RetrievalConfig = None,
                                     device=None):
    """Relocalization candidates: absolute floor 0.5 on the raw score (the
    relative 0.8x-best gate alone when nothing clears it), then groups above
    0.75x the best accumulated score."""
    cfg = cfg or RetrievalConfig()
    scores = score_all(store, gdesc, device)
    best = float(scores.max())
    if best <= 0.0:
        return []
    cand = np.nonzero(scores > max(cfg.reloc_floor, cfg.min_score_ratio * best))[0]
    if len(cand) == 0:
        cand = np.nonzero(scores > cfg.min_score_ratio * best)[0]
    if len(cand) == 0:
        return []
    best_kf, acc = _group_accumulate(store, scores, cand, cfg.n_covisibles,
                                     score_floor=cfg.min_score_ratio * best)
    keep = acc > cfg.reloc_acc_ratio * float(acc.max())
    return _ordered_unique(best_kf, np.argsort(-acc), keep=keep)
