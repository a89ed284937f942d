"""Place-recognition retrieval with the keyframe axis sharded over a mesh.

Counterpart of hfnet_slam_tpu/parallel/retrieval.py. The keyframe
database's global-descriptor table is split into the mesh's shards along the
keyframe axis; each process scores the queries against its own shards (one
batched matrix product), and the small (Q, K) score table is gathered.
Queries are replicated and the big table is never re-laid out.

Where the reference requires K to be a multiple of the mesh's size, the
port pads the table with invalid rows, which score 0.
"""
from __future__ import annotations

import numpy as np
import torch

from .multihost import Mesh


def make_sharded_db(mesh: Mesh, gdesc, valid):
    """This process's shards of the (K, G) descriptor table and the (K,)
    validity: (n_local, K'/D, G) and (n_local, K'/D) on the mesh's device,
    with K padded to K', a multiple of the mesh's size D."""
    db = torch.tensor(np.asarray(gdesc), dtype=torch.float32, device=mesh.device)  # a copy
    vm = torch.tensor(np.asarray(valid), dtype=torch.bool, device=mesh.device)
    K, n = db.shape[0], mesh.size
    pad = -K % n
    if pad:
        db = torch.cat([db, db.new_zeros((pad, db.shape[1]))])
        vm = torch.cat([vm, vm.new_zeros(pad)])
    per = (K + pad) // n
    sl = mesh.local_shards()
    return db.reshape(n, per, -1)[sl].contiguous(), vm.reshape(n, per)[sl].contiguous()


def sharded_scores(mesh: Mesh, queries, db, db_mask):
    """(Q, G) queries against the sharded table and mask of make_sharded_db
    -> (Q, K') scores max(0, 1 - |g_q - g_k|), 0 on invalid and padding
    keyframes, the same in every process."""
    q = torch.as_tensor(queries, dtype=torch.float32).to(mesh.device)
    s = q[None] @ db.transpose(1, 2)                              # (n_local, Q, K/D)
    d = torch.sqrt(torch.clamp(2.0 - 2.0 * s, min=0.0))
    sc = torch.where(db_mask[:, None, :], torch.clamp(1.0 - d, min=0.0), 0.0)
    sc = mesh.all_gather(sc)                                      # (D, Q, K/D)
    return sc.permute(1, 0, 2).reshape(q.shape[0], -1)


def top_candidates(mesh: Mesh, queries, db, db_mask, n: int = 3):
    """Top-n keyframe indices and scores per query, best first; equal scores
    in keyframe order (lax.top_k's order)."""
    sc = sharded_scores(mesh, queries, db, db_mask)
    vals, idx = torch.sort(sc, dim=-1, descending=True, stable=True)
    return idx[:, :n], vals[:, :n]
