"""Device meshes over shards of the map, and the multi-process runtime.

Counterpart of hfnet_slam_tpu/parallel/multihost.py. The reference shards
with `shard_map` over a jax.sharding.Mesh and reduces with `psum`; the port
has a small `Mesh` of its own:
  * each process computes the terms of its `n_local` shards batched over a
    leading shard axis, on its one device;
  * `psum` sums that axis, then all-reduces the sum over the mesh's
    torch.distributed process group when there is one (gloo on the CPU,
    NCCL on cards).
One process with D shards on one device thus computes the reference's
D-device mesh; one shard per card across D processes computes the
multi-GPU one. Shard s of the mesh lives in process s // n_local.

`initialize` brings up torch.distributed from an explicit address, world
size and rank; nothing in the environment names a cluster, and a single
process (tests, one card) skips it. `make_mesh` and `make_hybrid_mesh` take
every process of the group, one host per process in the hybrid layout.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import device as D


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


@dataclasses.dataclass(frozen=True)
class Mesh:
    """`n_local` shards computed batched on `device`, in each process of
    `group` (None: this process alone). `shape` names the layout: ("ba",)
    for a flat mesh, ("host", "kf") for the hybrid one."""

    device: torch.device
    n_local: int = 1
    axis_names: tuple = ("ba",)
    group: Optional[object] = None

    @property
    def n_procs(self) -> int:
        return 1 if self.group is None else _dist().get_world_size(self.group)

    @property
    def rank(self) -> int:
        return 0 if self.group is None else _dist().get_rank(self.group)

    @property
    def size(self) -> int:
        """Shards in the whole mesh."""
        return self.n_local * self.n_procs

    @property
    def shape(self) -> dict:
        if len(self.axis_names) == 2:
            return dict(zip(self.axis_names, (self.n_procs, self.n_local)))
        return {self.axis_names[0]: self.size}

    def local_shards(self) -> slice:
        """This process's shards among the mesh's."""
        return slice(self.rank * self.n_local, (self.rank + 1) * self.n_local)

    def psum(self, x):
        """(n_local, ...) per-shard terms -> their sum over every shard of
        the mesh, the same in every process."""
        s = x.sum(0)
        if self.group is not None:
            _dist().all_reduce(s, group=self.group)
        return s

    def all_gather(self, x):
        """(n_local, ...) -> (size, ...): every process's shards, in mesh
        order, in every process."""
        if self.group is None:
            return x
        parts = [torch.empty_like(x) for _ in range(self.n_procs)]
        _dist().all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts, 0)


def initialize(coordinator_address: str = None, num_processes: int = None,
               process_id: int = None, backend: str = None) -> bool:
    """Join a torch.distributed group at tcp://`coordinator_address`
    ("host:port") as process `process_id` of `num_processes`. Returns True
    when a multi-process group was set up, False (a no-op) for a single
    process. backend None: NCCL with a card, gloo without."""
    if not coordinator_address and num_processes is None:
        return False
    import torch.distributed as dist

    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes), rank=int(process_id))
    return True


def shutdown():
    if _dist() is not None:
        _dist().destroy_process_group()


def _group():
    d = _dist()
    return None if d is None else d.group.WORLD


def make_mesh(axis: str = "kf", n_local: int = 1, device=None) -> Mesh:
    """Flat 1-D mesh: `n_local` shards on `device` (None means CUDA) in every
    process of the default group (after initialize()), or in this one."""
    return Mesh(D.resolve(device), n_local, (axis,), _group())


def make_hybrid_mesh(dcn_axis: str = "host", ici_axis: str = "kf", n_local: int = 1,
                     device=None) -> Mesh:
    """2-D (hosts, shards per host) mesh: one host per process, `n_local`
    shards each; (1, n_local) in a single process. Shard big tables over
    the inner axis; what psum reduces over the outer one is the small
    result."""
    return Mesh(D.resolve(device), n_local, (dcn_axis, ici_axis), _group())


def process_shard(n: int, process_index: int = None, process_count: int = None):
    """Contiguous [lo, hi) rows of a length-n axis owned by this process
    (each process feeds only its own rows of a sharded table)."""
    d = _dist()
    pi = (0 if d is None else d.get_rank()) if process_index is None else process_index
    pc = (1 if d is None else d.get_world_size()) if process_count is None else process_count
    per = -(-n // pc)
    lo = min(pi * per, n)
    return lo, min(lo + per, n)


def global_array(local_rows, mesh: Mesh):
    """This process's `process_shard` rows of a table sharded over the mesh,
    as (n_local, rows per shard, ...) on the mesh's device: the process
    holds its own rows only."""
    rows = torch.as_tensor(np.asarray(local_rows)).to(mesh.device)
    if len(rows) % mesh.n_local:
        raise ValueError(f"{len(rows)} local rows do not split into {mesh.n_local} shards")
    return rows.reshape((mesh.n_local, -1) + tuple(rows.shape[1:]))
