"""The ranks' mesh and the corpus's row sharding.

Counterpart of ``mfar_tpu/parallel/mesh.py``.  JAX's ``Mesh`` holds devices
on the axes ``replica`` (across slices), ``data`` (corpus rows and the
batch within a slice) and ``model`` (tensor parallelism); here the same
axes hold the world's ranks, one process per card, in JAX's order: replica
slowest.  A :class:`Mesh` also holds the process groups the distributed
routes use: for each set of axes, the ranks that differ only along those
axes.  Every rank makes every group, in one fixed order, when the mesh is
made.

In serving, the corpus shards its rows over the corpus axes (``batch_axes``,
or ``data`` alone with a corpus per slice) and ranks along ``model`` hold
the same shard and repeat the work, as JAX's replicated corpus spec does.
In training, ranks along ``model`` hold shards of the encoder's weights
(:mod:`mfar_tpu_torch.parallel.tensor_parallel`) and run the same rows.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from mfar_tpu_torch.parallel import multihost

REPLICA_AXIS = "replica"  # across slices: replicas of the corpus (per-slice corpus)
DATA_AXIS = "data"  # corpus rows and the batch
MODEL_AXIS = "model"  # tensor parallelism
AXES = (REPLICA_AXIS, DATA_AXIS, MODEL_AXIS)

# The batch / corpus-row sharding axes, outer to inner.
BATCH_AXES = (REPLICA_AXIS, DATA_AXIS)

Axes = Tuple[str, ...]

# The axis sets the routes reduce over: the corpus axes (data; replica and
# data), the query axis (replica) and the tensor-parallel axis (model).
# Groups are made in this order.
_GROUP_AXES: Tuple[Axes, ...] = ((DATA_AXIS,), (REPLICA_AXIS,), BATCH_AXES, (MODEL_AXIS,))


def _axes(axes) -> Axes:
    return (axes,) if isinstance(axes, str) else tuple(axes)


class Mesh:
    """The world's ranks as an ``n_replica x n_data x n_model`` grid, this
    rank's place in it, and the process groups along its axes.
    ``host_collectives`` is true under gloo, whose collectives take host
    tensors: the routes copy their small results through the host.
    ``control`` is the gloo group of the mesh's ranks for host-side control
    (barriers, broadcasts of host state).  A mesh may leave ranks of the
    world out (``member`` is False on them): they make its groups and take
    no part in its work."""

    def __init__(self, ranks: np.ndarray, backend: Optional[str] = None):
        self.ranks = np.asarray(ranks, np.int64)
        self.shape: Dict[str, int] = dict(zip(AXES, self.ranks.shape))
        self.rank = dist.get_rank()
        where = np.argwhere(self.ranks == self.rank)
        self.member = len(where) > 0
        self.coords: Dict[str, int] = (dict(zip(AXES, (int(c) for c in where[0])))
                                       if self.member else {})
        self.backend = backend or dist.get_backend()
        self.host_collectives = self.backend == "gloo"
        # made on every rank before the mesh's groups
        self.control = multihost.control_group()
        if self.ranks.size < dist.get_world_size():
            self.control = dist.new_group(sorted(int(r) for r in self.ranks.flat),
                                          backend="gloo", timeout=multihost.TIMEOUT)
        self._groups = {axes: self._make_groups(axes) for axes in _GROUP_AXES}

    def _make_groups(self, axes: Axes):
        """Partition the ranks into the groups that differ only along
        ``axes`` (every rank makes every group); returns this rank's."""
        order = [AXES.index(a) for a in AXES if a not in axes] + [AXES.index(a) for a in axes]
        blocks = self.ranks.transpose(order).reshape(-1, self.size(axes))
        mine = None
        for block in blocks:
            members = [int(r) for r in block]
            g = dist.new_group(members, backend=self.backend, timeout=multihost.TIMEOUT)
            if self.rank in members:
                mine = g
        return mine

    def size(self, axes) -> int:
        return int(np.prod([self.shape[a] for a in _axes(axes)]))

    def index(self, axes) -> int:
        """This rank's position along ``axes`` (the first axis slowest)."""
        i = 0
        for a in _axes(axes):
            i = i * self.shape[a] + self.coords[a]
        return i

    def group(self, axes):
        """The process group of the ranks that differ from this one only
        along ``axes`` (outer axis first)."""
        return self._groups[_axes(axes)]

    def all_gather(self, axes, t: torch.Tensor) -> List[torch.Tensor]:
        """Every member's ``t`` along ``axes``, in their order along them,
        on ``t``'s device (through the host under gloo)."""
        n = self.size(axes)
        if n == 1:
            return [t]
        src = t.contiguous().cpu() if self.host_collectives else t.contiguous()
        out = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(out, src, group=self.group(axes))
        return [o.to(t.device) for o in out]

    def all_reduce_sum(self, axes, t: torch.Tensor) -> torch.Tensor:
        """The sum of every member's ``t`` along ``axes`` (through the host
        under gloo)."""
        if self.size(axes) == 1:
            return t
        src = t.contiguous().cpu() if self.host_collectives else t.contiguous()
        dist.all_reduce(src, op=dist.ReduceOp.SUM, group=self.group(axes))
        return src.to(t.device)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank {self.rank}, {self.backend})"


def make_mesh(
    n_data: Optional[int] = None,
    n_model: int = 1,
    n_replica: int = 1,
    backend: Optional[str] = None,
    n_ranks: Optional[int] = None,
) -> Mesh:
    """Mesh with ('replica', 'data', 'model') axes over the world's first
    ``n_ranks`` ranks (default all of them), all on the data axis unless
    told otherwise.  ``backend`` is the backend of the mesh's groups
    (default: the world's), e.g. ``gloo`` for ranks that share one card,
    where NCCL refuses to run.  Every rank of the world calls this at the
    same point."""
    n_ranks = dist.get_world_size() if n_ranks is None else n_ranks
    if n_data is None:
        n_data = n_ranks // (n_model * n_replica)
    if n_replica * n_data * n_model != n_ranks:
        raise ValueError(f"mesh {n_replica}x{n_data}x{n_model} != {n_ranks} ranks")
    return Mesh(np.arange(n_ranks).reshape(n_replica, n_data, n_model), backend=backend)


def mesh_from_flag(flag: str, tag: str = "mesh", n_model: int = 1,
                   n_replica: int = 1) -> Optional[Mesh]:
    """CLI bootstrap for ``--mesh auto``: the mesh over every rank when the
    world holds more than one, else None."""
    world = multihost.process_count()
    if flag != "auto" or world <= 1:
        return None
    if world % (n_model * n_replica):
        raise SystemExit(f"n_model x n_replica = {n_model} x {n_replica} must divide the "
                         f"{world} ranks")
    mesh = make_mesh(n_model=n_model, n_replica=n_replica)
    if multihost.is_primary():
        print(f"[{tag}] mesh: {mesh.shape} over {world} ranks ({mesh.backend})", flush=True)
    return mesh


def batch_axes(mesh: Mesh) -> Axes:
    """The axes the batch and the corpus rows shard over: ('replica',
    'data') when the mesh has a real replica axis, else ('data',)."""
    if mesh.shape[REPLICA_AXIS] > 1:
        return BATCH_AXES
    return (DATA_AXIS,)


def n_batch_shards(mesh: Mesh) -> int:
    return mesh.size(batch_axes(mesh))


def pad_rows(x: np.ndarray, multiple: int) -> Tuple[np.ndarray, int]:
    """Pad axis 0 to a multiple; returns (padded, valid_n).  Padding rows are
    zero (they score 0 and are masked out by valid_n in top-k)."""
    n = x.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    return np.pad(x, [(0, rem)] + [(0, 0)] * (x.ndim - 1)), n


def corpus_sharding(mesh: Mesh, replicate_across_slices: bool = False) -> Axes:
    """The axes the corpus rows shard over: every batch axis by default (a
    corpus bigger than one slice spans slices; only [B, k] merges cross
    them), or ``data`` alone with a full copy per slice."""
    if replicate_across_slices:
        return (DATA_AXIS,)
    return batch_axes(mesh)


def shard_rows(n: int, mesh: Mesh, axes) -> Tuple[int, int]:
    """(offset, shard_n) of this rank's contiguous block of an ``n``-row
    corpus padded to a multiple of the shard count (JAX's row sharding:
    shard ``i`` holds rows ``[i * shard_n, (i + 1) * shard_n)``)."""
    n_shards = mesh.size(axes)
    shard_n = -(-n // n_shards)
    return mesh.index(axes) * shard_n, shard_n
