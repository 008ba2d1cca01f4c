"""Data-parallel training over the mesh's batch axes: the collectives that
GSPMD inserts into the JAX package's train step, written out.

The JAX step is one program over the global batch (``mfar_tpu/train/
train_step.py:1-9``): the batch shards over the batch axes and XLA adds the
in-batch all-gathers and the gradient sums.  Here every rank runs its own
step on its rows (``shard_batch``) and:

- all-gathers its query, positive and negative embeddings with
  :func:`gather_rows`, an autograd Function whose backward hands each rank
  the summed gradient of its own rows, so every rank scores its queries
  against the whole batch's documents;
- sums the batchnorm's statistics with :func:`all_reduce_sum`, whose
  backward sums the gradients, so the statistics are the global batch's;
- after ``backward``, sums the gradients with :func:`all_reduce_gradients`
  (flat buckets), so every rank holds the gradient of the global loss and
  the optimizers step alike.

A rank's loss is the sum of its rows' terms over the global batch size, so
the ranks' losses sum to the global mean.  Dropout masks come from a
generator of each rank's own (:func:`rank_generator`).  Under gloo the
collectives take host tensors: each one copies through the host, the only
difference between the backends.  Every rank issues the same collectives
in the same order.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from mfar_tpu_torch.parallel.mesh import Axes, Mesh, batch_axes

# batch leaves that stay whole on every rank: the reverse direction reads
# the rank's document columns of every global query's BM25 scores
WHOLE_LEAVES = ("sparse_pos", "sparse_neg")
BUCKET_ELEMENTS = 1 << 25  # 128 MiB of f32 gradients a collective
_SEED_STRIDE = 0x9E3779B97F4A7C15  # odd: distinct ranks get distinct seeds


@dataclasses.dataclass(frozen=True)
class Shard:
    """This rank's rows of a global batch: ``[offset, offset + rows)`` of
    ``total`` rows, over the mesh's batch axes."""

    mesh: Mesh
    axes: Axes
    index: int  # this rank's position along the batch axes
    count: int  # ranks along the batch axes
    rows: int  # this rank's rows of the global batch

    @property
    def offset(self) -> int:
        return self.index * self.rows

    @property
    def total(self) -> int:
        return self.count * self.rows


def _host(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A private contiguous copy for a collective (on the host under gloo)."""
    return x.detach().to("cpu", copy=True) if mesh.host_collectives else x.detach().clone()


def _all_reduce(x: torch.Tensor, mesh: Mesh, axes: Axes) -> torch.Tensor:
    buf = _host(x.contiguous(), mesh)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group(axes))
    return buf.to(x.device)


class _GatherRows(torch.autograd.Function):
    """Rows of every rank along the batch axes, in their order; backward:
    the sum over the ranks of the gradient of this rank's rows."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, shard: Shard) -> torch.Tensor:
        ctx.shard = shard
        src = _host(x.contiguous(), shard.mesh)
        out = [torch.empty_like(src) for _ in range(shard.count)]
        dist.all_gather(out, src, group=shard.mesh.group(shard.axes))
        return torch.cat(out).to(x.device)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        s = ctx.shard
        rows = grad.shape[0] // s.count
        full = _all_reduce(grad, s.mesh, s.axes)
        return full[s.index * rows : (s.index + 1) * rows], None


class _AllReduceSum(torch.autograd.Function):
    """The sum over the ranks of every rank's ``x``; backward: the sum of
    the ranks' gradients (each rank's loss reads the same sum)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, shard: Shard) -> torch.Tensor:
        ctx.shard = shard
        return _all_reduce(x, shard.mesh, shard.axes)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return _all_reduce(grad, ctx.shard.mesh, ctx.shard.axes), None


def gather_rows(x: torch.Tensor, shard: Shard) -> torch.Tensor:
    """``[rows, ...]`` on every rank -> ``[total, ...]``, differentiable."""
    return _GatherRows.apply(x, shard)


def all_reduce_sum(x: torch.Tensor, shard: Shard) -> torch.Tensor:
    """The ranks' sum of ``x``, differentiable."""
    return _AllReduceSum.apply(x, shard)


def shard_batch(batch: Dict[str, Any], mesh: Optional[Mesh]) -> Tuple[Dict[str, Any],
                                                                        Optional[Shard]]:
    """This rank's contiguous rows of a collated batch (the counterpart of
    the JAX trainer's ``_place_batch``) and where they sit, or the whole
    batch and None when there is no mesh, one shard, or query rows that do
    not divide the shards (a ragged validation batch): then every rank
    computes the global result alone, as JAX's replicated leaves do.  The
    split is decided for the batch, not per leaf, so a batch never mixes
    split and whole token arrays; ``sparse_pos``/``sparse_neg`` stay whole
    (the loss slices them)."""
    if mesh is None:
        return batch, None
    axes = batch_axes(mesh)
    count = mesh.size(axes)
    total = batch["query"]["input_ids"].shape[0]
    if count == 1 or total % count:
        return batch, None
    index = mesh.index(axes)

    def take(x):
        if isinstance(x, dict):
            return {k: take(v) for k, v in x.items()}
        if x is None or getattr(x, "ndim", 0) < 1:
            return x
        per = x.shape[0] // count  # B or B*Nn rows: both divide
        return x[index * per : (index + 1) * per]

    local = {k: v if k in WHOLE_LEAVES else take(v) for k, v in batch.items()}
    return local, Shard(mesh, axes, index, count, total // count)


def rank_generator(generator: torch.Generator, shard: Optional[Shard]) -> torch.Generator:
    """The dropout generator of one step: ``generator`` itself on one
    device (or for a whole batch), else a generator seeded from one draw of
    it and this rank's index.  Every rank's ``generator`` advances alike,
    so a restored state replays every rank's masks, and no two ranks draw
    the same masks."""
    if shard is None:
        return generator
    base = int(torch.randint(0, 2**62, (1,), generator=generator))
    return torch.Generator().manual_seed((base + shard.index * _SEED_STRIDE) % 2**63)


def all_reduce_gradients(params: Sequence[torch.Tensor], shard: Shard,
                         extra: Optional[torch.Tensor] = None) -> Optional[torch.Tensor]:
    """Sum every parameter's ``.grad`` over the ranks in place, in flat
    buckets of at most ``BUCKET_ELEMENTS`` of one dtype; ``extra`` (a
    scalar such as the rank's loss) rides in the first bucket and its sum
    is returned.  Parameters without a gradient are left out (every rank
    has the same ones)."""
    buckets: List[List[torch.Tensor]] = []
    size = 0
    for g in (p.grad for p in params if p.grad is not None):
        if not buckets or size + g.numel() > BUCKET_ELEMENTS or g.dtype != buckets[-1][0].dtype:
            buckets.append([])
            size = 0
        buckets[-1].append(g)
        size += g.numel()
    total = None
    for i, bucket in enumerate(buckets):
        parts = [g.reshape(-1) for g in bucket]
        if i == 0 and extra is not None:
            parts.insert(0, extra.detach().reshape(1).to(bucket[0].dtype))
        flat = _all_reduce(torch.cat(parts), shard.mesh, shard.axes)
        if i == 0 and extra is not None:
            total, flat = flat[0].to(extra.dtype), flat[1:]
        start = 0
        for g in bucket:
            g.copy_(flat[start : start + g.numel()].view_as(g))
            start += g.numel()
    return total


# -- rank 0's state to every rank -------------------------------------------


@dataclasses.dataclass(frozen=True)
class _TensorSlot:
    """Where a tensor sat in a broadcast tree: what to allocate for it."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


def _map(tree, leaf_type, fn):
    """``tree`` (nested dicts, lists and tuples) with each ``leaf_type``
    leaf replaced by ``fn(leaf)``, visited in order."""
    if isinstance(tree, leaf_type):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(v, leaf_type, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, leaf_type, fn) for v in tree)
    return tree


def broadcast_tree(tree: Any, mesh: Mesh, src: int = 0) -> Any:
    """Rank ``src``'s nested dicts and lists of tensors and plain values (a
    checkpoint's payload, a state_dict) on every rank of the mesh, tensors
    on the host.  Only ``src``'s ``tree`` is read: the others pass None.
    The structure goes as one pickled object, then each tensor over the
    mesh's host control group."""
    tensors: List[torch.Tensor] = []

    def keep(t: torch.Tensor) -> torch.Tensor:
        tensors.append(t.detach().to("cpu", copy=True).contiguous())
        return tensors[-1]

    def alloc(slot: _TensorSlot) -> torch.Tensor:
        tensors.append(torch.empty(slot.shape, dtype=slot.dtype))
        return tensors[-1]

    box = [None]
    if mesh.rank == src:
        tree = _map(tree, torch.Tensor, keep)
        box = [_map(tree, torch.Tensor, lambda t: _TensorSlot(tuple(t.shape), t.dtype))]
    dist.broadcast_object_list(box, src=src, group=mesh.control)
    if mesh.rank != src:
        tree = _map(box[0], _TensorSlot, alloc)
    for t in tensors:
        dist.broadcast(t, src=src, group=mesh.control)
    return tree


def broadcast_module(module: torch.nn.Module, mesh: Mesh, src: int = 0) -> None:
    """Rank ``src``'s parameters and buffers into every rank's ``module``."""
    module.load_state_dict(broadcast_tree(module.state_dict() if mesh.rank == src else None,
                                          mesh, src))


def broadcast_object(value: Any, mesh: Mesh, src: int = 0) -> Any:
    """Rank ``src``'s picklable ``value`` (an int, None, a string) on every
    rank of the mesh."""
    box = [value]
    dist.broadcast_object_list(box, src=src, group=mesh.control)
    return box[0]
