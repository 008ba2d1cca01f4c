"""Tensor parallelism over the mesh's ``model`` axis, Megatron-style: the
port's counterpart of ``mfar_tpu/parallel/sharding.py`` and of what GSPMD
inserts into the JAX train step for it.

The JAX package declares which parameter leaves shard over ``model`` and
lets GSPMD place the collectives.  Here every rank of a model group holds
its slice of each sharded leaf (:func:`shard_module`) and the encoder
issues the collectives itself, through four autograd Functions over the
model group:

- :func:`copy_to_model`: the identity forward, the sum of the ranks'
  gradients backward (the input of a column-parallel product);
- :func:`reduce_from_model`: the sum of the ranks' partial results forward
  (a row-parallel product, the vocab-parallel lookup), the identity
  backward;
- :func:`scatter_to_model` / :func:`gather_from_model`: this rank's slice
  of a whole tensor along an axis, and the ranks' slices joined, each the
  other's backward (T5's position-bias table is read through its heads'
  columns).

The rules are JAX's (first match wins), on the port's parameter names:
``attn_[qkv]`` and ``mlp_in`` weights and biases and T5's ``wi``/``wi_0``/
``wi_1`` split their output axis (torch axis 0), ``attn_o``, ``mlp_out`` and
T5's ``wo`` their input axis (torch axis 1), BERT's ``word_embeddings`` and
T5's ``token_embed`` their vocabulary (axis 0); everything else replicates.
JAX's guard holds: a leaf whose axis does not divide by ``n_model``
replicates whole (BERT's 30522-word vocabulary at ``n_model`` 4).  One rule
goes beyond JAX's: where ``n_model`` does not divide a layer's heads, a rank
cannot hold whole heads, so that layer's attention leaves stay whole on
every rank (GSPMD splits inside a head there; the math is the same).

A sharded parameter carries its placement as ``param.model_shard``
(:class:`ModelShard`), as Megatron marks its parameters, so the layers, the
optimizers and the checkpoint code read it from the parameter.  Dropout
masks of replicated activations are the same on every rank of a model group
(their generators come from the batch index); the sharded sites fold in the
model index (:func:`model_seed`).  The replicated leaves' gradients are
averaged over the group after each backward
(:func:`average_replicated_grads`), so the replicas stay bit-equal on a
card whose kernels round alike only in exact arithmetic.  Under gloo every
collective copies
through the host, as :class:`~mfar_tpu_torch.parallel.mesh.Mesh` does.  The
sums run in f32 whatever the activations' dtype.
"""

from __future__ import annotations

import collections
import dataclasses
import re
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from mfar_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh

# (name pattern, torch axis split over the model group); first match wins.
# A Linear weight is [out, in], the transpose of JAX's [in, out] kernel.
RULES: Tuple[Tuple[str, Optional[int]], ...] = (
    (r"(^|.*\.)attn_[qkv]\.weight$", 0),
    (r"(^|.*\.)attn_[qkv]\.bias$", 0),
    (r"(^|.*\.)attn_o\.weight$", 1),
    (r"(^|.*\.)mlp_in\.weight$", 0),
    (r"(^|.*\.)mlp_in\.bias$", 0),
    (r"(^|.*\.)mlp_out\.weight$", 1),
    (r"(^|.*\.)(wi|wi_0|wi_1)\.weight$", 0),
    (r"(^|.*\.)wo\.weight$", 1),
    (r"(^|.*\.)token_embed\.weight$", 0),
    (r"(^|.*\.)word_embeddings\.weight$", 0),
    (r".*", None),
)
_ATTENTION = re.compile(r"attn_[qkvo]\.")
_SEED_SHIFT = 50  # model index << 50 above a dropout site's seed (< 2**48)

# element counts of this process's model-group collectives, for the
# smoke run's per-step count (reset it to 0 before the step it reads)
collectives: collections.Counter = collections.Counter()


@dataclasses.dataclass(frozen=True)
class ModelShard:
    """Where a sharded parameter's slice sits: ``axis`` of the whole leaf,
    split in ``n`` equal parts over the mesh's model group; this rank holds
    part ``index``."""

    mesh: Mesh
    axis: int

    @property
    def n(self) -> int:
        return self.mesh.size(MODEL_AXIS)

    @property
    def index(self) -> int:
        return self.mesh.index(MODEL_AXIS)


def shard_of(param: torch.Tensor) -> Optional[ModelShard]:
    """The parameter's :class:`ModelShard`, or None when it is whole."""
    return getattr(param, "model_shard", None)


def spec_for(name: str, shape: Sequence[int], n_model: int) -> Optional[int]:
    """The torch axis of parameter ``name`` (of the whole ``shape``) that
    splits over ``n_model`` ranks by JAX's rules and guard, or None."""
    for pattern, axis in RULES:
        if re.match(pattern, name):
            break
    if axis is None or axis >= len(shape) or shape[axis] % n_model:
        return None
    return axis


def model_specs(model: torch.nn.Module, n_model: int) -> Dict[str, Optional[int]]:
    """Every parameter's split axis under ``n_model`` ranks: :func:`spec_for`,
    and whole attention leaves in a layer whose heads ``n_model`` does not
    divide."""
    specs = {name: spec_for(name, tuple(p.shape), n_model)
             for name, p in model.named_parameters()}
    for prefix, module in model.named_modules():
        cfg = getattr(module, "cfg", None)
        if hasattr(module, "attn_q") and cfg is not None and cfg.num_heads % n_model:
            pre = f"{prefix}." if prefix else ""
            for name in specs:
                if name.startswith(pre) and _ATTENTION.match(name[len(pre):]):
                    specs[name] = None
    return specs


def shard_module(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Replace each sharded parameter's data, in place, with this rank's
    slice of it (the Parameter objects stay, so an optimizer built over them
    keeps them) and mark it with its :class:`ModelShard`.  Every rank of the
    model group holds the same whole model when it calls this; a model that
    is sharded already, or a model axis of 1, is left as it is."""
    n = mesh.size(MODEL_AXIS)
    if n == 1 or getattr(model, "model_mesh", None) is not None:
        return model
    index = mesh.index(MODEL_AXIS)
    specs = model_specs(model, n)
    for name, p in model.named_parameters():
        if specs[name] is not None:
            p.data = p.data.chunk(n, specs[name])[index].contiguous()
            p.grad = None
            p.model_shard = ModelShard(mesh, specs[name])
    model.model_mesh = mesh
    return model


def is_sharded(model: torch.nn.Module) -> bool:
    return getattr(model, "model_mesh", None) is not None


# -- the collectives ----------------------------------------------------------


def _sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The model group's sum of ``x``, in f32, back in ``x``'s dtype."""
    buf = x.detach().to("cpu" if mesh.host_collectives else x.device, torch.float32, copy=True)
    collectives[buf.numel()] += 1
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group(MODEL_AXIS))
    return buf.to(x.device, x.dtype)


def _gather(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    return torch.cat(mesh.all_gather(MODEL_AXIS, x.detach()), dim=dim)


def _slice(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    return x.chunk(mesh.size(MODEL_AXIS), dim)[mesh.index(MODEL_AXIS)].contiguous()


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _sum(grad, ctx.mesh), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _sum(x, mesh)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _ScatterToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return _slice(x, mesh, dim)

    @staticmethod
    def backward(ctx, grad):
        return _gather(grad, ctx.mesh, ctx.dim), None, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return _gather(x, mesh, dim)

    @staticmethod
    def backward(ctx, grad):
        return _slice(grad, ctx.mesh, ctx.dim), None, None


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _ReduceFromModel.apply(x, mesh)


def scatter_to_model(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    return _ScatterToModel.apply(x, mesh, dim)


def gather_from_model(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    return _GatherFromModel.apply(x, mesh, dim)


def column_input(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``x`` as the input of a column-parallel product by ``weight``:
    itself when ``weight`` is whole."""
    shard = shard_of(weight)
    return x if shard is None else copy_to_model(x, shard.mesh)


def row_output(y: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """A row-parallel product by ``weight`` summed over the model group:
    ``y`` itself when ``weight`` is whole."""
    shard = shard_of(weight)
    return y if shard is None else reduce_from_model(y, shard.mesh)


def vocab_embedding(ids: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``F.embedding(ids, weight)``; over a vocab-sharded table each rank
    looks up the ids in its rows, zeroes the rest and the ranks sum the
    results, so a rank's gradient reaches only its own rows."""
    shard = shard_of(weight)
    if shard is None:
        return torch.nn.functional.embedding(ids, weight)
    lo = shard.index * weight.shape[0]
    inside = (ids >= lo) & (ids < lo + weight.shape[0])
    rows = torch.nn.functional.embedding(torch.where(inside, ids - lo, 0), weight)
    return reduce_from_model(rows * inside.unsqueeze(-1).to(rows.dtype), shard.mesh)


def model_seed(seed: Optional[int], shard: Optional[ModelShard]) -> Optional[int]:
    """The seed of a dropout site over sharded heads: ``seed`` with the
    model index folded in, so no two ranks' heads draw the same mask."""
    if seed is None or shard is None:
        return seed
    return seed + (shard.index << _SEED_SHIFT)


def average_replicated_grads(model: torch.nn.Module) -> None:
    """Average the replicated parameters' gradients over the model group,
    in place (one f32 all-reduce).  Every rank of the group computes them
    from the same values, but a CUDA kernel that sums in an order of its
    own (atomics) rounds them apart, and the replicas of a leaf would drift
    from step to step."""
    grads = [p.grad for p in model.parameters() if p.grad is not None and shard_of(p) is None]
    if not grads:
        return
    n = model.model_mesh.size(MODEL_AXIS)
    flat = _sum(torch.cat([g.reshape(-1).float() for g in grads]), model.model_mesh) / n
    start = 0
    for g in grads:
        g.copy_(flat[start : start + g.numel()].view_as(g))
        start += g.numel()


def grad_norm(params: Sequence[torch.Tensor]) -> torch.Tensor:
    """The global L2 norm of the parameters' gradients: a sharded leaf's
    squares summed over the model group, a replicated leaf's counted once."""
    grads = [p.grad for p in params if p.grad is not None]
    shards = [shard_of(p) for p in params if p.grad is not None]
    mesh = next((s.mesh for s in shards if s is not None), None)
    if mesh is None:
        return torch.nn.utils.get_total_norm(grads)
    zero = grads[0].new_zeros((), dtype=torch.float32)
    split = sum((g.float().square().sum() for g, s in zip(grads, shards) if s), zero)
    whole = sum((g.float().square().sum() for g, s in zip(grads, shards) if not s), zero)
    return (_sum(split, mesh) + whole).sqrt()


# -- the n_model 1 layout of a model and its optimizer --------------------------


def _optimizers(optimizer) -> Dict[Optional[str], torch.optim.Optimizer]:
    """A torch optimizer, or the parts of a ``GroupedOptimizer`` by name."""
    return getattr(optimizer, "optimizers", None) or {None: optimizer}


def _state_axes(optimizer: torch.optim.Optimizer, sd: Dict[str, Any]) -> Dict[int, Dict[str, int]]:
    """For each entry of ``sd["state"]`` (keyed by its index), the split
    axis of each of its tensors that is sharded: the optimizer's own answer
    where it has one (Adafactor), else the parameter's axis for every state
    tensor with the parameter's number of axes (AdamW's moments)."""
    if hasattr(optimizer, "state_axes"):
        return optimizer.state_axes()
    params = [p for g in optimizer.param_groups for p in g["params"]]
    return {i: {k: shard_of(params[i]).axis for k, v in entry.items()
                if torch.is_tensor(v) and v.dim() == params[i].dim()}
            for i, entry in sd["state"].items() if shard_of(params[i]) is not None}


def _map_state(model, optimizer, model_sd, optimizer_sd, fn):
    """``fn(tensor, axis)`` on every sharded tensor of the two state_dicts;
    new dicts, the rest shared."""
    params = dict(model.named_parameters())
    out_model = {k: fn(v, shard_of(params[k]).axis) if k in params and shard_of(params[k])
                 else v for k, v in model_sd.items()}
    parts = _optimizers(optimizer)
    out_opt = {}
    for name, opt in parts.items():
        sd = optimizer_sd if name is None else optimizer_sd[name]
        axes = _state_axes(opt, sd)
        state = {i: {k: fn(v, axes[i][k]) if k in axes.get(i, {}) else v
                     for k, v in entry.items()} for i, entry in sd["state"].items()}
        out_opt[name] = {"state": state, "param_groups": sd["param_groups"]}
    return out_model, out_opt[None] if None in parts else out_opt


def gather_state_dict(model: torch.nn.Module, optimizer, mesh: Mesh) -> Tuple[Dict, Dict]:
    """The model's and the optimizer's state_dicts in the ``n_model`` 1
    layout: every sharded tensor joined from the model group's slices.  A
    collective: every rank of the model group calls it, in one order."""
    return _map_state(model, optimizer, model.state_dict(), optimizer.state_dict(),
                      lambda t, axis: _gather(t, mesh, axis))


def shard_state_dict(model: torch.nn.Module, optimizer, mesh: Mesh, model_sd: Dict,
                     optimizer_sd: Dict) -> Tuple[Dict, Dict]:
    """The inverse of :func:`gather_state_dict`: this rank's slices of
    ``n_model`` 1 state_dicts, for ``load_state_dict`` into a model that
    :func:`shard_module` sharded (and its optimizer)."""
    return _map_state(model, optimizer, model_sd, optimizer_sd,
                      lambda t, axis: _slice(t, mesh, axis))
