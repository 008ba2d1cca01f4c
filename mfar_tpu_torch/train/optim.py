"""Two-group optimization: encoder LR vs mixer/bn ("head") LR.

Counterpart of ``mfar_tpu/train/optim.py``, whose optax ``multi_transform``
runs ``adamw(encoder_lr, weight_decay)`` on the encoder and
``adamw(weights_lr, weight_decay=0.01)`` on the head (mixer + batchnorm).
Here that is one ``torch.optim.AdamW`` with two parameter groups, at
optax's defaults (b1 0.9, b2 0.999, eps 1e-8 added outside the square root,
decoupled weight decay), which update a parameter as optax does.
``freeze_encoder`` (optax ``set_to_zero`` on the encoder) leaves the encoder
out of the optimizer: no update, no decay; its gradients are still computed
(the step's ``grad_norm`` spans every gradient, as ``optax.global_norm``
does).  It takes precedence over ``use_adafactor``, as in JAX.

``use_adafactor`` (the T5 family's encoder optimizer) runs :class:`Adafactor`
on the encoder, optax's ``adafactor(lr, multiply_by_parameter_scale=False,
clipping_threshold=1.0, decay_rate=0.8)``, beside the head's AdamW; the two
step as one :class:`GroupedOptimizer`.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

ADAM_BETAS = (0.9, 0.999)  # optax.adamw defaults
ADAM_EPS = 1e-8
HEAD_WEIGHT_DECAY = 0.01  # torch AdamW's default, which the reference's head group uses


def param_labels(model: nn.Module) -> Dict[str, str]:
    """Label each parameter 'encoder' or 'head' (mixer + batchnorm) by its
    top-level module."""
    return {
        name: "encoder" if name.split(".")[0] == "encoder" else "head"
        for name, _ in model.named_parameters()
    }


def jax_leaves(module: nn.Module) -> List[Dict[str, Any]]:
    """The module's parameters grouped as the JAX package's tree holds them,
    one param group a leaf: the layers of a scanned stack
    (``layers.<i>.<rest>``) form one leaf stacked on a leading axis, in
    layer order, and an ``nn.Linear`` weight ``[out, in]`` is the transpose
    of its Flax kernel ``[in, out]``."""
    linear = {f"{n}.weight" for n, m in module.named_modules() if isinstance(m, nn.Linear)}
    leaves: Dict[str, Dict[str, Any]] = {}
    for name, p in module.named_parameters():
        parts = name.split(".")
        stacked = parts[0] == "layers"
        key = ".".join(["layers"] + parts[2:]) if stacked else name
        leaf = leaves.setdefault(key, dict(params=[], name=key, stacked=stacked,
                                           transposed=name in linear))
        leaf["params"].append(p)
    return list(leaves.values())


def _factored_dims(shape: Sequence[int], min_dim_size_to_factor: int) -> Optional[Tuple[int, int]]:
    """optax's choice: the (second largest, largest) axes when the second
    largest has at least ``min_dim_size_to_factor`` entries, else None."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor(torch.optim.Optimizer):
    """optax's ``adafactor`` as the JAX package configures it: factored
    second moments (``scale_by_factored_rms``: ``eps`` added to g²,
    ``beta2(t) = 1 - (t + 1) ** -decay_rate``, factored over the two largest
    axes when the second largest reaches ``min_dim_size_to_factor``),
    ``clip_by_block_rms(clipping_threshold)``, then ``-lr``; no momentum, no
    decay, no parameter scale.

    Each param group is one JAX leaf (:func:`jax_leaves`), and the update is
    computed on the leaf as JAX holds it: a scanned stack's layers stacked
    on axis 0, Linear weights transposed.  So the block RMS that clips an
    update spans every layer of the stack, as it does in JAX, while the
    factoring stays per layer (the layer axis is never one of the two
    largest at these widths).  The state (per leaf, keyed by its first
    tensor) saves and restores with ``state_dict``."""

    def __init__(self, leaves: Sequence[Dict[str, Any]], lr: float, decay_rate: float = 0.8,
                 clipping_threshold: float = 1.0, eps: float = 1e-30,
                 min_dim_size_to_factor: int = 128):
        defaults = dict(lr=lr, decay_rate=decay_rate, clipping_threshold=clipping_threshold,
                        eps=eps, min_dim_size_to_factor=min_dim_size_to_factor,
                        stacked=False, transposed=False)
        super().__init__(list(leaves), defaults)

    @staticmethod
    def _leaf(group, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        ts = [t.T if group["transposed"] else t for t in tensors]
        return torch.stack(ts) if group["stacked"] else ts[0]

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = group["params"]
            # a tensor the loss does not reach has a zero gradient in JAX
            grad = self._leaf(group, [p.grad if p.grad is not None else torch.zeros_like(p)
                                      for p in params]).float()
            state = self.state[params[0]]
            dims = _factored_dims(grad.shape, group["min_dim_size_to_factor"])
            if not state:
                state["step"] = 0
                if dims is None:
                    state["v"] = torch.zeros_like(grad)
                else:
                    state["v_row"] = torch.zeros_like(grad.mean(dim=dims[1]))
                    state["v_col"] = torch.zeros_like(grad.mean(dim=dims[0]))
            t = torch.tensor(state["step"] + 1, dtype=torch.float32)
            beta = (1.0 - t ** -group["decay_rate"]).to(grad.device)
            grad_sqr = grad * grad + group["eps"]
            if dims is None:
                state["v"] = beta * state["v"] + (1.0 - beta) * grad_sqr
                update = grad * state["v"] ** -0.5
            else:
                d1, d0 = dims
                state["v_row"] = beta * state["v_row"] + (1.0 - beta) * grad_sqr.mean(dim=d0)
                state["v_col"] = beta * state["v_col"] + (1.0 - beta) * grad_sqr.mean(dim=d1)
                row_mean = state["v_row"].mean(dim=d1 - 1 if d1 > d0 else d1, keepdim=True)
                row_factor = (state["v_row"] / row_mean) ** -0.5
                col_factor = state["v_col"] ** -0.5
                update = grad * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
            rms = update.square().mean().sqrt()
            update = update / torch.clamp(rms / group["clipping_threshold"], min=1.0)
            update = update * group["lr"]
            for i, p in enumerate(params):
                u = update[i] if group["stacked"] else update
                p.sub_(u.T if group["transposed"] else u)
            state["step"] += 1
        return loss


class GroupedOptimizer:
    """The encoder's and the head's optimizers stepped as one (optax's
    ``multi_transform`` over the two labels); its ``state_dict`` holds both."""

    def __init__(self, **optimizers: torch.optim.Optimizer):
        self.optimizers = optimizers

    def step(self) -> None:
        for opt in self.optimizers.values():
            opt.step()

    def zero_grad(self, set_to_none: bool = True) -> None:
        for opt in self.optimizers.values():
            opt.zero_grad(set_to_none=set_to_none)

    def state_dict(self) -> Dict[str, Any]:
        return {name: opt.state_dict() for name, opt in self.optimizers.items()}

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        for name, opt in self.optimizers.items():
            opt.load_state_dict(state_dict[name])


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """What :func:`make_optimizer` configures; :meth:`build` makes the
    optimizer over a model's parameters (torch optimizers hold them)."""

    encoder_lr: float
    weights_lr: float
    weight_decay: float
    freeze_encoder: bool
    use_adafactor: bool = False

    def build(self, model: nn.Module):
        """``torch.optim.AdamW`` over both groups, or with ``use_adafactor``
        a :class:`GroupedOptimizer` of :class:`Adafactor` on the encoder and
        AdamW on the head."""
        labels = param_labels(model)
        groups: Dict[str, List[nn.Parameter]] = {"encoder": [], "head": []}
        for name, p in model.named_parameters():
            groups[labels[name]].append(p)
        param_groups = [dict(params=groups["head"], lr=self.weights_lr,
                             weight_decay=HEAD_WEIGHT_DECAY, name="head")]
        if self.use_adafactor and not self.freeze_encoder:
            return GroupedOptimizer(
                encoder=Adafactor(jax_leaves(model.encoder), lr=self.encoder_lr),
                head=torch.optim.AdamW(param_groups, betas=ADAM_BETAS, eps=ADAM_EPS))
        if not self.freeze_encoder:
            param_groups.insert(0, dict(params=groups["encoder"], lr=self.encoder_lr,
                                        weight_decay=self.weight_decay, name="encoder"))
        return torch.optim.AdamW(param_groups, betas=ADAM_BETAS, eps=ADAM_EPS)


def make_optimizer(
    encoder_lr: float = 1e-4,
    weights_lr: Optional[float] = None,
    weight_decay: float = 0.0,
    freeze_encoder: bool = False,
    use_adafactor: bool = False,
) -> OptimizerSpec:
    if weights_lr is None:
        raise ValueError("weights_lr must be specified (mirrors the reference CLI contract)")
    if use_adafactor and weight_decay and not freeze_encoder:
        # the reference's T5 optimizer carries no weight decay: surface
        # (rather than silently drop) a requested regularizer
        warnings.warn(
            f"weight_decay={weight_decay} is ignored with adafactor "
            f"(the reference's T5 optimizer has no decay either)",
            stacklevel=2,
        )
    return OptimizerSpec(encoder_lr, weights_lr, weight_decay, freeze_encoder, use_adafactor)
