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
does).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

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


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """What :func:`make_optimizer` configures; :meth:`build` makes the
    optimizer over a model's parameters (torch optimizers hold them)."""

    encoder_lr: float
    weights_lr: float
    weight_decay: float
    freeze_encoder: bool

    def build(self, model: nn.Module) -> torch.optim.AdamW:
        labels = param_labels(model)
        groups: Dict[str, List[nn.Parameter]] = {"encoder": [], "head": []}
        for name, p in model.named_parameters():
            groups[labels[name]].append(p)
        param_groups = [dict(params=groups["head"], lr=self.weights_lr,
                             weight_decay=HEAD_WEIGHT_DECAY, name="head")]
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
    if use_adafactor:
        raise NotImplementedError(
            "Adafactor (the T5 encoders' optimizer) is not ported yet: ROADMAP A14"
        )
    return OptimizerSpec(encoder_lr, weights_lr, weight_decay, freeze_encoder)
