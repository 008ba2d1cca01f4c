"""The training step: counterpart of ``mfar_tpu/train/train_step.py``.

One call runs the reference's manual-optimization step: forward (1 + 2*Fd
encoder passes, grouped by padded length), the hybrid loss over the global
batch, backward, the two-group optimizer update and the batchnorm's
running-stat update.  Where JAX returns a new immutable state, the port
updates the model and optimizer in place (no second copy of the weights
and moments) and returns the same :class:`TrainState`.

Randomness: the state holds a CPU ``torch.Generator`` seeded from the run's
seed; each step's dropout masks come from one draw of it per encoder call
(:meth:`mfar_tpu_torch.models.encoder.Encoder.forward`), so a restored state
replays the same masks.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch

from mfar_tpu_torch.models import init_encoder
from mfar_tpu_torch.train.model import MFARModel
from mfar_tpu_torch.train.optim import OptimizerSpec
from mfar_tpu_torch.utils.device import DeviceLike, resolve_device


@dataclasses.dataclass
class TrainState:
    model: MFARModel  # parameters and batchnorm running stats, on the device
    optimizer: Any  # torch.optim.Optimizer, or OptimizerSpec.build's pair of them
    step: int
    generator: torch.Generator  # CPU; dropout draws


def init_state(
    model: MFARModel,
    optimizer: OptimizerSpec,
    seed: int = 0,
    device: DeviceLike = None,
) -> TrainState:
    """Random-init the model's encoder from ``seed`` (its family's init,
    :func:`mfar_tpu_torch.models.init_encoder`), move the model to
    ``device`` (default cuda; raises without a card) and build the
    optimizer over it.  Load pretrained encoder weights with
    ``state.model.encoder.load_state_dict`` before the first step (the
    optimizer's moments start lazily, so nothing is stale)."""
    dev = resolve_device(device)
    model.encoder.load_state_dict(init_encoder(model.encoder_config, seed=seed).state_dict())
    model.to(dev)
    return TrainState(
        model=model,
        optimizer=optimizer.build(model),
        step=0,
        generator=torch.Generator().manual_seed(seed),
    )


def to_device(batch: Any, device: torch.device) -> Any:
    """Numpy leaves of a collated batch as tensors on ``device`` (ids as
    int64); None and tensors pass through."""
    if isinstance(batch, dict):
        return {k: to_device(v, device) for k, v in batch.items()}
    if isinstance(batch, np.ndarray):
        t = torch.from_numpy(batch)
        if not t.is_floating_point():
            t = t.long()
        return t.to(device, non_blocking=True)
    if isinstance(batch, torch.Tensor):
        return batch.to(device)
    return batch


def _loss(model: MFARModel, batch: Dict[str, Any], generator=None) -> torch.Tensor:
    device = next(model.parameters()).device
    b = to_device(batch, device)
    return model.compute_loss(
        b["query"], b["pos"], b["neg"], b.get("sparse_pos"), b.get("sparse_neg"),
        generator=generator,
    )


def train_step(state: TrainState, batch: Dict[str, Any]) -> Tuple[TrainState, Dict]:
    """One step (JAX's ``make_train_step(model, optimizer)`` product):
    returns the state, updated in place, and ``{"loss", "grad_norm"}`` as
    device scalars (fetched when the caller needs them).  ``batch`` is the
    collated layout of :class:`mfar_tpu_torch.train.data_pipeline.
    ContrastiveDataset` (numpy or tensors):

      query:  {input_ids, attention_mask}               [B, Sq]
      pos:    {field_key: {input_ids, attention_mask}}  each [B, Sf]
      neg:    {field_key: {input_ids, attention_mask}}  each [B*Nn, Sf]
      sparse_pos: [B, B, Fs] or None;  sparse_neg: [B, B*Nn, Fs] or None
    """
    model = state.model.train()
    params = [p for p in model.parameters() if p.requires_grad]
    loss = _loss(model, batch, state.generator)
    loss.backward()
    grad_norm = torch.nn.utils.get_total_norm([p.grad for p in params if p.grad is not None])
    state.optimizer.step()
    for p in params:  # a frozen encoder's gradients are not the optimizer's to clear
        p.grad = None
    state.step += 1
    return state, {"loss": loss.detach(), "grad_norm": grad_norm}


def eval_loss_step(state: TrainState, batch: Dict[str, Any]) -> torch.Tensor:
    """Proxy-validation loss (JAX's ``make_eval_loss_step(model)``
    product): the same loss, deterministic (``eval()``: no dropout,
    batchnorm on its running stats), no state change."""
    model = state.model.eval()
    with torch.no_grad():
        return _loss(model, batch)
