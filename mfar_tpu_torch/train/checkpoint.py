"""Checkpoint / resume in a torch format: the counterpart of
``mfar_tpu/train/checkpoint.py`` (which writes orbax checkpoints).

Layout under ``out_dir``, as the JAX package's:

    checkpoints/<step>/state.pt    model (parameters and batchnorm stats),
                                   optimizer, step and generator state
    checkpoints/<step>/meta.json   field schema, trainer config, metrics and
                                   the generator kind
    best.txt                       the best step's directory

Over several ranks only rank 0 writes (the trainer calls :meth:`save` there)
and only rank 0 reads: :meth:`CheckpointManager.read` gives the payload that
``Trainer.restore_broadcast`` sends to every rank.  A model sharded over
the mesh's ``model`` axis is saved in the ``n_model`` 1 layout
(:func:`state_payload` joins the shards on every rank of the model group,
then rank 0 writes), and :func:`apply_payload` takes this rank's slices of
a payload into a sharded state, so a checkpoint written at any ``n_model``
resumes at any other.

Checkpoints are ranked by the monitored metric (``valid_loss`` by default,
lower is better; quality metrics rank higher-is-better); the best
``max_to_keep`` stay, with the latest, and ``best.txt`` names the best.  The
full optimizer, batchnorm and generator state is saved, so a resumed run
continues exactly.  The JAX package's orbax checkpoints do not load here
(orbax imports JAX): ``tools/jax_checkpoint_to_torch.py``, outside the
package, converts one into this layout (without the optimizer state).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional

import torch

from mfar_tpu_torch.data.types import Field
from mfar_tpu_torch.parallel import tensor_parallel

GENERATOR_KIND = "torch.Generator (CPU, mt19937)"


class CheckpointManager:
    @staticmethod
    def monitor_mode(monitor: str) -> str:
        """'min' for loss-like monitors, 'max' for quality metrics."""
        return "min" if "loss" in monitor else "max"

    def __init__(
        self,
        out_dir: str,
        max_to_keep: int = 100,
        monitor: str = "valid_loss",
        mode: str = "min",
    ):
        self.out_dir = os.path.abspath(out_dir)
        self.ckpt_dir = os.path.join(self.out_dir, "checkpoints")
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.monitor = monitor
        self.mode = mode

    # ------------------------------------------------------------------

    def save(
        self,
        step: int,
        state,  # TrainState, or its state_payload
        metrics: Dict[str, float],
        field_info: Optional[Dict[str, Field]] = None,
        config: Optional[Dict[str, Any]] = None,
    ) -> None:
        step_dir = self._step_dir(step)
        os.makedirs(step_dir, exist_ok=True)
        payload = state if isinstance(state, dict) else state_payload(state)
        tmp = os.path.join(step_dir, "state.pt.tmp")
        torch.save(payload, tmp)
        os.replace(tmp, os.path.join(step_dir, "state.pt"))
        sidecar = {
            "field_info": {k: f.serialize() for k, f in (field_info or {}).items()},
            "config": config or {},
            "metrics": {k: float(v) for k, v in metrics.items()},
            # the kind of generator whose state state.pt holds (the JAX
            # package records its PRNG implementation here)
            "generator": GENERATOR_KIND,
        }
        with open(os.path.join(step_dir, "meta.json"), "w") as f:
            json.dump(sidecar, f, indent=2)
        self._prune()
        self.write_best_txt()

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.ckpt_dir, str(step))

    def steps(self) -> List[int]:
        """Saved steps, in order (a step counts once its meta.json exists)."""
        return sorted(
            int(d) for d in os.listdir(self.ckpt_dir)
            if d.isdigit() and os.path.exists(os.path.join(self.ckpt_dir, d, "meta.json"))
        )

    def _rank_key(self, step: int) -> float:
        """Smaller is better; a checkpoint without the monitor ranks last."""
        value = self.restore_meta(step).get("metrics", {}).get(self.monitor)
        if value is None:
            return float("inf")
        return value if self.mode == "min" else -value

    def _prune(self) -> None:
        steps = self.steps()
        keep = set(sorted(steps, key=self._rank_key)[: self.max_to_keep])
        keep.add(steps[-1])
        for step in steps:
            if step not in keep:
                shutil.rmtree(self._step_dir(step))

    def best_step(self) -> Optional[int]:
        steps = self.steps()
        return min(steps, key=self._rank_key) if steps else None

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def write_best_txt(self) -> None:
        """Persist the best checkpoint path (the reference's handoff file to
        mask_fields)."""
        best = self.best_step()
        if best is not None:
            with open(os.path.join(self.out_dir, "best.txt"), "w") as f:
                f.write(self._step_dir(best))

    # ------------------------------------------------------------------

    def read(self, step: Optional[int]) -> Dict[str, Any]:
        """A saved step's payload (the latest when None), on the host: the
        model's and optimizer's state_dicts, step and generator state.
        Over several ranks rank 0 reads it and broadcasts it
        (``Trainer.restore_broadcast``)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint to restore under {self.ckpt_dir}")
        return _load(self._step_dir(step))

    def restore(self, step: Optional[int], state):
        """Load a saved step (the latest when None) into ``state`` in
        place -- model, optimizer, step and generator -- and return it."""
        return apply_payload(state, self.read(step))

    def restore_meta(self, step: Optional[int] = None) -> Dict[str, Any]:
        if step is None:
            step = self.best_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.out_dir}")
        with open(os.path.join(self._step_dir(step), "meta.json")) as f:
            return json.load(f)


def _load(step_dir: str) -> Dict[str, Any]:
    # to the host: load_state_dict moves parameters and moments to the
    # model's device, and the optimizer keeps its step counts on the host
    return torch.load(os.path.join(step_dir, "state.pt"), map_location="cpu", weights_only=True)


def state_payload(state) -> Dict[str, Any]:
    """What a checkpoint holds: the model's and the optimizer's state_dicts
    (in the ``n_model`` 1 layout: a collective over the model group when the
    model is sharded), the step and the generator state."""
    model_sd, optimizer_sd = state.model.state_dict(), state.optimizer.state_dict()
    if tensor_parallel.is_sharded(state.model):
        model_sd, optimizer_sd = tensor_parallel.gather_state_dict(
            state.model, state.optimizer, state.model.model_mesh)
    return {"model": model_sd, "optimizer": optimizer_sd, "step": int(state.step),
            "generator": state.generator.get_state()}


def apply_payload(state, payload: Dict[str, Any]):
    """A checkpoint's payload into ``state`` in place (this rank's slices
    of it when the model is sharded); returns ``state``."""
    if "optimizer" not in payload:
        raise ValueError("this checkpoint holds no optimizer state (one converted from a JAX "
                         "orbax checkpoint): it serves, and does not resume training")
    model_sd, optimizer_sd = payload["model"], payload["optimizer"]
    if tensor_parallel.is_sharded(state.model):
        model_sd, optimizer_sd = tensor_parallel.shard_state_dict(
            state.model, state.optimizer, state.model.model_mesh, model_sd, optimizer_sd)
    state.model.load_state_dict(model_sd)
    state.optimizer.load_state_dict(optimizer_sd)
    state.step = int(payload["step"])
    state.generator.set_state(payload["generator"])
    return state


def load_model_state(step_dir: str) -> Dict[str, torch.Tensor]:
    """The model state_dict of a saved step, on the CPU (for serving: the
    encoder's ``encoder.*`` and the mixer's ``mixer.weight``)."""
    return _load(step_dir)["model"]


def check_field_compatibility(step_dir: str, field_info: Dict[str, Field]) -> None:
    """Fail fast with a readable message when the CLI's field selection does
    not match what the checkpoint was trained with (the mixer's field axis
    is positional)."""
    meta_path = os.path.join(step_dir, "meta.json")
    if not os.path.exists(meta_path):
        return
    with open(meta_path) as f:
        meta = json.load(f)
    trained = list(meta.get("field_info", {}).keys())
    requested = list(field_info.keys())
    if trained and trained != requested:
        raise ValueError(
            f"field selection mismatch: checkpoint {step_dir} was trained with "
            f"fields {trained}, but --field-names resolved to {requested}"
        )


def read_best_dir(out_dir: str) -> str:
    """Resolve the best checkpoint directory from best.txt."""
    with open(os.path.join(out_dir, "best.txt")) as f:
        return f.read().strip()


def fields_from_meta(meta: Dict[str, Any]) -> Dict[str, Field]:
    return {k: Field.deserialize(d) for k, d in meta.get("field_info", {}).items()}
