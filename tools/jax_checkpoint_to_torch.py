"""Convert a JAX ``train`` run's orbax checkpoint into the PyTorch port's
checkpoint layout.

    python -m tools.jax_checkpoint_to_torch --checkpoint-dir JAX_RUN --out PORT_RUN [--step N]

``JAX_RUN`` is the ``--out`` of ``python -m mfar_tpu.commands.train`` (at any
``--n-model``: the JAX trainer checkpoints sharded leaves whole).  The tool
restores the best step (``--step``: another) on one device of this host,
converts its ``params`` and ``batch_stats`` with
``mfar_tpu_torch.models.convert.model_state_from_jax`` (a BERT or a T5
encoder, the mixer, the batchnorm) and writes the port's
``checkpoints/<step>/state.pt`` + ``meta.json`` (the JAX run's field schema,
config and metrics) + ``best.txt`` under ``PORT_RUN``.  The result serves
``python -m mfar_tpu_torch.commands.retrieve --checkpoint-dir PORT_RUN``,
``serve`` and ``mask_fields`` with the ``--model-name`` the JAX run trained.

The optimizer state is not carried over: optax's moment trees have no
counterpart in a torch optimizer's, so the result does not resume training
(``--resume`` stops on the missing optimizer state).  The tool imports JAX
and orbax, and so it lives outside ``mfar_tpu_torch``, which never imports
it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

if __package__ in (None, ""):  # run as a script: the repo root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GENERATOR = "none: converted from a JAX orbax checkpoint without its optimizer state"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0],
                                epilog="The optimizer state is not converted: the output "
                                       "serves retrieve, serve and mask_fields and does not "
                                       "resume training.")
    p.add_argument("--checkpoint-dir", required=True, help="a JAX train run's --out")
    p.add_argument("--out", required=True, help="the port run directory to write")
    p.add_argument("--step", type=int, default=None, help="the step to convert (default: best)")
    return p


def restore_arrays(checkpoint_dir: str, step: int):
    """The saved ``params`` and ``batch_stats`` of ``step`` as numpy trees,
    restored on one device whatever mesh wrote them (the saved tree is its
    own template)."""
    import jax
    import numpy as np
    import orbax.checkpoint as ocp

    manager = ocp.CheckpointManager(
        os.path.join(os.path.abspath(checkpoint_dir), "checkpoints"),
        options=ocp.CheckpointManagerOptions(read_only=True))
    one = jax.sharding.SingleDeviceSharding(jax.devices()[0])
    state = manager.restore(step, args=ocp.args.Composite(
        state=ocp.args.StandardRestore(fallback_sharding=one)))["state"]
    manager.close()
    return (jax.tree.map(np.asarray, state["params"]),
            jax.tree.map(np.asarray, state["batch_stats"]))


def convert(checkpoint_dir: str, out: str, step=None) -> str:
    """Write ``out``'s port checkpoint of the JAX run's best (or ``step``)
    checkpoint; returns the step directory written."""
    import torch

    from mfar_tpu.train.checkpoint import CheckpointManager
    from mfar_tpu_torch.models.convert import model_state_from_jax

    if not os.path.isdir(os.path.join(checkpoint_dir, "checkpoints")):
        raise SystemExit(f"{checkpoint_dir} holds no checkpoints/ directory")
    jax_ckpt = CheckpointManager(checkpoint_dir)
    step = jax_ckpt.best_step() if step is None else step
    if step is None:
        raise SystemExit(f"no checkpoint under {checkpoint_dir}")
    meta = jax_ckpt.restore_meta(step)
    jax_ckpt.close()
    params, batch_stats = restore_arrays(checkpoint_dir, step)
    model = model_state_from_jax(params, batch_stats or None)
    step_dir = os.path.join(os.path.abspath(out), "checkpoints", str(step))
    os.makedirs(step_dir, exist_ok=True)
    torch.save({"model": model, "step": int(step)}, os.path.join(step_dir, "state.pt"))
    with open(os.path.join(step_dir, "meta.json"), "w") as f:
        json.dump({"field_info": meta.get("field_info", {}), "config": meta.get("config", {}),
                   "metrics": meta.get("metrics", {}), "generator": GENERATOR,
                   "converted_from": os.path.abspath(checkpoint_dir)}, f, indent=2)
    with open(os.path.join(os.path.abspath(out), "best.txt"), "w") as f:
        f.write(step_dir)
    return step_dir


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    step_dir = convert(args.checkpoint_dir, args.out, args.step)
    print(f"[convert] {args.checkpoint_dir} -> {step_dir} (model only; no optimizer state)")


if __name__ == "__main__":
    main()
