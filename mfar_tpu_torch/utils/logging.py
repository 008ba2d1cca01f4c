"""Structured metrics logging: JSONL, optional wandb/mlflow.

The port's copy of ``mfar_tpu/utils/logging.py``: the always-on backend is
a JSONL file (``metrics.jsonl``, machine-readable run history); wandb and
mlflow attach when their packages import and start, and are skipped with a
notice otherwise, as in the JAX package.  Over several processes only rank
0 writes; the other ranks keep a logger that does nothing, so call sites
stay the same.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

from mfar_tpu_torch.parallel import multihost


class MetricsLogger:
    def __init__(
        self,
        out_dir: str,
        backend: Optional[str] = None,
        run_name: Optional[str] = None,
        wandb_name: Optional[str] = None,  # run display name (reference:
        #                                    mfar/commands/train.py:74-80)
        wandb_dir: Optional[str] = None,  # wandb local artifact dir
    ):
        self.enabled = multihost.is_primary()
        self._f = self.backend = None
        if not self.enabled:
            return
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, "metrics.jsonl")
        self._f = open(self.path, "a")
        self.backend = None
        if backend == "wandb":
            try:
                import wandb

                wandb.init(project=run_name or "mfar_tpu", name=wandb_name,
                           dir=wandb_dir)
                self.backend = ("wandb", wandb)
            except Exception as e:  # noqa: BLE001 -- not installed, not
                # logged in, offline, ...: the backend is an attachment,
                # never a reason to kill training at startup
                print(f"[logging] wandb unavailable ({type(e).__name__}: "
                      f"{e}); using JSONL only")
        elif backend in ("mlflow", "mlflow_local"):
            try:
                import mlflow

                mlflow.start_run(run_name=run_name)
                self.backend = ("mlflow", mlflow)
            except Exception as e:  # noqa: BLE001 -- see the wandb branch
                print(f"[logging] mlflow unavailable ({type(e).__name__}: "
                      f"{e}); using JSONL only")

    def log_hyperparams(self, params: Dict[str, Any]) -> None:
        if not self.enabled:
            return
        flat = {k: v for k, v in params.items() if not isinstance(v, dict)}
        self._write({"event": "hyperparams", **flat})
        if self.backend:
            name, mod = self.backend
            if name == "wandb":
                mod.config.update(flat, allow_val_change=True)
            else:
                mod.log_params({k: str(v) for k, v in flat.items()})

    def log(self, metrics: Dict[str, float], step: int, prefix: str = "") -> None:
        if not self.enabled:
            return
        record = {f"{prefix}{k}": _to_float(v) for k, v in metrics.items()}
        self._write({"event": "metrics", "step": step, **record})
        if self.backend:
            name, mod = self.backend
            if name == "wandb":
                mod.log(record, step=step)
            else:
                mod.log_metrics(record, step=step)

    def _write(self, record: Dict[str, Any]) -> None:
        record["time"] = round(time.time(), 3)
        self._f.write(json.dumps(record) + "\n")
        self._f.flush()

    def close(self) -> None:
        if not self.enabled:
            return
        self._f.close()
        if self.backend and self.backend[0] == "mlflow":
            self.backend[1].end_run()


def _to_float(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)
