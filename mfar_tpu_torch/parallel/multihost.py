"""Multi-process runtime bootstrap: one process per card over
``torch.distributed``.

Counterpart of ``mfar_tpu/parallel/multihost.py``.  JAX runs one process
per host, each owning its local chips; the port runs one process per card
(a rank), each owning one card.  The operating model is JAX's:

- every rank computes the SAME host-side batches (the data pipeline is
  deterministic under its seeds), places only its own rows of a sharded
  corpus, and takes part in the same collectives in the same order;
- merged results (top-k lists, candidate scores, embeddings) are gathered
  to every rank, so every rank can fetch them and reach the same decisions;
- only rank 0 does file I/O (qres, metrics, encoded corpora).

:func:`maybe_initialize` starts the process group from the launcher's
environment.  The backend is ``nccl`` for a ``cuda`` device and ``gloo``
for ``cpu``, unless ``MFAR_BACKEND`` names one (``gloo`` lets several ranks
share one card, where NCCL refuses them); a rank's card is
``cuda:LOCAL_RANK`` (or the rank modulo the visible cards), made current
before the group exists.  Host-side control
(barriers, the serving daemon's messages) runs over a gloo group of its own
(:func:`control_group`), so it never waits on the card's stream.

Once the group starts, :func:`shutdown` is registered to run at exit, as
JAX registers ``distributed.shutdown()`` (``jax/_src/api.py:3170-3177``):
it first runs the hooks of :func:`before_shutdown` (the serving daemon's
heartbeat thread stops there), then destroys the gloo control group and
the world, so no rank exits with the backend's threads still running.
"""

from __future__ import annotations

import atexit
import datetime
import os
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

# A lost rank fails the run after this long instead of hanging it (the
# serving daemon's heartbeat keeps an idle deployment's collectives well
# inside it).
TIMEOUT = datetime.timedelta(seconds=600)

_control = None  # (world, its gloo group for host-side control): see control_group
_hooks: List[Callable[[], None]] = []  # run by shutdown before the groups go
_registered = False  # shutdown is registered with atexit


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def maybe_initialize(mode: str = "auto", device: str = "cuda") -> bool:
    """Start the process group when the environment calls for it.  Returns
    True when running over several processes after the call.

    mode: ``auto`` (default) starts only on the explicit triple
    ``MFAR_COORDINATOR`` (host:port of rank 0, or an init-method URL such as
    ``file:///shared/path``), ``MFAR_NUM_PROCESSES`` and
    ``MFAR_PROCESS_ID``; ``force`` is ``auto`` that exits when the triple is
    absent; ``pod`` reads the launcher's environment (``torchrun``'s
    ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT`` and
    ``LOCAL_RANK``); ``off`` never starts one."""
    if mode == "off" or dist.is_initialized():
        return is_multiprocess()
    if mode == "pod":
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
                   if k not in os.environ]
        if missing:
            raise SystemExit(f"--multihost pod reads torchrun's environment; {missing} "
                             f"are not set (start the command under torchrun)")
        init_method, world, rank = "env://", _env_int("WORLD_SIZE"), _env_int("RANK")
        local = _env_int("LOCAL_RANK")
    else:
        coord = os.environ.get("MFAR_COORDINATOR")
        nproc, pid = _env_int("MFAR_NUM_PROCESSES"), _env_int("MFAR_PROCESS_ID")
        if not (coord and nproc is not None and pid is not None):
            if mode == "force":
                raise SystemExit(
                    "--multihost force requires MFAR_COORDINATOR, MFAR_NUM_PROCESSES "
                    "and MFAR_PROCESS_ID in the environment"
                )
            return False
        # host:port of rank 0, or an init-method URL (file:///shared/path)
        init_method = coord if "://" in coord else f"tcp://{coord}"
        world, rank, local = nproc, pid, _env_int("LOCAL_RANK")
    cuda = torch.device(device).type == "cuda"
    if cuda:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass --device cpu to run the "
                               "ranks on the host explicitly")
        torch.cuda.set_device(rank % torch.cuda.device_count() if local is None else local)
    backend = os.environ.get("MFAR_BACKEND") or ("nccl" if cuda else "gloo")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank, timeout=TIMEOUT)
    control_group()
    global _registered
    if not _registered:
        atexit.register(shutdown)
        _registered = True
    return is_multiprocess()


def before_shutdown(hook: Callable[[], None]) -> None:
    """Run ``hook`` in :func:`shutdown` before the groups are destroyed
    (last registered, first run): a thread that issues collectives stops
    there.  :func:`drop_shutdown_hook` takes it back."""
    _hooks.append(hook)


def drop_shutdown_hook(hook: Callable[[], None]) -> None:
    if hook in _hooks:
        _hooks.remove(hook)


def shutdown() -> None:
    """Stop what :func:`before_shutdown` registered, then destroy the gloo
    control group and the world (a no-op without a process group).  Runs at
    exit once :func:`maybe_initialize` has started a group."""
    global _control
    while _hooks:
        _hooks.pop()()
    if not dist.is_initialized():
        return
    if _control is not None and _control[0] is dist.group.WORLD:
        dist.destroy_process_group(_control[1])
    _control = None
    dist.destroy_process_group()


def control_group():
    """The gloo group over every rank for host-side control messages and
    barriers: the world itself under gloo, else one made once (every rank
    reaches this at the same point: just after the group starts, and in
    ``make_mesh``)."""
    global _control
    if dist.get_backend() == "gloo":
        return None  # the default group
    if _control is None or _control[0] is not dist.group.WORLD:  # a new world
        _control = (dist.group.WORLD, dist.new_group(backend="gloo", timeout=TIMEOUT))
    return _control[1]


def is_multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def is_primary() -> bool:
    """True on the rank that owns file I/O (qres, metrics, encoded corpora)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def sync(name: str = "mfar", group=None) -> None:
    """Barrier across the ranks (of ``group``, a host group such as a
    mesh's ``control``; default every rank), on the host (no-op in one
    process).  ``name`` labels the barrier in a timeout's error."""
    if is_multiprocess():
        try:
            dist.barrier(group=control_group() if group is None else group)
        except RuntimeError as e:
            raise RuntimeError(f"barrier {name!r} failed: {e}") from e
