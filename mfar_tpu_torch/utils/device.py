"""Device resolution and capacity for the PyTorch port.

Counterpart of ``mfar_tpu/utils/device.py``.  The port runs on a CUDA card
unless the caller asks for the CPU: :func:`resolve_device` defaults to
``cuda`` and raises when no card is visible, so no entry point carries on
silently on the host.  ``device="cpu"`` is an explicit choice (the CPU tests
make it).
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device without a visible card raises.
    ``cuda`` without an index resolves to the current card, so that a rank's
    tensors stay on its own card in every thread (the current card is a
    thread's own, and a new thread starts on card 0)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "host explicitly"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (cuda or cpu)")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def device_memory_bytes(device: DeviceLike = None) -> int:
    """Total memory of one CUDA device, in bytes (``cudaMemGetInfo``)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("device_memory_bytes reads a CUDA device's memory")
    _free, total = torch.cuda.mem_get_info(dev)
    return int(total)
