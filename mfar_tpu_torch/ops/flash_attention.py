"""Kernel K2, the encoder's flash-attention forward with segment masking.

    out[b, h, i] = softmax_j(q[b, h, i] . k[b, h, j] * sm_scale
                             + (0 if seg[b, i] == seg[b, j] else MASK_VALUE)) @ v[b, h]

in the layout of JAX's Pallas ``flash_attention``: q/k/v/out ``[B, H, S, D]``,
segment ids ``[B, S]`` (the encoder passes 1 for valid tokens and 0 for pad,
so valid tokens attend only valid ones and pads only pads).

:func:`flash_attention` launches the hand-written CUDA kernel
``mfar_tpu_torch/csrc/flash_attention.cu`` for tensors on the card; it
replaces the call of JAX's library Pallas kernel at
``mfar_tpu/models/encoder.py:170``.  :func:`flash_attention_plain` is the same
function in plain PyTorch (the function of JAX's ``mha_reference``, in f32):
the wrapper uses it for CPU tensors only, and the tests and ``chip_smoke.py``
hold the kernel against it.

The kernel takes bf16 with D = 64 and S a multiple of 128.  It reads q/k/v
through their strides, so the ``[B, S, H, D] -> [B, H, S, D]`` transposed
views of the encoder's projections need no copy, and it writes into an
output laid out as ``[B, S, H, D]``, so the transpose back to
``[B, S, H*D]`` is free too.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mfar_tpu_torch.ops import _build

# JAX's DEFAULT_MASK_VALUE (flash_attention.py:29): finite, so a row whose
# first key tile is wholly masked is washed out by the later rescale
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
HEAD_DIM = 64  # the kernel's head dimension
SEQ_MULTIPLE = 128  # S % 128 == 0, as JAX's gate asks


def flash_attention_plain(
    q: torch.Tensor,  # [B, H, S, D]
    k: torch.Tensor,  # [B, H, S, D]
    v: torch.Tensor,  # [B, H, S, D]
    segment_ids: torch.Tensor,  # [B, S] integer
    sm_scale: float,
) -> torch.Tensor:  # [B, H, S, D] in q's dtype
    """Logits, the additive segment mask and the softmax in f32, then
    ``@ v`` in f32 and a cast to q's dtype."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    same = segment_ids[:, None, :, None] == segment_ids[:, None, None, :]  # [B, 1, S, S]
    logits = logits + torch.where(same, 0.0, MASK_VALUE)
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs, v.float()).to(q.dtype)


@functools.cache
def _kernel():
    fn = _build.load("flash_attention").mfar_flash_attention_fwd
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q k v seg
        ctypes.c_void_p,  # out
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B H S
        ctypes.POINTER(ctypes.c_longlong),  # 12 strides: (b, h, s) of q, k, v, out
        ctypes.c_float, ctypes.c_void_p,  # sm_scale, stream
    ]
    fn.restype = ctypes.c_int
    return fn


def flash_attention(
    q: torch.Tensor,  # [B, H, S, 64] bf16 on the card; last dim contiguous
    k: torch.Tensor,  # [B, H, S, 64]
    v: torch.Tensor,  # [B, H, S, 64]
    segment_ids: torch.Tensor,  # [B, S] int32, contiguous
    sm_scale: float,
) -> torch.Tensor:  # [B, H, S, 64] in q's dtype
    """Segment-masked attention: kernel K2 for CUDA tensors, the plain
    version for CPU tensors.  Raises on anything the kernel does not take.

    On the card the result is a ``[B, H, S, D]`` view of a ``[B, S, H, D]``
    buffer, so ``out.transpose(1, 2).reshape(B, S, H * D)`` is a view."""
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            f"want q, k, v of one shape [B, H, S, D]; got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, h, s, d = q.shape
    if segment_ids.shape != (b, s):
        raise ValueError(f"segment_ids {tuple(segment_ids.shape)} != (B, S) = {(b, s)}")
    if d != HEAD_DIM:
        raise ValueError(f"head dim D={d}: the flash kernel takes D={HEAD_DIM}")
    if s < SEQ_MULTIPLE or s % SEQ_MULTIPLE:
        raise ValueError(f"S={s} must be a positive multiple of {SEQ_MULTIPLE}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if segment_ids.dtype != torch.int32:
        raise TypeError(f"segment_ids must be int32, got {segment_ids.dtype}")
    devices = {q.device, k.device, v.device, segment_ids.device}
    if len(devices) != 1:
        raise ValueError(f"q, k, v and segment_ids lie on different devices: {devices}")

    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, segment_ids, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype != torch.bfloat16:
        raise TypeError(
            f"{q.dtype} q/k/v: kernel K2 takes bf16 on the card; an f32 K2 "
            f"waits for training (ROADMAP B2b)"
        )
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1 or any(st % 8 for st in t.stride()[:3]):
            raise ValueError(
                f"{name} strides {t.stride()}: D must be contiguous and the B, H, S "
                f"strides multiples of 8 elements (16-byte rows)"
            )
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    if not segment_ids.is_contiguous() or segment_ids.data_ptr() % 16:
        raise ValueError("segment_ids must be contiguous and start on a 16-byte boundary")

    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(
        *(st for t in (q, k, v, out) for st in t.stride()[:3])
    )
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), segment_ids.data_ptr(), out.data_ptr(),
            b, h, s, strides, sm_scale, stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out


# launches of the CUDA kernel (CPU calls of the plain version do not count)
flash_attention.launches = 0
