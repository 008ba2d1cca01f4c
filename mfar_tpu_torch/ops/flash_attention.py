"""Kernel K2, the encoder's flash attention with segment masking, and its
backward K2b.

    out[b, h, i] = softmax_j(q[b, h, i] . k[b, h, j] * sm_scale
                             + (0 if seg[b, i] == seg[b, j] else MASK_VALUE)) @ v[b, h]

in the layout of JAX's Pallas ``flash_attention``: q/k/v/out ``[B, H, S, D]``,
segment ids ``[B, S]`` (the encoder passes 1 for valid tokens and 0 for pad,
so valid tokens attend only valid ones and pads only pads).

:func:`flash_attention` launches the hand-written CUDA kernel
``mfar_tpu_torch/csrc/flash_attention.cu`` for tensors on the card (wgmma,
TMA and a producer warpgroup; key tiles whose segment ids miss a block's
rows are skipped); it replaces the call of JAX's library Pallas kernel at
``mfar_tpu/models/encoder.py:170``.  When grad is enabled and an input
requires it, the call goes through a ``torch.autograd.Function`` whose
forward also writes each row's logsumexp and whose backward runs the two
kernels of K2b, which replace the Pallas kernels of JAX's VJP: first dq,
which also computes the row dots ``di = sum_d o * dO`` (JAX computes them
outside Pallas) and writes them out, then dkv, which reads them.
:func:`flash_attention_plain` and :func:`flash_attention_bwd_plain` are the
same functions in plain PyTorch, in f32: the wrappers use them for CPU
tensors only, and the tests and ``chip_smoke.py`` hold the kernels against
them.

Four routes on the card for the forward, chosen before any launch by
:func:`forward_route` from dtype, head dim and strides alone, each counting
its own launches:

- ``"wgmma"``, bf16 with D = 64 (Contriever-base, BERT-base): the wgmma
  kernel above (``flash_attention.launches``).
- ``"wgmma_headdim"``, bf16 at any other D that TMA can read (a multiple of
  8 up to 256: all-MiniLM-L6-v2's 32, ``EncoderConfig.tiny`` at bf16): the
  same kernel at ceil(D / 64) slabs of 64 columns
  (:func:`flash_attention_headdim`).
- ``"tf32"``, f32 that TMA can read (D a multiple of 4: ``EncoderConfig.tiny``,
  the synthetic models, ``--precision 32``):
  ``csrc/flash_attention_tf32.cu`` (:func:`flash_attention_tf32`), on the
  tensor cores in 3xTF32: each f32 operand split into two TF32 parts and
  each product taken as three TF32 products summed in f32, which keeps f32
  accuracy where one TF32 product would not.
- ``"simt"``, everything else up to D = 256 (bf16 at a D that is not a
  multiple of 8, f32 at a D that is not a multiple of 4, strides that are
  not multiples of 16 bytes): ``csrc/flash_attention_simt.cu``'s CUDA-core
  forward (:func:`flash_attention_simt`), in f32 FMA.

The backward's pair follows the same rule, chosen by :func:`backward_route`,
each pair counting its own launches:

- ``"wgmma"``, bf16 with D = 64: the wgmma pair of
  ``csrc/flash_attention_bwd.cu`` (``flash_attention_bwd_dq`` / ``_dkv``).
- ``"wgmma_headdim"``, bf16 at any other D that TMA can read up to 128: the
  same pair at ceil(D / 64) slabs of 64 columns
  (:func:`flash_attention_bwd_headdim_dq` / ``_dkv``).
- ``"tf32"``, f32 that TMA can read at D up to 64:
  ``csrc/flash_attention_tf32_bwd.cu`` (:func:`flash_attention_tf32_bwd_dq`
  / ``_dkv``), every product in 3xTF32 and P, dS kept in f32.
- ``"wgmma_pad"``, bf16 that TMA cannot read at D up to 128 (a D that is not
  a multiple of 8, such as TinyBERT-4L-312D's 26, whose 52-byte rows no
  tensor map describes, or strides that are not multiples of 16 bytes):
  q, k, v, o and dO copied into zero-padded ``[B, S, H, D8]`` buffers (D8
  = D rounded up to 8), which TMA reads, then the pair of their route
  (``"wgmma"`` or ``"wgmma_headdim"``, whose launches count), the
  gradients handed back as views of their first D columns.  The padded
  columns of q, k, v and dO are 0, so S and dP are exact and the
  gradients' padded columns 0.
- ``"tf32_pad"``, f32 that TMA cannot read at D up to 64 (a D that is not a
  multiple of 4, such as TinyBERT-4L-312D's 26, whose 104-byte rows no
  tensor map describes, or strides that are not multiples of 16 bytes, or
  a base off a 16-byte boundary): the same copies at D rounded up to 4,
  then the 3xTF32 pair (``"tf32"``, whose launches count), the gradients
  views of their first D columns.  A zero column splits into two zero
  TF32 parts, so S and dP stay exact here too.
- ``"simt"``, everything else up to D = 256 (the head dims past those caps:
  rows of more than 256 bytes, whose own tiles and accumulators would not
  fit one block an SM):
  ``csrc/flash_attention_simt.cu``'s CUDA-core pair
  (:func:`flash_attention_simt_bwd_dq`, :func:`flash_attention_simt_bwd_dkv`),
  in f32 FMA.

Every pair reads the forward's logsumexp, a contiguous f32 ``[B, H, S]`` in
natural log, whichever forward wrote it.  These kernels read q/k/v through
their strides, so the ``[B, S, H, D] -> [B, H, S, D]`` transposed views of
the encoder's projections need no copy, and write outputs laid out as
``[B, S, H, D]``, so the way back to ``[B, S, H*D]`` is free too.

All take S a multiple of 128 (JAX's gate).  D above 256 raises on every
device.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from mfar_tpu_torch.ops import _build

# JAX's DEFAULT_MASK_VALUE (flash_attention.py:29), which the plain version
# adds as JAX does; the kernels set every cross-segment weight to exactly 0
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
HEAD_DIM = 64  # the head dimension of the "wgmma" route (the forward and the backward)
MAX_HEAD_DIM = 256  # every forward route's largest head dimension, and the CUDA-core backward's
# the tensor-core backwards' largest head dims: rows of up to 256 bytes (two
# bf16 slabs of 64 columns, two f32 slabs of 32), which keep each kernel's
# own tiles, its ring and its accumulators within one block an SM
WGMMA_BWD_MAX_HEAD_DIM, TF32_BWD_MAX_HEAD_DIM = 128, 64
SEQ_MULTIPLE = 128  # S % 128 == 0, as JAX's gate asks

Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _masked_logits(q, k, segment_ids, sm_scale) -> torch.Tensor:
    """f32 ``q . k * sm_scale`` plus JAX's additive segment mask."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    same = segment_ids[:, None, :, None] == segment_ids[:, None, None, :]  # [B, 1, S, S]
    return logits + torch.where(same, 0.0, MASK_VALUE)


def flash_attention_plain(
    q: torch.Tensor,  # [B, H, S, D]
    k: torch.Tensor,  # [B, H, S, D]
    v: torch.Tensor,  # [B, H, S, D]
    segment_ids: torch.Tensor,  # [B, S] integer
    sm_scale: float,
) -> torch.Tensor:  # [B, H, S, D] in q's dtype
    """Logits, the additive segment mask and the softmax in f32, then
    ``@ v`` in f32 and a cast to q's dtype."""
    probs = torch.softmax(_masked_logits(q, k, segment_ids, sm_scale), dim=-1)
    return torch.matmul(probs, v.float()).to(q.dtype)


def flash_attention_bwd_plain(
    q: torch.Tensor,  # [B, H, S, D]
    k: torch.Tensor,
    v: torch.Tensor,
    segment_ids: torch.Tensor,  # [B, S]
    o: torch.Tensor,  # [B, H, S, D] the forward's output
    lse: torch.Tensor,  # [B, H, S] f32 row logsumexp of the masked logits
    dout: torch.Tensor,  # [B, H, S, D] gradient of the output
    sm_scale: float,
) -> Grads:  # dq, dk, dv in q's dtype
    """The backward of :func:`flash_attention_plain` from the forward's row
    logsumexp, written out in f32 as the kernels compute it:
    ``P = exp(q.k * scale - lse)`` on same-segment pairs and 0 elsewhere,
    ``dv = P^T dO``, ``dS = P * (dO v^T - di) * scale`` with
    ``di = sum_d o * dO``, ``dq = dS k``, ``dk = dS^T q``."""
    qf, kf, vf, dof = (t.float() for t in (q, k, v, dout))
    logits = torch.matmul(qf, kf.transpose(-1, -2)) * sm_scale
    same = segment_ids[:, None, :, None] == segment_ids[:, None, None, :]
    p = torch.exp(torch.where(same, logits - lse.float()[..., None], float("-inf")))
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = p * (dp - _row_dots(o, dout)[..., None]) * sm_scale
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _row_dots(o: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """di = sum_d o * dO in f32, ``[B, H, S]`` contiguous: the plain
    backward's torch op (on the card kernel dq computes it)."""
    return (o.float() * dout.float()).sum(-1).contiguous()


def _check_inputs(q, k, v, segment_ids) -> None:
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            f"want q, k, v of one shape [B, H, S, D]; got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, h, s, d = q.shape
    if segment_ids.shape != (b, s):
        raise ValueError(f"segment_ids {tuple(segment_ids.shape)} != (B, S) = {(b, s)}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim D={d}: the flash kernels take 1 <= D <= {MAX_HEAD_DIM}")
    if s < SEQ_MULTIPLE or s % SEQ_MULTIPLE:
        raise ValueError(f"S={s} must be a positive multiple of {SEQ_MULTIPLE}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if segment_ids.dtype != torch.int32:
        raise TypeError(f"segment_ids must be int32, got {segment_ids.dtype}")
    devices = {q.device, k.device, v.device, segment_ids.device}
    if len(devices) != 1:
        raise ValueError(f"q, k, v and segment_ids lie on different devices: {devices}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    if q.device.type == "cuda":
        if q.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{q.dtype} q/k/v: the flash kernels take float32 and bfloat16")
        for name, t in (("q", q), ("k", k), ("v", v)):
            if not _simt_readable(t):
                raise ValueError(f"{name} strides {t.stride()}: the kernels need the D stride 1")
        if not segment_ids.is_contiguous() or segment_ids.data_ptr() % 16:
            raise ValueError("segment_ids must be contiguous and start on a 16-byte boundary")


def forward_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The forward's kernel for [B, H, S, D] q, k, v on the card, from their
    dtype, head dim and strides alone: ``"wgmma"`` (bf16, D = 64),
    ``"wgmma_headdim"`` (bf16 at another D, a multiple of 8), ``"tf32"``
    (f32, D a multiple of 4), each where TMA can read all three
    (:func:`_kernel_readable`); ``"simt"`` (the CUDA-core kernel) for the
    rest.  The backward's pair is :func:`backward_route`'s."""
    d = q.shape[-1]
    tma = all(_kernel_readable(t) for t in (q, k, v))
    if tma and q.dtype == torch.bfloat16 and d % 8 == 0:
        return "wgmma" if d == HEAD_DIM else "wgmma_headdim"
    if tma and q.dtype == torch.float32 and d % 4 == 0:
        return "tf32"
    return "simt"


def backward_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The backward's kernel pair for [B, H, S, D] q, k, v on the card, from
    their dtype, head dim and strides alone, each where TMA can read all
    three (:func:`_kernel_readable`): ``"wgmma"`` (bf16, D = 64),
    ``"wgmma_headdim"`` (bf16 at another D, a multiple of 8 up to 128: the
    same pair at ceil(D / 64) slabs), ``"tf32"`` (f32, D a multiple of 4 up
    to 64: the 3xTF32 pair); then, for what TMA cannot read, ``"wgmma_pad"``
    (bf16 up to D = 128) and ``"tf32_pad"`` (f32 up to D = 64), copied into
    zero-padded buffers that it reads, for the wgmma or the 3xTF32 pair;
    ``"simt"`` (the CUDA-core pair) for the head dims past those caps."""
    d = q.shape[-1]
    tma = all(_kernel_readable(t) for t in (q, k, v))
    bf16 = q.dtype == torch.bfloat16
    if bf16 and d <= WGMMA_BWD_MAX_HEAD_DIM:
        if tma and d % 8 == 0:
            return "wgmma" if d == HEAD_DIM else "wgmma_headdim"
        return "wgmma_pad"
    if q.dtype == torch.float32 and d <= TF32_BWD_MAX_HEAD_DIM:
        return "tf32" if tma and d % 4 == 0 else "tf32_pad"
    return "simt"


def _kernel_readable(t: torch.Tensor) -> bool:
    """A [B, H, S, D] operand that TMA reads through its strides: D
    contiguous, the B, H and S strides multiples of 16 bytes, from a
    16-byte boundary."""
    return t.stride(-1) == 1 and not any(st * t.element_size() % 16 for st in t.stride()[:3]) \
        and t.data_ptr() % 16 == 0


def _simt_readable(t: torch.Tensor) -> bool:
    """A [B, H, S, D] operand the CUDA-core kernels read through its strides."""
    return t.stride(-1) == 1


def _strides(*ts: torch.Tensor):
    return (ctypes.c_longlong * (3 * len(ts)))(*(st for t in ts for st in t.stride()[:3]))


def pad_heads(t: torch.Tensor, width: int) -> torch.Tensor:
    """A ``[B, H, S, width]`` view of a new ``[B, S, H, width]`` buffer that
    holds [B, H, S, D] ``t`` in its first D columns and 0 past them."""
    return torch.nn.functional.pad(t.transpose(1, 2), (0, width - t.shape[-1])).transpose(1, 2)


def _empty_bshd(like: torch.Tensor) -> torch.Tensor:
    """A ``[B, H, S, D]`` view of a new ``[B, S, H, D]`` buffer."""
    b, h, s, d = like.shape
    return torch.empty((b, s, h, d), dtype=like.dtype, device=like.device).transpose(1, 2)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def _forward_argtypes():
    return [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q k v seg
        ctypes.c_void_p, ctypes.c_void_p,  # out, lse (or null)
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B H S D
        ctypes.POINTER(ctypes.c_longlong),  # 12 strides: (b, h, s) of q, k, v, out
        ctypes.c_float, ctypes.c_void_p,  # sm_scale, stream
    ]


@functools.cache
def _kernel():
    fn = _build.load("flash_attention").mfar_flash_attention_fwd
    fn.argtypes = _forward_argtypes()
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _tf32_kernel():
    fn = _build.load("flash_attention_tf32").mfar_flash_attention_fwd_tf32
    fn.argtypes = _forward_argtypes()
    fn.restype = ctypes.c_int
    return fn


def _bind_bwd(lib_name: str, dq_name: str, dkv_name: str):
    """A tensor-core backward pair's (dq, dkv) entry points."""
    lib = _build.load(lib_name)
    tail = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B H S D
        ctypes.POINTER(ctypes.c_longlong),  # strides: q, k, v, dout, gradients (dq: then o)
        ctypes.c_float, ctypes.c_void_p,  # sm_scale, stream
    ]
    dq, dkv = getattr(lib, dq_name), getattr(lib, dkv_name)
    dq.argtypes = [ctypes.c_void_p] * 9 + tail  # q k v o dout seg lse, dq di
    dkv.argtypes = [ctypes.c_void_p] * 9 + tail  # q k v dout seg lse di, dk dv
    dq.restype = dkv.restype = ctypes.c_int
    return dq, dkv


@functools.cache
def _bwd_kernels():
    return _bind_bwd("flash_attention_bwd", "mfar_flash_attention_bwd_dq",
                     "mfar_flash_attention_bwd_dkv")


@functools.cache
def _tf32_bwd_kernels():
    return _bind_bwd("flash_attention_tf32_bwd", "mfar_flash_attention_bwd_dq_tf32",
                     "mfar_flash_attention_bwd_dkv_tf32")


@functools.cache
def _simt_kernels():
    lib = _build.load("flash_attention_simt")
    tail = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B H S D
        ctypes.POINTER(ctypes.c_longlong),  # strides of the operands, in argument order
        ctypes.c_float, ctypes.c_void_p,  # sm_scale, stream
    ]
    fwd = lib.mfar_flash_simt_fwd
    dq, dkv = lib.mfar_flash_simt_bwd_dq, lib.mfar_flash_simt_bwd_dkv
    fwd.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 + tail  # bf16, q k v seg, out lse
    dq.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 9 + tail  # q k v o dout seg lse, dq di
    dkv.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 9 + tail  # q k v dout seg lse di, dk dv
    fwd.restype = dq.restype = dkv.restype = ctypes.c_int
    return fwd, dq, dkv


def _launch_forward(q, k, v, segment_ids, sm_scale, lse=None) -> torch.Tensor:
    """K2 on checked CUDA inputs, by :func:`forward_route`; with ``lse`` (a
    contiguous f32 [B, H, S]) it also writes each row's logsumexp there."""
    return _FORWARDS[forward_route(q, k, v)](q, k, v, segment_ids, sm_scale, lse)


def _wgmma_forward(q, k, v, segment_ids, sm_scale, lse=None) -> torch.Tensor:
    """K2's wgmma kernel at D = 64, counted as :func:`flash_attention`'s."""
    out = _tensor_core_forward(_kernel(), "flash_attention", q, k, v, segment_ids, sm_scale, lse)
    flash_attention.launches += 1
    return out


def _tensor_core_forward(kernel, what, q, k, v, segment_ids, sm_scale, lse) -> torch.Tensor:
    """One launch of a TMA-fed forward (the wgmma or the 3xTF32 kernel) on
    checked CUDA inputs: the output as a ``[B, H, S, D]`` view of a ``[B, S,
    H, D]`` buffer."""
    if lse is not None:
        _check_rows(lse=lse)
    _check_readable(q=q, k=k, v=v)
    b, h, s, d = q.shape
    out = _empty_bshd(q)
    with torch.cuda.device(q.device):
        err = kernel(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), segment_ids.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), b, h, s, d, _strides(q, k, v, out),
            sm_scale, _stream(q),
        )
    _raise_on(err, what)
    return out


def flash_attention_headdim(q, k, v, segment_ids, sm_scale, lse=None) -> torch.Tensor:
    """K2's wgmma kernel at a head dim other than 64 (bf16, D a multiple of
    8 up to 256, operands TMA reads) on checked CUDA inputs: the output as
    a ``[B, H, S, D]`` view of a ``[B, S, H, D]`` buffer; with ``lse`` (a
    contiguous f32 [B, H, S]) it also writes each row's logsumexp there."""
    out = _tensor_core_forward(_kernel(), "flash_attention_headdim", q, k, v, segment_ids,
                               sm_scale, lse)
    flash_attention_headdim.launches += 1
    return out


def flash_attention_tf32(q, k, v, segment_ids, sm_scale, lse=None) -> torch.Tensor:
    """K2's f32 kernel on the tensor cores in 3xTF32 (f32, D a multiple of
    4 up to 256, operands TMA reads) on checked CUDA inputs: the output as a
    ``[B, H, S, D]`` view of a ``[B, S, H, D]`` buffer; with ``lse`` (a
    contiguous f32 [B, H, S]) it also writes each row's logsumexp there."""
    out = _tensor_core_forward(_tf32_kernel(), "flash_attention_tf32", q, k, v, segment_ids,
                               sm_scale, lse)
    flash_attention_tf32.launches += 1
    return out


class _FlashAttention(torch.autograd.Function):
    """K2 forward (with the row logsumexp) and K2b backward for CUDA tensors;
    the plain versions for CPU tensors.  Segment ids get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, sm_scale):
        out, lse = flash_attention_fwd(q, k, v, segment_ids, sm_scale)
        ctx.save_for_backward(q, k, v, segment_ids, out, lse)
        ctx.sm_scale = sm_scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, segment_ids, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, segment_ids, out, lse, dout, ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor,  # [B, H, S, D] f32 or bf16 on the card, D <= 256; last dim contiguous
    k: torch.Tensor,  # [B, H, S, D]
    v: torch.Tensor,  # [B, H, S, D]
    segment_ids: torch.Tensor,  # [B, S] int32, contiguous
    sm_scale: float,
) -> torch.Tensor:  # [B, H, S, D] in q's dtype
    """Segment-masked attention: kernel K2 for CUDA tensors (the route that
    :func:`forward_route` names), the plain version for CPU tensors,
    differentiable through K2b (the plain backward on the CPU) when grad is
    enabled and q, k or v requires it.  Raises on anything the kernels do
    not take.

    On the card the result is a ``[B, H, S, D]`` view of a ``[B, S, H, D]``
    buffer, so ``out.transpose(1, 2).reshape(B, S, H * D)`` is a view."""
    _check_inputs(q, k, v, segment_ids)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, segment_ids, sm_scale)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, segment_ids, sm_scale)
    return _launch_forward(q, k, v, segment_ids, sm_scale)


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    segment_ids: torch.Tensor,
    sm_scale: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward that training runs: the output of :func:`flash_attention`
    and each row's logsumexp of the scaled, masked logits (f32 ``[B, H, S]``,
    natural log), which the backward reads.  K2 for CUDA tensors, the plain
    version for CPU tensors."""
    _check_inputs(q, k, v, segment_ids)
    if q.device.type == "cpu":
        logits = _masked_logits(q, k, segment_ids, sm_scale)
        out = torch.matmul(torch.softmax(logits, dim=-1), v.float()).to(q.dtype)
        return out, torch.logsumexp(logits, dim=-1)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    return _launch_forward(q, k, v, segment_ids, sm_scale, lse), lse


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    segment_ids: torch.Tensor,
    o: torch.Tensor,  # the forward's output
    lse: torch.Tensor,  # [B, H, S] f32, the forward's row logsumexp
    dout: torch.Tensor,  # gradient of the output, any strides
    sm_scale: float,
) -> Grads:
    """dq, dk, dv of :func:`flash_attention`: kernel dq (which also writes
    ``di``), then kernel dkv, for CUDA tensors (the pair that
    :func:`backward_route` names); :func:`flash_attention_bwd_plain` for CPU
    tensors.  On the card the gradients are ``[B, H, S, D]`` views of
    ``[B, S, H, D]`` buffers (of ``[B, S, H, D']`` ones on the ``"wgmma_pad"``
    and ``"tf32_pad"`` routes, whose inputs are all copied, padded to D'
    columns, for the wgmma or the 3xTF32 pair), and no torch op computes
    ``di``.  A dO that the route's kernels cannot read
    through its strides is copied once (counted in
    ``flash_attention_bwd.dout_copies``); an ``o`` they cannot read
    raises."""
    _check_inputs(q, k, v, segment_ids)
    if dout.shape != q.shape or o.shape != q.shape or lse.shape != q.shape[:3]:
        raise ValueError(
            f"o {tuple(o.shape)}, dout {tuple(dout.shape)} and lse {tuple(lse.shape)} "
            f"do not fit q {tuple(q.shape)}"
        )
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, segment_ids, o, lse, dout, sm_scale)
    if dout.dtype != q.dtype or o.dtype != q.dtype or lse.dtype != torch.float32:
        raise TypeError(f"o {o.dtype}, dout {dout.dtype} (want {q.dtype}), lse {lse.dtype} "
                        f"(want float32)")
    route = backward_route(q, k, v)
    d = q.shape[-1]
    if route in _PAD_COLUMNS:
        width = -(-d // _PAD_COLUMNS[route]) * _PAD_COLUMNS[route]
        q, k, v, o, dout = (pad_heads(t, width) for t in (q, k, v, o, dout))
        route = backward_route(q, k, v)
    dq_fn, dkv_fn = _BACKWARDS[route]
    readable = _simt_readable if route == "simt" else _kernel_readable
    if not readable(dout):
        dout = dout.contiguous()
        flash_attention_bwd.dout_copies += 1
    lse = lse.contiguous()
    dq, di = dq_fn(q, k, v, segment_ids, lse, o, dout, sm_scale)
    dk, dv = dkv_fn(q, k, v, segment_ids, lse, di, dout, sm_scale)
    return dq[..., :d], dk[..., :d], dv[..., :d]


# copies of a dO the kernels could not read through its strides
flash_attention_bwd.dout_copies = 0


def _check_rows(**rows: torch.Tensor) -> None:
    for name, t in rows.items():
        if not t.is_contiguous() or t.dtype != torch.float32 or t.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous f32 [B, H, S] on a 16-byte boundary")


def _check_readable(readable=_kernel_readable, **ts: torch.Tensor) -> None:
    for name, t in ts.items():
        if not readable(t):
            raise ValueError(f"{name} strides {t.stride()} from a {t.data_ptr() % 16}-byte "
                             f"offset: the kernels cannot read it")


def _tensor_core_dq(kernels, what, q, k, v, segment_ids, lse, o, dout, sm_scale):
    """One launch of a TMA-fed dq kernel (``kernels()[0]``) on checked CUDA
    inputs: (dq, di), di = sum_d o * dO in f32 as a contiguous ``[B, H,
    S]``."""
    _check_rows(lse=lse)
    _check_readable(o=o, dout=dout)
    b, h, s, d = q.shape
    dq = _empty_bshd(q)
    di = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = kernels()[0](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), dout.data_ptr(),
            segment_ids.data_ptr(), lse.data_ptr(), dq.data_ptr(), di.data_ptr(),
            b, h, s, d, _strides(q, k, v, dout, dq, o), sm_scale, _stream(q),
        )
    _raise_on(err, what)
    return dq, di


def _tensor_core_dkv(kernels, what, q, k, v, segment_ids, lse, di, dout, sm_scale):
    """One launch of a TMA-fed dkv kernel (``kernels()[1]``) on checked CUDA
    inputs and dq's ``di``: (dk, dv)."""
    _check_rows(lse=lse, di=di)
    _check_readable(dout=dout)
    dk, dv = _empty_bshd(q), _empty_bshd(q)
    b, h, s, d = q.shape
    with torch.cuda.device(q.device):
        err = kernels()[1](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), segment_ids.data_ptr(),
            lse.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, h, s, d, _strides(q, k, v, dout, dk), sm_scale, _stream(q),
        )
    _raise_on(err, what)
    return dk, dv


def flash_attention_bwd_dq(q, k, v, segment_ids, lse, o, dout, sm_scale):
    """Kernel dq (bf16, D = 64) on checked CUDA inputs: (dq, di), di = sum_d
    o * dO in f32 as a contiguous ``[B, H, S]``, which
    :func:`flash_attention_bwd_dkv` reads."""
    out = _tensor_core_dq(_bwd_kernels, "flash_attention_bwd_dq", q, k, v, segment_ids, lse, o,
                          dout, sm_scale)
    flash_attention_bwd_dq.launches += 1
    return out


def flash_attention_bwd_dkv(q, k, v, segment_ids, lse, di, dout, sm_scale):
    """Kernel dkv (bf16, D = 64) on checked CUDA inputs and dq's ``di``:
    (dk, dv)."""
    out = _tensor_core_dkv(_bwd_kernels, "flash_attention_bwd_dkv", q, k, v, segment_ids, lse,
                           di, dout, sm_scale)
    flash_attention_bwd_dkv.launches += 1
    return out


def flash_attention_bwd_headdim_dq(q, k, v, segment_ids, lse, o, dout, sm_scale):
    """Kernel dq at a head dim other than 64 (bf16, D a multiple of 8 up to
    128, ceil(D / 64) slabs; operands TMA reads) on checked CUDA inputs:
    (dq, di) as :func:`flash_attention_bwd_dq` gives them."""
    out = _tensor_core_dq(_bwd_kernels, "flash_attention_bwd_headdim_dq", q, k, v, segment_ids,
                          lse, o, dout, sm_scale)
    flash_attention_bwd_headdim_dq.launches += 1
    return out


def flash_attention_bwd_headdim_dkv(q, k, v, segment_ids, lse, di, dout, sm_scale):
    """Kernel dkv at a head dim other than 64 (as
    :func:`flash_attention_bwd_headdim_dq`) on checked CUDA inputs and dq's
    ``di``: (dk, dv)."""
    out = _tensor_core_dkv(_bwd_kernels, "flash_attention_bwd_headdim_dkv", q, k, v, segment_ids,
                           lse, di, dout, sm_scale)
    flash_attention_bwd_headdim_dkv.launches += 1
    return out


def flash_attention_tf32_bwd_dq(q, k, v, segment_ids, lse, o, dout, sm_scale):
    """K2b's f32 dq kernel on the tensor cores in 3xTF32 (f32, D a multiple
    of 4 up to 64, operands TMA reads) on checked CUDA inputs: (dq, di) as
    :func:`flash_attention_bwd_dq` gives them."""
    out = _tensor_core_dq(_tf32_bwd_kernels, "flash_attention_tf32_bwd_dq", q, k, v, segment_ids,
                          lse, o, dout, sm_scale)
    flash_attention_tf32_bwd_dq.launches += 1
    return out


def flash_attention_tf32_bwd_dkv(q, k, v, segment_ids, lse, di, dout, sm_scale):
    """K2b's f32 dkv kernel in 3xTF32 (as :func:`flash_attention_tf32_bwd_dq`)
    on checked CUDA inputs and dq's ``di``: (dk, dv)."""
    out = _tensor_core_dkv(_tf32_bwd_kernels, "flash_attention_tf32_bwd_dkv", q, k, v,
                           segment_ids, lse, di, dout, sm_scale)
    flash_attention_tf32_bwd_dkv.launches += 1
    return out


def _simt_flag(q: torch.Tensor) -> int:
    return int(q.dtype == torch.bfloat16)


def flash_attention_simt(q, k, v, segment_ids, sm_scale, lse=None) -> torch.Tensor:
    """K2's CUDA-core kernel on checked CUDA inputs (f32 or bf16, any D up
    to 256, any strides with D contiguous: the ``"simt"`` route, what TMA
    cannot read): the output as a ``[B, H, S, D]`` view of a ``[B, S, H,
    D]`` buffer; with ``lse`` (a contiguous f32 [B, H, S]) it also writes
    each row's logsumexp there."""
    if lse is not None:
        _check_rows(lse=lse)
    b, h, s, d = q.shape
    out = _empty_bshd(q)
    with torch.cuda.device(q.device):
        err = _simt_kernels()[0](
            _simt_flag(q), q.data_ptr(), k.data_ptr(), v.data_ptr(), segment_ids.data_ptr(),
            out.data_ptr(), None if lse is None else lse.data_ptr(), b, h, s, d,
            _strides(q, k, v, out), sm_scale, _stream(q),
        )
    _raise_on(err, "flash_attention_simt")
    flash_attention_simt.launches += 1
    return out


def flash_attention_simt_bwd_dq(q, k, v, segment_ids, lse, o, dout, sm_scale):
    """K2b's CUDA-core dq kernel on checked CUDA inputs: (dq, di) as
    :func:`flash_attention_bwd_dq` gives them."""
    _check_rows(lse=lse)
    _check_readable(_simt_readable, o=o, dout=dout)
    b, h, s, d = q.shape
    dq = _empty_bshd(q)
    di = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _simt_kernels()[1](
            _simt_flag(q), q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            dout.data_ptr(), segment_ids.data_ptr(), lse.data_ptr(), dq.data_ptr(),
            di.data_ptr(), b, h, s, d, _strides(q, k, v, o, dout, dq), sm_scale, _stream(q),
        )
    _raise_on(err, "flash_attention_simt_bwd_dq")
    flash_attention_simt_bwd_dq.launches += 1
    return dq, di


def flash_attention_simt_bwd_dkv(q, k, v, segment_ids, lse, di, dout, sm_scale):
    """K2b's CUDA-core dkv kernel on checked CUDA inputs and dq's ``di``:
    (dk, dv)."""
    _check_rows(lse=lse, di=di)
    _check_readable(_simt_readable, dout=dout)
    b, h, s, d = q.shape
    dk, dv = _empty_bshd(q), _empty_bshd(q)
    with torch.cuda.device(q.device):
        err = _simt_kernels()[2](
            _simt_flag(q), q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            segment_ids.data_ptr(), lse.data_ptr(), di.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, h, s, d, _strides(q, k, v, dout, dk, dv), sm_scale, _stream(q),
        )
    _raise_on(err, "flash_attention_simt_bwd_dkv")
    flash_attention_simt_bwd_dkv.launches += 1
    return dk, dv


# the column multiple that each padding route of backward_route rounds D up
# to: the wgmma pair reads 16-byte rows of bf16, the 3xTF32 pair of f32
_PAD_COLUMNS = {"wgmma_pad": 8, "tf32_pad": 4}

# each route's forward, by forward_route's name, and backward pair (dq,
# dkv), by backward_route's
_FORWARDS = {"wgmma": _wgmma_forward, "wgmma_headdim": flash_attention_headdim,
             "tf32": flash_attention_tf32, "simt": flash_attention_simt}
_BACKWARDS = {"wgmma": (flash_attention_bwd_dq, flash_attention_bwd_dkv),
              "wgmma_headdim": (flash_attention_bwd_headdim_dq, flash_attention_bwd_headdim_dkv),
              "tf32": (flash_attention_tf32_bwd_dq, flash_attention_tf32_bwd_dkv),
              "simt": (flash_attention_simt_bwd_dq, flash_attention_simt_bwd_dkv)}

# launches of the CUDA kernels, one count a kernel and route (CPU calls of
# the plain versions do not count)
flash_attention.launches = 0
flash_attention_headdim.launches = 0
flash_attention_tf32.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_headdim_dq.launches = 0
flash_attention_bwd_headdim_dkv.launches = 0
flash_attention_tf32_bwd_dq.launches = 0
flash_attention_tf32_bwd_dkv.launches = 0
flash_attention_simt.launches = 0
flash_attention_simt_bwd_dq.launches = 0
flash_attention_simt_bwd_dkv.launches = 0
