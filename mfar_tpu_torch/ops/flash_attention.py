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

Seven routes on the card for the forward, chosen before any launch by
:func:`forward_route` from dtype, head dim and strides alone, each counting
its own launches (the padding routes under the kernel they run):

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
- ``"wgmma_rows"``, bf16 whose heads TMA cannot read one by one (a D that
  is not a multiple of 8, such as TinyBERT-4L-312D's 26, whose 52-byte rows
  no tensor map describes) but whose heads lie side by side in rows of
  16-byte multiples (:func:`_row_readable`: the encoder's ``[B, S, H*D]``
  projections, 624 bytes at TinyBERT's width; D up to 249): the wgmma
  kernel reading those rows in place through row maps, head h's boxes from
  column h*D rounded down to 8 (TMA starts boxes on 16-byte boundaries
  only), Q's and K's tiles moved in shared memory so that the head's first
  column is the tile's (K's where h*D is not a multiple of 8), Q's columns
  past D zeroed (:func:`flash_attention_rows`).
- ``"tf32_rows"``, the same for f32 (a D that is not a multiple of 4, up
  to 253): the 3xTF32 kernel reading each head's columns in place itself,
  4 bytes a load, those past D as 0, so S is exact for any input
  (:func:`flash_attention_tf32_rows`).
- ``"wgmma_pad"`` (bf16) and ``"tf32_pad"`` (f32), everything else up to D
  = 256 (a head dim neither map reads, e.g. a contiguous ``[B, H, S, 26]``,
  whose rows are 52 bytes apart; strides that are not multiples of 16 bytes
  or a D stride other than 1; a base off a 16-byte boundary; heads side by
  side past the rows routes' D): q, k and v copied into zero-padded ``[B,
  S, H, D']`` buffers (:func:`pad_heads`; D' = D rounded up to 8 or 4),
  which TMA reads, then the forward of their route (``"wgmma"``,
  ``"wgmma_headdim"`` or ``"tf32"``, whose launches count) at the scale the
  caller gave, the output handed back as a view of its first D columns.
  The zero columns add 0 to every logit, so the logsumexp is the same.
  ``flash_attention.pad_launches[route]`` counts these routes apart.

The backward's pair follows the same rule, chosen by :func:`backward_route`,
each pair counting its own launches:

- ``"wgmma"``, bf16 with D = 64: the wgmma pair of
  ``csrc/flash_attention_bwd.cu`` (``flash_attention_bwd_dq`` / ``_dkv``).
- ``"wgmma_headdim"``, bf16 at any other D that TMA can read: the same pair
  at ceil(D / 64) slabs of 64 columns (:func:`flash_attention_bwd_headdim_dq`
  / ``_dkv``); past D = 128 in blocks of one warpgroup, dkv's grid split
  into a dV block and a dK block a key tile (these wide launches counted
  apart too, in ``.wide_launches``).
- ``"tf32"``, f32 that TMA can read: ``csrc/flash_attention_tf32_bwd.cu``
  (:func:`flash_attention_tf32_bwd_dq` / ``_dkv``), every product in 3xTF32
  and P, dS kept in f32; past D = 64 in blocks of one warpgroup streaming
  32-row half tiles, dkv's grid split as above (``.wide_launches``).
- ``"wgmma_pad"``, bf16 that TMA cannot read (a D that is not a multiple of
  8, such as TinyBERT-4L-312D's 26, whose 52-byte rows no tensor map
  describes, strides that are not multiples of 16 bytes, a D stride other
  than 1):
  q, k, v, o and dO copied into zero-padded ``[B, S, H, D8]`` buffers (D8
  = D rounded up to 8), which TMA reads, then the pair of their route
  (``"wgmma"`` or ``"wgmma_headdim"``, whose launches count), the
  gradients handed back as views of their first D columns.  The padded
  columns of q, k, v and dO are 0, so S and dP are exact and the
  gradients' padded columns 0.
- ``"tf32_pad"``, f32 that TMA cannot read (a D that is not a multiple of
  4, such as TinyBERT-4L-312D's 26, whose 104-byte rows no tensor map
  describes, or strides that are not multiples of 16 bytes, or a base off
  a 16-byte boundary): the same copies at D rounded up to 4, then the
  3xTF32 pair (``"tf32"``, whose launches count), the gradients views of
  their first D columns.  A zero column splits into two zero TF32 parts,
  so S and dP stay exact here too.

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
MAX_HEAD_DIM = 256  # every route's largest head dimension
SEQ_MULTIPLE = 128  # S % 128 == 0, as JAX's gate asks
# past these head dims the backward pairs run their wide instances (one
# warpgroup a block, dkv's grid split into dV and dK blocks)
WIDE_BWD_HEAD_DIM = {torch.bfloat16: 128, torch.float32: 64}

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
        if not segment_ids.is_contiguous() or segment_ids.data_ptr() % 16:
            raise ValueError("segment_ids must be contiguous and start on a 16-byte boundary")


def forward_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The forward's kernel for [B, H, S, D] q, k, v on the card, from their
    dtype, head dim and strides alone: ``"wgmma"`` (bf16, D = 64),
    ``"wgmma_headdim"`` (bf16 at another D, a multiple of 8), ``"tf32"``
    (f32, D a multiple of 4), each where TMA can read all three per head
    (:func:`_kernel_readable`); then ``"wgmma_rows"`` (bf16) and
    ``"tf32_rows"`` (f32) where it can read all three as rows of heads side
    by side (:func:`_row_readable`); ``"wgmma_pad"`` (bf16) and
    ``"tf32_pad"`` (f32) for the rest, copied into zero-padded buffers that
    TMA reads.  The backward's pair is :func:`backward_route`'s."""
    bf16 = q.dtype == torch.bfloat16
    route = backward_route(q, k, v)
    if route in _PAD_COLUMNS and all(_row_readable(t) for t in (q, k, v)):
        return "wgmma_rows" if bf16 else "tf32_rows"
    return route


def backward_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The backward's kernel pair for [B, H, S, D] q, k, v on the card, from
    their dtype, head dim and strides alone, each where TMA can read all
    three (:func:`_kernel_readable`): ``"wgmma"`` (bf16, D = 64),
    ``"wgmma_headdim"`` (bf16 at another D, a multiple of 8: the same pair
    at ceil(D / 64) slabs), ``"tf32"`` (f32, D a multiple of 4: the 3xTF32
    pair); then, for what TMA cannot read, ``"wgmma_pad"`` (bf16) and
    ``"tf32_pad"`` (f32), copied into zero-padded buffers that it reads, for
    the wgmma or the 3xTF32 pair.  Without the rows routes, the forward's
    rule too (:func:`forward_route`)."""
    d = q.shape[-1]
    tma = all(_kernel_readable(t) for t in (q, k, v))
    if q.dtype == torch.bfloat16:
        if tma and d % 8 == 0:
            return "wgmma" if d == HEAD_DIM else "wgmma_headdim"
        return "wgmma_pad"
    return "tf32" if tma and d % 4 == 0 else "tf32_pad"


def _kernel_readable(t: torch.Tensor) -> bool:
    """A [B, H, S, D] operand that TMA reads through its strides: D
    contiguous, the B, H and S strides multiples of 16 bytes, from a
    16-byte boundary."""
    return t.stride(-1) == 1 and not any(st * t.element_size() % 16 for st in t.stride()[:3]) \
        and t.data_ptr() % 16 == 0


def _row_readable(t: torch.Tensor) -> bool:
    """A [B, H, S, D] operand whose heads lie side by side in rows that TMA
    reads whole (a row map over ``[B, S, H*D]``): D contiguous, the H stride
    D, the B and S strides multiples of 16 bytes, from a 16-byte boundary;
    D up to 256 less the columns a head can start into a box (TMA starts
    boxes on 16-byte boundaries only): 249 in bf16, 253 in f32."""
    es = t.element_size()
    return t.stride(-1) == 1 and t.stride(1) == t.shape[-1] \
        and t.shape[-1] + 16 // es - 1 <= MAX_HEAD_DIM \
        and not (t.stride(0) * es % 16 or t.stride(2) * es % 16) and t.data_ptr() % 16 == 0


def _strides(*ts: torch.Tensor):
    return (ctypes.c_longlong * (3 * len(ts)))(*(st for t in ts for st in t.stride()[:3]))


def pad_heads(t: torch.Tensor, width: int) -> torch.Tensor:
    """A ``[B, H, S, width]`` view of a new buffer that holds [B, H, S, D]
    ``t`` (any strides) in its first D columns and 0 past them, laid out as
    ``[B, S, H, width]`` or in another layout TMA reads per head (for D' =
    ``width`` a multiple of 8 in bf16, 4 in f32)."""
    out = torch.nn.functional.pad(t.transpose(1, 2), (0, width - t.shape[-1])).transpose(1, 2)
    # F.pad keeps the layout of a dense t, as a clone (width D) or in its
    # channels-last order: a D stride other than 1 stays
    return out if _kernel_readable(out) else _empty_bshd(out).copy_(out)


def _padded_width(route: str, d: int) -> int:
    """D rounded up to the column multiple of a padding route."""
    return -(-d // _PAD_COLUMNS[route]) * _PAD_COLUMNS[route]


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


def _bind_forward(lib_name: str, name: str):
    """A forward entry point (they share one signature)."""
    fn = getattr(_build.load(lib_name), name)
    fn.argtypes = _forward_argtypes()
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _kernel():
    return _bind_forward("flash_attention", "mfar_flash_attention_fwd")


@functools.cache
def _rows_kernel():
    return _bind_forward("flash_attention", "mfar_flash_attention_fwd_rows")


@functools.cache
def _tf32_kernel():
    return _bind_forward("flash_attention_tf32", "mfar_flash_attention_fwd_tf32")


@functools.cache
def _tf32_rows_kernel():
    return _bind_forward("flash_attention_tf32_rows", "mfar_flash_attention_fwd_tf32_rows")


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


def _launch_forward(q, k, v, segment_ids, sm_scale, lse=None) -> torch.Tensor:
    """K2 on checked CUDA inputs, by :func:`forward_route` (on a padding
    route, the route of the padded copies, the output a view of its first D
    columns); with ``lse`` (a contiguous f32 [B, H, S]) it also writes each
    row's logsumexp there."""
    route, d = forward_route(q, k, v), q.shape[-1]
    if route not in _PAD_COLUMNS:
        return _FORWARDS[route](q, k, v, segment_ids, sm_scale, lse)
    q, k, v = (pad_heads(t, _padded_width(route, d)) for t in (q, k, v))
    out = _FORWARDS[forward_route(q, k, v)](q, k, v, segment_ids, sm_scale, lse)
    flash_attention.pad_launches[route] += 1
    return out[..., :d]


def _wgmma_forward(q, k, v, segment_ids, sm_scale, lse=None) -> torch.Tensor:
    """K2's wgmma kernel at D = 64, counted as :func:`flash_attention`'s."""
    out = _tensor_core_forward(_kernel(), "flash_attention", q, k, v, segment_ids, sm_scale, lse)
    flash_attention.launches += 1
    return out


def _tensor_core_forward(kernel, what, q, k, v, segment_ids, sm_scale, lse,
                         readable=_kernel_readable) -> torch.Tensor:
    """One launch of a forward (the wgmma kernel through per-head maps or,
    with ``readable`` :func:`_row_readable`, row maps; the 3xTF32 kernel,
    which reads the same layouts itself) on checked CUDA inputs: the output
    as a ``[B, H, S, D]`` view of a ``[B, S, H, D]`` buffer."""
    if lse is not None:
        _check_rows(lse=lse)
    _check_readable(readable, q=q, k=k, v=v)
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


def flash_attention_rows(q, k, v, segment_ids, sm_scale, lse=None) -> torch.Tensor:
    """K2's wgmma kernel through row maps (bf16 up to D = 249, q, k and v
    laid out as :func:`_row_readable` says: the ``"wgmma_rows"`` route) on
    checked CUDA inputs: the output as a ``[B, H, S, D]`` view of a ``[B, S,
    H, D]`` buffer; with ``lse`` (a contiguous f32 [B, H, S]) it also writes
    each row's logsumexp there."""
    out = _tensor_core_forward(_rows_kernel(), "flash_attention_rows", q, k, v, segment_ids,
                               sm_scale, lse, readable=_row_readable)
    flash_attention_rows.launches += 1
    return out


def flash_attention_tf32_rows(q, k, v, segment_ids, sm_scale, lse=None) -> torch.Tensor:
    """K2's 3xTF32 kernel on rows of heads side by side (f32 up to D =
    253, laid out as :func:`_row_readable` says: the ``"tf32_rows"`` route)
    on checked CUDA inputs: the output and ``lse`` as
    :func:`flash_attention_rows` gives them."""
    out = _tensor_core_forward(_tf32_rows_kernel(), "flash_attention_tf32_rows", q, k, v,
                               segment_ids, sm_scale, lse, readable=_row_readable)
    flash_attention_tf32_rows.launches += 1
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
    buffer, so ``out.transpose(1, 2).reshape(B, S, H * D)`` is a view (of a
    ``[B, S, H, D']`` one on the padding routes, where that reshape
    copies)."""
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
        width = _padded_width(route, d)
        q, k, v, o, dout = (pad_heads(t, width) for t in (q, k, v, o, dout))
        route = backward_route(q, k, v)
    dq_fn, dkv_fn = _BACKWARDS[route]
    if not _kernel_readable(dout):
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


def _wide(q: torch.Tensor) -> int:
    """1 where a pair runs its wide instance at q's head dim, else 0."""
    return int(q.shape[-1] > WIDE_BWD_HEAD_DIM[q.dtype])


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
    256, ceil(D / 64) slabs; operands TMA reads) on checked CUDA inputs:
    (dq, di) as :func:`flash_attention_bwd_dq` gives them."""
    out = _tensor_core_dq(_bwd_kernels, "flash_attention_bwd_headdim_dq", q, k, v, segment_ids,
                          lse, o, dout, sm_scale)
    flash_attention_bwd_headdim_dq.launches += 1
    flash_attention_bwd_headdim_dq.wide_launches += _wide(q)
    return out


def flash_attention_bwd_headdim_dkv(q, k, v, segment_ids, lse, di, dout, sm_scale):
    """Kernel dkv at a head dim other than 64 (as
    :func:`flash_attention_bwd_headdim_dq`) on checked CUDA inputs and dq's
    ``di``: (dk, dv)."""
    out = _tensor_core_dkv(_bwd_kernels, "flash_attention_bwd_headdim_dkv", q, k, v, segment_ids,
                           lse, di, dout, sm_scale)
    flash_attention_bwd_headdim_dkv.launches += 1
    flash_attention_bwd_headdim_dkv.wide_launches += _wide(q)
    return out


def flash_attention_tf32_bwd_dq(q, k, v, segment_ids, lse, o, dout, sm_scale):
    """K2b's f32 dq kernel on the tensor cores in 3xTF32 (f32, D a multiple
    of 4 up to 256, operands TMA reads) on checked CUDA inputs: (dq, di) as
    :func:`flash_attention_bwd_dq` gives them."""
    out = _tensor_core_dq(_tf32_bwd_kernels, "flash_attention_tf32_bwd_dq", q, k, v, segment_ids,
                          lse, o, dout, sm_scale)
    flash_attention_tf32_bwd_dq.launches += 1
    flash_attention_tf32_bwd_dq.wide_launches += _wide(q)
    return out


def flash_attention_tf32_bwd_dkv(q, k, v, segment_ids, lse, di, dout, sm_scale):
    """K2b's f32 dkv kernel in 3xTF32 (as :func:`flash_attention_tf32_bwd_dq`)
    on checked CUDA inputs and dq's ``di``: (dk, dv)."""
    out = _tensor_core_dkv(_tf32_bwd_kernels, "flash_attention_tf32_bwd_dkv", q, k, v,
                           segment_ids, lse, di, dout, sm_scale)
    flash_attention_tf32_bwd_dkv.launches += 1
    flash_attention_tf32_bwd_dkv.wide_launches += _wide(q)
    return out


# the column multiple that each padding route rounds D up to: the wgmma
# kernels read 16-byte rows of bf16, the 3xTF32 kernels of f32
_PAD_COLUMNS = {"wgmma_pad": 8, "tf32_pad": 4}

# each route's forward, by forward_route's name, and backward pair (dq,
# dkv), by backward_route's
_FORWARDS = {"wgmma": _wgmma_forward, "wgmma_headdim": flash_attention_headdim,
             "tf32": flash_attention_tf32, "wgmma_rows": flash_attention_rows,
             "tf32_rows": flash_attention_tf32_rows}
_BACKWARDS = {"wgmma": (flash_attention_bwd_dq, flash_attention_bwd_dkv),
              "wgmma_headdim": (flash_attention_bwd_headdim_dq, flash_attention_bwd_headdim_dkv),
              "tf32": (flash_attention_tf32_bwd_dq, flash_attention_tf32_bwd_dkv)}

# launches of the CUDA kernels, one count a kernel and route (CPU calls of
# the plain versions do not count); of those, the forward's padding routes'
# and the backward pairs' wide instances apart
flash_attention.launches = 0
flash_attention.pad_launches = dict.fromkeys(_PAD_COLUMNS, 0)
flash_attention_headdim.launches = 0
flash_attention_tf32.launches = 0
flash_attention_rows.launches = 0
flash_attention_tf32_rows.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_headdim_dq.launches = 0
flash_attention_bwd_headdim_dkv.launches = 0
flash_attention_tf32_bwd_dq.launches = 0
flash_attention_tf32_bwd_dkv.launches = 0
flash_attention_bwd_headdim_dq.wide_launches = flash_attention_bwd_headdim_dkv.wide_launches = 0
flash_attention_tf32_bwd_dq.wide_launches = flash_attention_tf32_bwd_dkv.wide_launches = 0
