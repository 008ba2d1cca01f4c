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
kernels of ``csrc/flash_attention_bwd.cu``, which replace the Pallas kernels
of JAX's VJP: first :func:`flash_attention_bwd_dq`, which also computes the
row dots ``di = sum_d o * dO`` (JAX computes them outside Pallas) and
writes them out, then :func:`flash_attention_bwd_dkv`, which reads them.
:func:`flash_attention_plain` and :func:`flash_attention_bwd_plain` are the
same functions in plain PyTorch, in f32: the wrappers use them for CPU
tensors only, and the tests and ``chip_smoke.py`` hold the kernels against
them.

Two routes on the card, chosen by dtype and head dim alone:

- bf16 with D = 64 (Contriever-base, BERT-base): the wgmma kernels above.
  They read q/k/v (and the backward's o and dO) through their strides, so
  the ``[B, S, H, D] -> [B, H, S, D]`` transposed views of the encoder's
  projections need no copy, and they write outputs and gradients laid out
  as ``[B, S, H, D]``, so the way back to ``[B, S, H*D]`` is free too.
- f32, or bf16 at any other D up to 256 (``EncoderConfig.tiny``, the
  synthetic models, ``--precision 32``, a BERT directory whose heads are
  not 64 wide): the CUDA-core kernels of ``csrc/flash_attention_simt.cu``
  (:func:`flash_attention_simt`, :func:`flash_attention_simt_bwd_dq`,
  :func:`flash_attention_simt_bwd_dkv`), in f32 FMA (never TF32), with the
  same strided reads and ``[B, S, H, D]`` writes.

Both take S a multiple of 128 (JAX's gate); each route counts its own
launches.  D above 256 raises on every device.
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
HEAD_DIM = 64  # the wgmma kernels' head dimension
MAX_HEAD_DIM = 256  # the CUDA-core kernels' largest head dimension
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
        if _wgmma_route(q):
            readable, need = _kernel_readable, ("B, H, S strides multiples of 8 elements "
                                                "(16-byte rows), from a 16-byte boundary")
        elif q.dtype in (torch.float32, torch.bfloat16):
            readable, need = _simt_readable, "the D stride 1"
        else:
            raise TypeError(f"{q.dtype} q/k/v: the flash kernels take float32 and bfloat16")
        for name, t in (("q", q), ("k", k), ("v", v)):
            if not readable(t):
                raise ValueError(f"{name} strides {t.stride()}: the kernels need {need}")
        if not segment_ids.is_contiguous() or segment_ids.data_ptr() % 16:
            raise ValueError("segment_ids must be contiguous and start on a 16-byte boundary")


def _wgmma_route(q: torch.Tensor) -> bool:
    """The wgmma kernels' inputs (bf16 at D = 64); every other CUDA input
    takes the CUDA-core kernels."""
    return q.dtype == torch.bfloat16 and q.shape[-1] == HEAD_DIM


def _kernel_readable(t: torch.Tensor) -> bool:
    """A [B, H, S, D] bf16 operand the kernels read through its strides."""
    return t.stride(-1) == 1 and not any(st % 8 for st in t.stride()[:3]) \
        and t.data_ptr() % 16 == 0


def _simt_readable(t: torch.Tensor) -> bool:
    """A [B, H, S, D] operand the CUDA-core kernels read through its strides."""
    return t.stride(-1) == 1


def _strides(*ts: torch.Tensor):
    return (ctypes.c_longlong * (3 * len(ts)))(*(st for t in ts for st in t.stride()[:3]))


def _empty_bshd(like: torch.Tensor) -> torch.Tensor:
    """A ``[B, H, S, D]`` view of a new ``[B, S, H, D]`` buffer."""
    b, h, s, d = like.shape
    return torch.empty((b, s, h, d), dtype=like.dtype, device=like.device).transpose(1, 2)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


@functools.cache
def _kernel():
    fn = _build.load("flash_attention").mfar_flash_attention_fwd
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q k v seg
        ctypes.c_void_p, ctypes.c_void_p,  # out, lse (or null)
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B H S
        ctypes.POINTER(ctypes.c_longlong),  # 12 strides: (b, h, s) of q, k, v, out
        ctypes.c_float, ctypes.c_void_p,  # sm_scale, stream
    ]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_kernels():
    lib = _build.load("flash_attention_bwd")
    tail = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B H S
        ctypes.POINTER(ctypes.c_longlong),  # strides: q, k, v, dout, gradients (dq: then o)
        ctypes.c_float, ctypes.c_void_p,  # sm_scale, stream
    ]
    dq, dkv = lib.mfar_flash_attention_bwd_dq, lib.mfar_flash_attention_bwd_dkv
    dq.argtypes = [ctypes.c_void_p] * 9 + tail  # q k v o dout seg lse, dq di
    dkv.argtypes = [ctypes.c_void_p] * 9 + tail  # q k v dout seg lse di, dk dv
    dq.restype = dkv.restype = ctypes.c_int
    return dq, dkv


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
    """K2 on checked CUDA inputs (the wgmma kernel for bf16 at D = 64, the
    CUDA-core one for the rest); with ``lse`` (a contiguous f32 [B, H, S])
    it also writes each row's logsumexp there."""
    if not _wgmma_route(q):
        return flash_attention_simt(q, k, v, segment_ids, sm_scale, lse)
    b, h, s, _ = q.shape
    out = _empty_bshd(q)
    with torch.cuda.device(q.device):
        err = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), segment_ids.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), b, h, s, _strides(q, k, v, out),
            sm_scale, _stream(q),
        )
    _raise_on(err, "flash_attention")
    flash_attention.launches += 1
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
    """Segment-masked attention: kernel K2 for CUDA tensors (the wgmma
    kernel for bf16 at D = 64, :func:`flash_attention_simt` for f32 and
    other head dims), the plain version for CPU tensors, differentiable
    through K2b (the plain backward on the CPU) when grad is enabled and q,
    k or v requires it.  Raises on anything the kernels do not take.

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
    ``di``), then kernel dkv, for CUDA tensors (the wgmma pair for bf16 at
    D = 64, the CUDA-core pair for the rest); :func:`flash_attention_bwd_plain`
    for CPU tensors.  On the card the gradients are ``[B, H, S, D]`` views
    of ``[B, S, H, D]`` buffers, and no torch op computes ``di``.  A dO that
    the kernels cannot read through its strides is copied once (counted in
    ``flash_attention_bwd.dout_copies``); an ``o`` they cannot read raises."""
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
    if _wgmma_route(q):
        readable, dq_fn, dkv_fn = _kernel_readable, flash_attention_bwd_dq, flash_attention_bwd_dkv
    else:
        readable = _simt_readable
        dq_fn, dkv_fn = flash_attention_simt_bwd_dq, flash_attention_simt_bwd_dkv
    if not readable(dout):
        dout = dout.contiguous()
        flash_attention_bwd.dout_copies += 1
    lse = lse.contiguous()
    dq, di = dq_fn(q, k, v, segment_ids, lse, o, dout, sm_scale)
    dk, dv = dkv_fn(q, k, v, segment_ids, lse, di, dout, sm_scale)
    return dq, dk, dv


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


def flash_attention_bwd_dq(q, k, v, segment_ids, lse, o, dout, sm_scale):
    """Kernel dq on checked CUDA inputs: (dq, di), di = sum_d o * dO in f32
    as a contiguous ``[B, H, S]``, which :func:`flash_attention_bwd_dkv`
    reads."""
    _check_rows(lse=lse)
    _check_readable(o=o, dout=dout)
    b, h, s, _ = q.shape
    dq = _empty_bshd(q)
    di = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _bwd_kernels()[0](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), dout.data_ptr(),
            segment_ids.data_ptr(), lse.data_ptr(), dq.data_ptr(), di.data_ptr(),
            b, h, s, _strides(q, k, v, dout, dq, o), sm_scale, _stream(q),
        )
    _raise_on(err, "flash_attention_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    return dq, di


def flash_attention_bwd_dkv(q, k, v, segment_ids, lse, di, dout, sm_scale):
    """Kernel dkv on checked CUDA inputs and dq's ``di``: (dk, dv)."""
    _check_rows(lse=lse, di=di)
    _check_readable(dout=dout)
    dk, dv = _empty_bshd(q), _empty_bshd(q)
    b, h, s, _ = q.shape
    with torch.cuda.device(q.device):
        err = _bwd_kernels()[1](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), segment_ids.data_ptr(),
            lse.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, h, s, _strides(q, k, v, dout, dk), sm_scale, _stream(q),
        )
    _raise_on(err, "flash_attention_bwd_dkv")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


def _simt_flag(q: torch.Tensor) -> int:
    return int(q.dtype == torch.bfloat16)


def flash_attention_simt(q, k, v, segment_ids, sm_scale, lse=None) -> torch.Tensor:
    """K2's CUDA-core kernel on checked CUDA inputs (f32, or bf16 at D !=
    64; D <= 256): the output as a ``[B, H, S, D]`` view of a ``[B, S, H,
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


# launches of the CUDA kernels, one count a kernel (CPU calls of the plain
# versions do not count)
flash_attention.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0
flash_attention_simt.launches = 0
flash_attention_simt_bwd_dq.launches = 0
flash_attention_simt_bwd_dkv.launches = 0
