"""Kernel K1, the stage-2 rerank gather: per-field candidate scores read
straight from the flat corpus.

    out[b, c, f] = sum_e q[b, e] * docs_flat[ids[b, c], f*E + e]   (f32)

:func:`gather_per_field_scores` launches a hand-written CUDA kernel of
``mfar_tpu_torch/csrc/gather_scores.cu`` for tensors on the card; it replaces
the TPU kernel ``mfar_tpu/ops/pallas_kernels.py::
gather_per_field_scores_pallas`` in its two schedules.  ``cross_row=False``
launches K1, the row-local schedule (one warp a candidate; the TPU kernel's
default prefetch).  ``cross_row=True`` launches K1x, the counterpart of the
TPU kernel's ``cross_row_prefetch=True``: a persistent grid whose warps each
walk a contiguous span of the flat candidate list in one order, across query
rows, with the next row's ``cp.async`` copy in flight while the current row
is scored.  Both compute the same function, bit for bit on the card.
:func:`gather_per_field_scores_plain` is that function in plain PyTorch: the
wrapper uses it for CPU tensors only, whichever schedule is asked for, and
the tests and ``chip_smoke.py`` hold both kernels against it.

The kernels read the flat ``[N, F*E]`` corpus where it lies, so unlike the
TPU kernel they need no second (row-DMA view) corpus copy.  They are bound
by the bytes of the candidate rows they read; see the note in the source.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mfar_tpu_torch.ops import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def gather_per_field_scores_plain(
    q: torch.Tensor,  # [B, E]
    docs_flat: torch.Tensor,  # [N, F*E] f32/bf16
    cand_ids: torch.Tensor,  # [B, C] integer row ids
    num_fields: int,
) -> torch.Tensor:  # [B, C, F] f32
    """Gather the candidate rows, upcast to f32, multiply and sum per field."""
    b, e = q.shape
    rows = docs_flat[cand_ids.long()].float()  # [B, C, F*E]
    rows = rows.view(b, cand_ids.shape[1], num_fields, e)
    return (rows * q.float()[:, None, None, :]).sum(dim=-1)


@functools.cache
def _kernel(cross_row: bool):
    lib = _build.load("gather_scores")
    fn = (lib.mfar_gather_per_field_scores_cross_row if cross_row
          else lib.mfar_gather_per_field_scores)
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q docs ids out
        ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,  # B C N F E
        ctypes.c_int, ctypes.c_void_p,  # dtype code, stream
    ]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _cross_row_smem_limit(device_index: int) -> int:
    """Bytes of dynamic shared memory a block of K1x may use on the card."""
    fn = _build.load("gather_scores").mfar_gather_cross_row_smem_limit
    fn.argtypes, fn.restype = [], ctypes.c_longlong
    return fn()


def gather_per_field_scores(
    q: torch.Tensor,  # [B, E] f32, contiguous
    docs_flat: torch.Tensor,  # [N, F*E] f32 or bf16, contiguous
    cand_ids: torch.Tensor,  # [B, C] int64, contiguous; any C
    num_fields: int,
    cross_row: bool = False,  # K1x's cross-row walk instead of K1's row-local grid
) -> torch.Tensor:  # [B, C, F] f32
    """Per-field candidate scores: kernel K1 (or K1x with ``cross_row``) for
    CUDA tensors, the plain version for CPU tensors.  Raises on anything the
    kernel does not take."""
    if q.dim() != 2 or docs_flat.dim() != 2 or cand_ids.dim() != 2:
        raise ValueError(
            f"want q [B, E], docs_flat [N, F*E], cand_ids [B, C]; got "
            f"{tuple(q.shape)}, {tuple(docs_flat.shape)}, {tuple(cand_ids.shape)}"
        )
    b, e = q.shape
    n, fe = docs_flat.shape
    if cand_ids.shape[0] != b:
        raise ValueError(f"cand_ids has {cand_ids.shape[0]} rows for {b} queries")
    if fe != num_fields * e:
        raise ValueError(f"docs_flat width {fe} != num_fields {num_fields} x E {e}")
    if docs_flat.dtype not in _DTYPE_CODE:
        raise TypeError(
            f"corpus dtype {docs_flat.dtype}: the gather reads f32 or bf16 "
            f"corpora (an int8 corpus dequantizes its candidates through the "
            f"plain gather)"
        )
    if q.dtype != torch.float32:
        raise TypeError(f"q must be float32, got {q.dtype}")
    if cand_ids.dtype != torch.int64:
        raise TypeError(f"cand_ids must be int64, got {cand_ids.dtype}")
    devices = {q.device, docs_flat.device, cand_ids.device}
    if len(devices) != 1:
        raise ValueError(f"q, docs_flat and cand_ids lie on different devices: {devices}")
    if not (q.is_contiguous() and docs_flat.is_contiguous() and cand_ids.is_contiguous()):
        raise ValueError("q, docs_flat and cand_ids must be contiguous")
    vec = 16 // docs_flat.element_size()  # corpus values per 16-byte load
    if e % vec:
        raise ValueError(
            f"E={e} must be a multiple of {vec} for 16-byte loads of a "
            f"{docs_flat.dtype} corpus"
        )

    if q.device.type == "cpu":
        return gather_per_field_scores_plain(q, docs_flat, cand_ids, num_fields)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.data_ptr() % 16 or docs_flat.data_ptr() % 16:
        raise ValueError("q and docs_flat must start on a 16-byte boundary")
    if cross_row:
        with torch.cuda.device(q.device):
            limit = _cross_row_smem_limit(q.device.index or 0)
        need = 2 * fe * docs_flat.element_size() + 4 * e  # a warp's two rows and q[b]
        if need > limit:
            raise ValueError(
                f"K1x: one warp's two {docs_flat.dtype} rows of F={num_fields} x E={e} and "
                f"q[b] take {need} bytes of shared memory; a block may use {limit}"
            )
    else:
        if b > 65535:
            raise ValueError(f"B={b} exceeds the kernel's grid (65535 query rows)")
        if e * 4 > 48 * 1024:
            raise ValueError(f"E={e}: q[b] must fit 48 KB of shared memory")

    c = cand_ids.shape[1]
    out = torch.empty((b, c, num_fields), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel(bool(cross_row))(
            q.data_ptr(), docs_flat.data_ptr(), cand_ids.data_ptr(), out.data_ptr(),
            b, c, n, num_fields, e, _DTYPE_CODE[docs_flat.dtype], stream,
        )
    name = "gather_scores_cross_row" if cross_row else "gather_scores"
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    if cross_row:
        gather_per_field_scores.cross_row_launches += 1
    else:
        gather_per_field_scores.launches += 1
    return out


# launches of the CUDA kernels, K1 and K1x (CPU calls of the plain version do
# not count)
gather_per_field_scores.launches = 0
gather_per_field_scores.cross_row_launches = 0
