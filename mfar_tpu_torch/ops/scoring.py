"""Multi-field scoring ops in PyTorch: counterpart of ``mfar_tpu/ops/scoring.py``
for the single-device serving paths: dense and hybrid (dense + BM25), over a
device-resident corpus in f32/bf16 or int8, or a corpus streamed from host
memory chunk by chunk; and the scatter-free bucketed hybrid ops, which no
engine route calls (as in the JAX package).

mFAR's score is a query-conditioned softmax mixture of per-field dots,

    T[b, n] = sum_f w[b, f] * (q[b, :] . D[n, f, :]),

and the field weight folds into the query: Q'[b, f*E:(f+1)*E] = w[b, f] *
q[b, :], so T = Q' @ D'^T over the flat ``[N, F*E]`` corpus.  The JAX
package leaves these matmuls and top-ks to XLA (no Pallas kernel), so they
stay torch ops here: one ``torch.matmul`` per corpus chunk and an exact
``torch.topk`` with a running merge across chunks.

Differences from the JAX module, none of which changes a result:

- ``exact_topk_rows`` is ``torch.topk``: the JAX two-level block-max
  selection exists because ``lax.top_k`` sorts whole rows on a TPU.
- ``per_field_topk_chunked_approx`` selects exactly: ``lax.approx_max_k`` is
  a TPU PartialReduce op with no Hopper twin, and an exact top-k meets any
  ``recall_target`` (ROADMAP queue C2).
- Indices come back as int64, torch's index type.
- A bf16 corpus scores through :func:`scores_f32`: bf16 operands with f32
  accumulation and an f32 result, as ``jnp.dot(...,
  preferred_element_type=float32)`` gives.
- The int8 product is ``torch._int_mm`` (exact int32 sums, as ``jnp.dot(...,
  preferred_element_type=int32)``), with the operands padded to its CUDA
  shape limits (:func:`int8_dot`).
- The host-streamed scans copy chunks through pinned memory on a copy
  stream, with CUDA events for ordering and backpressure
  (:func:`_host_stream_loop`), where the JAX package issues ``device_put``
  and fetches a scalar per chunk.  They stream the ragged tail chunk as it
  is, where the JAX package pads it to its compiled shape.
- The bucketed scan loops over chunks in Python where the JAX package runs
  ``lax.scan``, and takes the run boundaries' reverse cumulative minimum as
  ``torch.cummin`` of the flipped tensor.
"""

from __future__ import annotations

import warnings
import weakref
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.nn import functional as F

TopK = Tuple[torch.Tensor, torch.Tensor]


def scores_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b.T`` with an f32 result.  f32 operands multiply in f32 (TF32
    stays off unless the caller turns it on); bf16 operands multiply on the
    card with f32 accumulation and output, and on the CPU as f32 copies,
    which is the same arithmetic (a bf16 product is exact in f32)."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.matmul(a, b.T)
    if a.is_cuda:
        return torch.mm(a, b.T, out_dtype=torch.float32)
    return torch.matmul(a.float(), b.float().T)


def softmax_field_weights(
    W: torch.Tensor,  # [E, F] (query-conditioned) or [1, F]/[F, 1]/[F] (global)
    q: Optional[torch.Tensor] = None,  # [B, E]
    mask: Optional[torch.Tensor] = None,  # [F] 0/1 field ablation mask
) -> torch.Tensor:  # [B, F] or [1, F]
    """Query-conditioned softmax field weights.  The ablation mask multiplies
    *after* the softmax: masked fields contribute zero score, but the
    distribution over fields is unchanged."""
    if W.ndim == 1:
        W = W[None, :]
    if q is not None and W.shape[0] == q.shape[-1] and W.shape[0] > 1:
        # [E, F] query-conditioned (an [F, 1] global with F == E is
        # ambiguous and resolves here, as in the JAX package)
        logits = torch.matmul(q.float(), W.float())  # [B, F]
    elif W.shape[0] == 1:
        logits = W[:1].float()  # [1, F] global
    elif W.shape[1] == 1:
        logits = W.T.float()  # [F, 1] column-vector global -> [1, F]
    else:
        raise ValueError(
            f"query-conditioned mixer weights {tuple(W.shape)} need q (got "
            f"None); global weights must be [1, F], [F, 1], or [F]"
        )
    weights = torch.softmax(logits, dim=-1)
    if mask is not None:
        weights = weights * mask[None, :]
    return weights


def fold_queries(q: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Fold field weights into the query: [B, E] x [B, F] -> [B, F*E]."""
    folded = weights[:, :, None].to(q.dtype) * q[:, None, :]  # [B, F, E]
    return folded.reshape(q.shape[0], -1)


def fuse_and_mix(
    q: torch.Tensor,  # [B, E]
    docs_flat: torch.Tensor,  # [N, F*E]
    W: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:  # [B, N] f32
    """Full fused scoring: weights -> fold -> one matmul."""
    weights = softmax_field_weights(W, q, mask)
    weights = weights.expand(q.shape[0], weights.shape[-1])
    return scores_f32(fold_queries(q, weights).to(docs_flat.dtype), docs_flat)


def exact_topk_rows(s: torch.Tensor, k: int) -> TopK:
    """Exact per-row top-k (values sorted descending).  Among tied values
    another equal-valued element may win than under the JAX selection; the
    returned values are the same."""
    return torch.topk(s, k, dim=-1, largest=True, sorted=True)


def _merge_topk(a: TopK, b: TopK, k: int) -> TopK:
    """Merge two (scores, indices) running top-k pairs along the last axis."""
    cat_s = torch.cat([a[0], b[0]], dim=-1)
    cat_i = torch.cat([a[1], b[1]], dim=-1)
    new_s, sel = torch.topk(cat_s, k, dim=-1)
    return new_s, torch.gather(cat_i, -1, sel)


def _pad_topk(top_s: torch.Tensor, top_i: torch.Tensor, k: int) -> TopK:
    """Pad a [rows, kk] top-k to k columns with -inf scores (index 0)."""
    have = top_s.shape[1]
    if have == k:
        return top_s, top_i
    pad = k - have
    top_s = torch.nn.functional.pad(top_s, (0, pad), value=float("-inf"))
    top_i = torch.nn.functional.pad(top_i, (0, pad), value=0)
    return top_s, top_i


def _stream_chunked_topk(
    chunk_topk: Callable[..., TopK],
    arrays_axes: Sequence[Tuple[torch.Tensor, int]],
    n: int,
    chunk_size: int,
    k: int,
) -> TopK:
    """Streaming loop for the chunked top-k ops: ``chunk_topk(*slices,
    offset)`` runs once per corpus chunk (the last one may be ragged) and
    its [rows, k] result merges into a running exact top-k."""
    out = None
    for start in range(0, n, chunk_size):
        stop = min(n, start + chunk_size)
        slices = [x.narrow(ax, start, stop - start) for x, ax in arrays_axes]
        part = chunk_topk(*slices, start)
        out = part if out is None else _merge_topk(out, part, k)
    return out


def _row_bias(offset: int, c: int, valid_n: int, device) -> torch.Tensor:
    """[1, c] additive mask row: 0 for real rows, -inf past ``valid_n``."""
    idx = offset + torch.arange(c, device=device)
    return torch.where(idx < valid_n, 0.0, float("-inf"))[None, :]


def dense_topk_chunked(
    qflat: torch.Tensor,  # [B, F*E] folded queries
    docs_flat: torch.Tensor,  # [N, F*E] (no chunk-multiple padding needed)
    valid_n: int,  # number of real (non-padding) rows
    k: int,
    chunk_size: int = 131072,
) -> TopK:  # scores [B, k] f32, indices [B, k] int64
    """Exact top-k streaming the corpus through one matmul per chunk with a
    running [B, k] merge; score memory is O(B * (k + chunk))."""
    n = docs_flat.shape[0]
    if n > chunk_size and k > chunk_size:
        raise ValueError("top-k carry must fit in one chunk")

    def chunk_topk(chunk_docs, offset):
        c = chunk_docs.shape[0]
        s = scores_f32(qflat, chunk_docs) + _row_bias(offset, c, valid_n, qflat.device)
        top_s, sel = exact_topk_rows(s, min(k, c))
        return _pad_topk(top_s, sel + offset, k)

    return _stream_chunked_topk(chunk_topk, ((docs_flat, 0),), n, chunk_size, k)


def hybrid_topk_chunked(
    qflat: torch.Tensor,  # [B, Fd*E] folded queries (dense fields)
    docs_flat: torch.Tensor,  # [N, Fd*E]
    sparse_comb: torch.Tensor,  # [B, N] combined (weight-mixed) sparse scores
    valid_n: int,
    k: int,
    chunk_size: int = 131072,
) -> TopK:  # scores [B, k] f32, indices [B, k] int64
    """Exact full-corpus hybrid top-k: each chunk's dense matmul plus the
    matching columns of the combined sparse scores, then a running exact
    top-k, so hybrid retrieval is exact rather than recalled."""
    n = docs_flat.shape[0]
    if n > chunk_size and k > chunk_size:
        raise ValueError("top-k carry must fit in one chunk")

    def chunk_topk(chunk_docs, chunk_sparse, offset):
        c = chunk_docs.shape[0]
        s = scores_f32(qflat, chunk_docs) + chunk_sparse.float()
        s = s + _row_bias(offset, c, valid_n, qflat.device)
        top_s, sel = exact_topk_rows(s, min(k, c))
        return _pad_topk(top_s, sel + offset, k)

    return _stream_chunked_topk(
        chunk_topk, ((docs_flat, 0), (sparse_comb, 1)), n, chunk_size, k
    )


def per_field_topk_chunked(
    q: torch.Tensor,  # [B, E] query embeddings (NOT folded)
    docs_flat: torch.Tensor,  # [N, F*E]
    valid_n: int,
    num_fields: int,
    k: int,
    chunk_size: int = 131072,
) -> TopK:  # scores [B, F, k], indices [B, F, k]
    """Per-field recall top-k in ONE corpus pass: each chunk is read once
    by F matmuls over its field column blocks, then F running top-ks."""
    n = docs_flat.shape[0]
    b = q.shape[0]
    f = num_fields
    e = docs_flat.shape[1] // num_fields
    if n > chunk_size and k > chunk_size:
        raise ValueError("top-k carry must fit in one chunk")

    def chunk_topk(chunk_docs, offset):
        c = chunk_docs.shape[0]
        s = torch.stack([
            scores_f32(q, chunk_docs[:, i * e : (i + 1) * e]) for i in range(f)
        ])  # [F, B, c]
        s = s.reshape(f * b, c) + _row_bias(offset, c, valid_n, q.device)
        top_s, sel = exact_topk_rows(s, min(k, c))
        return _pad_topk(top_s, sel + offset, k)

    top_s, top_i = _stream_chunked_topk(chunk_topk, ((docs_flat, 0),), n, chunk_size, k)
    # [F*B, k] -> [B, F, k]
    return (
        top_s.reshape(f, b, -1).transpose(0, 1),
        top_i.reshape(f, b, -1).transpose(0, 1),
    )


def per_field_topk_chunked_approx(
    q, docs_flat, valid_n, num_fields, k, chunk_size=131072, recall_target=0.95
) -> TopK:
    """The JAX name of the recall scan.  Selection is exact here, which meets
    any ``recall_target`` (see the module docstring)."""
    del recall_target
    return per_field_topk_chunked(q, docs_flat, valid_n, num_fields, k, chunk_size)


def per_field_candidate_scores(
    q: torch.Tensor,  # [B, E]
    cand_docs: torch.Tensor,  # [B, C, F, E] gathered candidate embeddings
) -> torch.Tensor:  # [B, C, F]
    """Per-field dot products for the rerank stage, in f32."""
    return torch.einsum("be,bcfe->bcf", q.float(), cand_docs.float())


def rerank_candidates(
    q: torch.Tensor,  # [B, E]
    dense_scores: torch.Tensor,  # [B, C, Fd] per-dense-field candidate scores
    sparse_scores: Optional[torch.Tensor],  # [B, C, Fs]
    W: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    cand_valid: Optional[torch.Tensor] = None,  # [B, C] bool for padded cands
    k: int = 100,
) -> TopK:
    """Stage-2 rerank: concatenate dense+sparse field scores, mask the
    SCORES, mix with query-conditioned weights computed WITHOUT the mask,
    top-k over the candidate pool (``mfar_tpu/ops/scoring.py:923-946``)."""
    scores = dense_scores
    if sparse_scores is not None:
        scores = torch.cat([dense_scores, sparse_scores.to(dense_scores.dtype)], dim=-1)
    if mask is not None:
        scores = scores * mask[None, None, :]
    weights = softmax_field_weights(W, q)
    weights = weights.expand(q.shape[0], weights.shape[-1])
    total = torch.einsum("bcf,bf->bc", scores, weights)
    if cand_valid is not None:
        total = torch.where(cand_valid, total, float("-inf"))
    return exact_topk_rows(total, min(k, total.shape[1]))


def fused_dense_topk_from_query(
    q: torch.Tensor,  # [B, E] query embeddings (encoder output)
    W: torch.Tensor,  # mixer weight [E, F] or [F, 1]/[1, F]
    mask: Optional[torch.Tensor],  # [F] ablation mask or None
    docs_flat: torch.Tensor,  # [N, Fd*E]
    valid_n: int,
    num_dense: int,
    k: int,
    chunk_size: int = 131072,
    approx: bool = False,  # accepted for the JAX signature; selection is exact
) -> TopK:
    """Exact dense serving from query embeddings: softmax field weights ->
    query fold -> chunked streaming top-k."""
    del approx
    weights = softmax_field_weights(W, q, mask)
    weights = weights.expand(q.shape[0], weights.shape[-1])
    qflat = fold_queries(q, weights[:, :num_dense]).to(docs_flat.dtype)
    return dense_topk_chunked(qflat, docs_flat, valid_n, k=k, chunk_size=chunk_size)


def _fold_and_densify(
    q: torch.Tensor,
    W: torch.Tensor,
    mask: Optional[torch.Tensor],
    n: int,
    num_dense: int,
    post_ids: torch.Tensor,
    post_vals: torch.Tensor,
    post_field: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weights -> folded dense queries [B, Fd*E] (the input dtype) and the
    postings scattered into combined sparse scores [B, n] f32.  Raw impacts
    ship from the host; each posting picks up its field's post-softmax
    weight here, so the weights never leave the device.  A document hit by
    several terms or fields appears once per posting and the scatter sums
    them (on a card with atomics, in an order that varies: equal within
    float rounding)."""
    b = q.shape[0]
    weights = softmax_field_weights(W, q, mask)
    weights = weights.expand(b, weights.shape[-1])
    qflat = fold_queries(q, weights[:, :num_dense])
    # the field index ships as int8: widen before the gather
    w_sparse = torch.gather(weights, 1, num_dense + post_field.long())  # [B, M]
    sparse_comb = torch.zeros(b, n, dtype=torch.float32, device=q.device)
    sparse_comb.scatter_add_(1, post_ids.long(), post_vals.float() * w_sparse)
    return qflat, sparse_comb


def fused_hybrid_topk_postings_from_query(
    q: torch.Tensor,  # [B, E]
    W: torch.Tensor,
    mask: Optional[torch.Tensor],
    docs_flat: torch.Tensor,  # [N, Fd*E]
    post_ids: torch.Tensor,  # [B, M] corpus rows (0-padded)
    post_vals: torch.Tensor,  # [B, M] f32 raw impacts (0-padded)
    post_field: torch.Tensor,  # [B, M] sparse-field index per posting (int8)
    valid_n: int,
    num_dense: int,
    k: int,
    chunk_size: int = 131072,
) -> TopK:
    """Exact hybrid serving from query embeddings: weights -> fold ->
    per-posting weight gather -> scatter densification on the device ->
    fused chunked hybrid top-k (:func:`_fold_and_densify`)."""
    qflat, sparse_comb = _fold_and_densify(
        q, W, mask, docs_flat.shape[0], num_dense, post_ids, post_vals, post_field)
    return hybrid_topk_chunked(qflat.to(docs_flat.dtype), docs_flat, sparse_comb, valid_n, k,
                               chunk_size)


def onehot_queries(q: torch.Tensor, num_fields: int) -> torch.Tensor:
    """[B, E] -> [B*F, F*E]: row b*F + f holds q[b] in field f's column
    block and zeros elsewhere, so one folded scan gives each field's own
    scores (the recall scan of the int8 and host-streamed corpora)."""
    b, e = q.shape
    eye = torch.eye(num_fields, dtype=q.dtype, device=q.device)
    return torch.einsum("fg,be->bfge", eye, q).reshape(b * num_fields, num_fields * e)


# ----------------------------------------------------------------------
# The int8 corpus (mfar_tpu/ops/scoring.py:771-892, :1012-1070).  The JAX
# package leaves these to XLA: they stay torch ops.

INT8_SLAB_ROWS = 65536  # rows quantized at a time: bounds the f32 temporary


def quantize_rows_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization: values in [-127, 127] and an f32
    scale per row (absmax / 127), rounding half to even.  Bit for bit the
    arithmetic of :func:`quantize_rows_int8_np` and of the JAX package's
    pair: a corpus quantized on the host and queries quantized on the device
    must agree."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(absmax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0]


def quantize_rows_int8_np(x) -> Tuple[np.ndarray, np.ndarray]:
    """Host (numpy) twin of :func:`quantize_rows_int8`: same math, same
    round-half-to-even."""
    x = np.asarray(x, np.float32)
    absmax = np.max(np.abs(x), axis=-1, keepdims=True)
    scale = np.maximum(absmax, 1e-12).astype(np.float32) / 127.0
    q = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
    return q, scale[..., 0]


def quantize_slab(slab) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`quantize_rows_int8` of a tensor, where it lies (on the card
    for rows there), or :func:`quantize_rows_int8_np` of a host array (a
    memmap's rows too), as CPU tensors: every quantization of a corpus's
    rows goes through here, so a row quantized twice comes out the same."""
    if torch.is_tensor(slab):
        return quantize_rows_int8(slab)
    return tuple(torch.from_numpy(a) for a in quantize_rows_int8_np(slab))


def quantize_rows_int8_into(x, out_q: torch.Tensor, out_scale: torch.Tensor,
                            rows: int = INT8_SLAB_ROWS, offset: int = 0) -> None:
    """Quantize rows ``[offset, offset + len(out_q))`` of ``x`` [N, D] into
    ``out_q`` int8 and ``out_scale`` f32, ``rows`` rows at a time
    (:func:`quantize_slab`), so the f32 temporary stays one slab and only
    those rows are read; the outputs may lie elsewhere."""
    for lo in range(0, out_q.shape[0], rows):
        hi = min(out_q.shape[0], lo + rows)
        out_q[lo:hi], out_scale[lo:hi] = quantize_slab(x[offset + lo : offset + hi])


def int8_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b.T`` for int8 ``a`` [M, K] and ``b`` [C, K] in exact int32
    sums (an f32 product of the int8 values is not exact: 127**2 * 3840 >
    2**24).  ``torch._int_mm`` on the card takes more than 16 rows of ``a``
    and a K and a C that are multiples of 8: ``a``'s rows pad to at least
    24, K pads to a multiple of 8 (zero columns add nothing), and the last
    C % 8 rows of ``b`` go through a product of their own, padded to 8 rows;
    the pads are cut from the result.  The CPU takes the same path."""
    m, depth = a.shape
    c = b.shape[0]
    if depth % 8:
        a = F.pad(a, (0, -depth % 8))
        b = F.pad(b, (0, -depth % 8))
    a = F.pad(a, (0, 0, 0, max(m + (-m % 8), 24) - m))
    body = c - c % 8
    parts = []
    if body:
        parts.append(torch._int_mm(a, b[:body].T))
    if c % 8:
        tail = F.pad(b[body:], (0, 0, 0, 8 - c % 8))
        parts.append(torch._int_mm(a, tail.T)[:, : c % 8])
    out = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    return out[:m]


def int8_scores(q8, q_scale, d8, d_scale) -> torch.Tensor:
    """[M, C] f32 scores (q8 . d8) * q_scale * d_scale, multiplied in the
    JAX package's order (in place: one f32 tile)."""
    return int8_dot(q8, d8).float().mul_(q_scale[:, None]).mul_(d_scale[None, :])


def dense_topk_chunked_int8(
    qflat: torch.Tensor,  # [B, F*E] folded queries (any float dtype)
    docs_q: torch.Tensor,  # [N, F*E] int8 corpus (quantize_rows_int8)
    doc_scales: torch.Tensor,  # [N] f32 per-row scales
    valid_n: int,
    k: int,
    chunk_size: int = 131072,
) -> TopK:
    """Quantized :func:`dense_topk_chunked`: queries quantize per row here,
    and the scores deviate from f32 retrieval only by the quantization
    error.  It also stands for the JAX package's
    ``dense_topk_chunked_approx_int8``, whose selection is exact here (the
    module docstring)."""
    q8, q_scale = quantize_rows_int8(qflat)
    n = docs_q.shape[0]
    if n > chunk_size and k > chunk_size:
        raise ValueError("top-k carry must fit in one chunk")

    def chunk_topk(chunk_docs, chunk_scales, offset):
        c = chunk_docs.shape[0]
        s = int8_scores(q8, q_scale, chunk_docs, chunk_scales)
        s = s + _row_bias(offset, c, valid_n, qflat.device)
        top_s, sel = exact_topk_rows(s, min(k, c))
        return _pad_topk(top_s, sel + offset, k)

    return _stream_chunked_topk(
        chunk_topk, ((docs_q, 0), (doc_scales, 0)), n, chunk_size, k)


def hybrid_topk_chunked_int8(
    qflat: torch.Tensor,  # [B, F*E] folded queries (any float dtype)
    docs_q: torch.Tensor,  # [N, F*E] int8
    doc_scales: torch.Tensor,  # [N] f32
    sparse_comb: torch.Tensor,  # [B, N] combined sparse scores
    valid_n: int,
    k: int,
    chunk_size: int = 131072,
) -> TopK:
    """int8 twin of :func:`hybrid_topk_chunked`: the sparse scores stay f32,
    so the only deviation from f32 hybrid retrieval is the dense side's
    quantization error."""
    q8, q_scale = quantize_rows_int8(qflat)
    n = docs_q.shape[0]
    if n > chunk_size and k > chunk_size:
        raise ValueError("top-k carry must fit in one chunk")

    def chunk_topk(chunk_docs, chunk_scales, chunk_sparse, offset):
        c = chunk_docs.shape[0]
        s = int8_scores(q8, q_scale, chunk_docs, chunk_scales) + chunk_sparse.float()
        s = s + _row_bias(offset, c, valid_n, qflat.device)
        top_s, sel = exact_topk_rows(s, min(k, c))
        return _pad_topk(top_s, sel + offset, k)

    return _stream_chunked_topk(
        chunk_topk, ((docs_q, 0), (doc_scales, 0), (sparse_comb, 1)), n, chunk_size, k)


def fused_dense_topk_from_query_int8(
    q, W, mask, docs_q, doc_scales, valid_n, num_dense, k, chunk_size=131072,
) -> TopK:
    """int8 twin of :func:`fused_dense_topk_from_query`: weights -> fold (in
    f32) -> quantized chunked scan."""
    weights = softmax_field_weights(W, q, mask)
    weights = weights.expand(q.shape[0], weights.shape[-1])
    qflat = fold_queries(q, weights[:, :num_dense]).float()
    return dense_topk_chunked_int8(qflat, docs_q, doc_scales, valid_n, k, chunk_size)


def fused_hybrid_topk_postings_from_query_int8(
    q, W, mask, docs_q, doc_scales, post_ids, post_vals, post_field, valid_n, num_dense, k,
    chunk_size=131072,
) -> TopK:
    """int8 twin of :func:`fused_hybrid_topk_postings_from_query`."""
    qflat, sparse_comb = _fold_and_densify(
        q, W, mask, docs_q.shape[0], num_dense, post_ids, post_vals, post_field)
    return hybrid_topk_chunked_int8(qflat.float(), docs_q, doc_scales, sparse_comb, valid_n,
                                    k, chunk_size)


# ----------------------------------------------------------------------
# The host-streamed corpus (mfar_tpu/ops/scoring.py:233-603): the corpus
# stays in host memory (RAM or a memmap) and streams to the device a chunk
# at a time, with a running exact top-k on the device.

HOST_STREAM_CHUNK = 262144  # corpus rows a streamed chunk
STREAM_UPCAST_ROWS = 16384  # rows of a low-precision chunk upcast at a time


def pinned_empty(shape, dtype: torch.dtype) -> torch.Tensor:
    """An empty CPU tensor whose pages are locked for copies to the card, for
    as long as it lives.  ``torch.empty(pin_memory=True)`` takes a block of
    the caching host allocator, which rounds the size up to a power of two
    (an 8.05 GB corpus would lock 16 GB of host memory); registering the
    tensor's own pages locks exactly its bytes."""
    t = torch.empty(shape, dtype=dtype)
    nbytes = t.numel() * t.element_size()
    if nbytes:
        cudart = torch.cuda.cudart()
        err = int(cudart.cudaHostRegister(t.data_ptr(), nbytes, 0))
        if err:
            raise RuntimeError(f"cudaHostRegister of {nbytes} bytes failed: CUDA error {err}")
        weakref.finalize(t, cudart.cudaHostUnregister, t.data_ptr())
    return t


def as_host_tensor(a) -> torch.Tensor:
    """A CPU tensor over a host array without a copy (a read-only memmap
    too: the stream only reads it)."""
    if torch.is_tensor(a):
        return a
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(np.asarray(a))


class _ChunkFeed:
    """One host array streamed to the device along ``axis``, a chunk at a
    time.  A pinned tensor of the streamed dtype (any tensor of it on a CPU
    engine) is copied from in place; every other array (a memmap, a
    pageable array, a column block of a [B, N] array, another dtype) is
    cast chunk by chunk into one of two pinned staging buffers, so the
    copies to the card read pinned memory only.  Two device buffers of one
    chunk each take the copies in turn."""

    def __init__(self, host, axis: int, dtype: torch.dtype, chunk: int, device: torch.device):
        self.host, self.axis = host, axis
        cuda = device.type == "cuda"
        self.direct = (torch.is_tensor(host) and host.dtype == dtype and axis == 0
                       and (host.is_pinned() or not cuda))
        shape = list(host.shape)
        shape[axis] = min(chunk, shape[axis])
        self.stage = [] if self.direct else [
            pinned_empty(shape, dtype) if cuda else torch.empty(shape, dtype=dtype)
            for _ in range(2)]
        self.dev = [torch.empty(shape, dtype=dtype, device=device)
                    for _ in range(2)] if cuda else None

    def host_chunk(self, slot: int, lo: int, hi: int) -> torch.Tensor:
        if self.direct:
            return self.host.narrow(0, lo, hi - lo)
        src = self.host[lo:hi] if self.axis == 0 else self.host[:, lo:hi]
        buf = self.stage[slot].narrow(self.axis, 0, hi - lo)
        buf.copy_(as_host_tensor(src))  # the cast, where there is one
        return buf

    def device_chunk(self, slot: int, src: torch.Tensor) -> torch.Tensor:
        if self.dev is None:
            return src
        dst = self.dev[slot].narrow(self.axis, 0, src.shape[self.axis])
        dst.copy_(src, non_blocking=True)
        return dst


def _host_stream_loop(feeds: List[_ChunkFeed], n: int, chunk_size: int, device: torch.device,
                      run_chunk: Callable[..., TopK], kk: int, k: int) -> TopK:
    """Stream ``n`` rows of every feed to the device in chunks and merge
    ``run_chunk(*device_chunks, offset)``'s [rows, <= kk] top-k into a
    running [rows, kk] one.  On a card, chunk i+1's copies run on a copy
    stream while chunk i is scored on the current stream, which waits on
    an event recorded after the copies.  An event after each chunk's
    scoring frees its buffers: before it fills the buffers of chunk i+2,
    the host waits for the scoring of chunk i, so at most two chunks are in
    flight and the host never enqueues the whole corpus (the JAX package's
    scalar fetch a chunk, ``_host_stream_loop``).  The device buffers come
    from the current stream's pool, where work of an earlier call may still
    use their memory: the copy stream first waits for the current stream."""
    cuda = device.type == "cuda"
    compute = torch.cuda.current_stream(device) if cuda else None
    copier = torch.cuda.Stream(device) if cuda else None
    if cuda:
        copier.wait_stream(compute)
    read = [None, None]  # per buffer slot: the event after the scoring that read it

    def put(i: int):
        slot = i % 2
        if read[slot] is not None:
            read[slot].synchronize()
        lo, hi = i * chunk_size, min(n, (i + 1) * chunk_size)
        srcs = [f.host_chunk(slot, lo, hi) for f in feeds]
        if not cuda:
            return srcs, None, lo
        with torch.cuda.stream(copier):
            chunks = [f.device_chunk(slot, s) for f, s in zip(feeds, srcs)]
            landed = torch.cuda.Event()
            landed.record(copier)
        return chunks, landed, lo

    out = None
    nxt = put(0)
    n_chunks = -(-n // chunk_size)
    for i in range(n_chunks):
        chunks, landed, lo = nxt
        if cuda:
            compute.wait_event(landed)
        part = run_chunk(*chunks, lo)
        out = _pad_topk(*part, kk) if out is None else _merge_topk(out, part, kk)
        if cuda:
            read[i % 2] = torch.cuda.Event()
            read[i % 2].record(compute)
        if i + 1 < n_chunks:
            nxt = put(i + 1)
    return _pad_topk(*out, k)


def _stream_scores(q: torch.Tensor, chunk: torch.Tensor) -> torch.Tensor:
    """[B, c] f32 scores of a streamed chunk.  f32 queries against a
    lower-precision chunk (an in-RAM corpus cast once to bf16) multiply in
    f32, as the JAX package's type promotion does, with the chunk's rows
    upcast a block at a time to bound the f32 temporary."""
    if q.dtype == chunk.dtype:
        return scores_f32(q, chunk)
    out = torch.empty(q.shape[0], chunk.shape[0], dtype=torch.float32, device=q.device)
    for lo in range(0, chunk.shape[0], STREAM_UPCAST_ROWS):
        blk = chunk[lo : lo + STREAM_UPCAST_ROWS]
        out[:, lo : lo + blk.shape[0]] = scores_f32(q, blk.float())
    return out


def _add_postings(s: torch.Tensor, post_ids, post_wvals, offset: int) -> torch.Tensor:
    """Scatter-add the weighted postings that land in this chunk's rows
    (global ids; the others add zero at row 0), so no [B, N] sparse tensor
    ever exists."""
    rel = post_ids.long() - offset
    inside = (rel >= 0) & (rel < s.shape[1])
    vals = torch.where(inside, post_wvals.float(), 0.0)
    return s.scatter_add_(1, torch.where(inside, rel, 0), vals)


def _host_dtype(a) -> torch.dtype:
    return a.dtype if torch.is_tensor(a) else torch.from_numpy(np.empty(0, a.dtype)).dtype


def _topk_host_streamed(score_chunk, docs_host, dtype, k, chunk_size, device,
                        post_ids=None, post_wvals=None, sparse_comb_host=None) -> TopK:
    """The running top-k of ``score_chunk(chunk, offset)`` over a host
    corpus, plus weighted postings (device [B, M]) or a host [B, N]
    combined sparse tensor streamed beside the rows."""
    n = docs_host.shape[0]
    if n == 0 or k < 1:
        raise ValueError(f"a streamed top-{k} of {n} rows")
    kk = min(k, n)  # the running carry's width
    k_chunk = min(kk, chunk_size)  # a chunk contributes at most its rows
    feeds = [_ChunkFeed(docs_host, 0, dtype, chunk_size, device)]
    if sparse_comb_host is not None:
        feeds.append(_ChunkFeed(sparse_comb_host, 1, torch.float32, chunk_size, device))

    def run_chunk(chunk, *rest):
        *sparse, lo = rest
        s = score_chunk(chunk, lo)
        if sparse:
            s = s + sparse[0]
        elif post_ids is not None:
            s = _add_postings(s, post_ids, post_wvals, lo)
        top_s, sel = exact_topk_rows(s, min(k_chunk, s.shape[1]))
        return top_s, sel + lo

    return _host_stream_loop(feeds, n, chunk_size, device, run_chunk, kk, k)


def _one_sparse_form(post_ids, sparse_comb_host) -> None:
    if (post_ids is None) == (sparse_comb_host is None):
        raise ValueError("exactly one sparse representation: postings or a combined tensor")


def dense_topk_host_streamed(
    qflat: torch.Tensor,  # [B, F*E] folded queries (device)
    docs_host,  # CPU tensor / np.ndarray / np.memmap [N, F*E]: the host corpus
    k: int,
    chunk_size: int = HOST_STREAM_CHUNK,
    transfer_dtype: Optional[torch.dtype] = None,  # cast each chunk (and the
    #   queries) to this dtype on the host before its copy
) -> TopK:  # scores [B, k] f32, indices [B, k] int64 (device)
    """Exact top-k over a corpus that never sits in device memory whole: two
    chunk buffers live on the device, copies overlap the scan, and a
    ragged tail chunk and a ``k`` above the chunk size are handled."""
    if transfer_dtype is not None:
        qflat = qflat.to(transfer_dtype)
    return _topk_host_streamed(lambda c, lo: _stream_scores(qflat, c), docs_host,
                               transfer_dtype or _host_dtype(docs_host), k, chunk_size,
                               qflat.device)


def hybrid_topk_host_streamed(
    qflat, docs_host, k, chunk_size=HOST_STREAM_CHUNK, transfer_dtype=None,
    post_ids=None,  # [B, M] global corpus rows (0-padded), device
    post_wvals=None,  # [B, M] f32 weight-premultiplied impacts, device
    sparse_comb_host=None,  # [B, N] host combined sparse scores (the
    #                         fallback for postings denser than the corpus)
) -> TopK:
    """Hybrid twin of :func:`dense_topk_host_streamed`: the postings stay on
    the device and each chunk scatter-adds those in its rows, or the host's
    combined tensor streams chunk by chunk beside the rows."""
    _one_sparse_form(post_ids, sparse_comb_host)
    if transfer_dtype is not None:
        qflat = qflat.to(transfer_dtype)
    return _topk_host_streamed(lambda c, lo: _stream_scores(qflat, c), docs_host,
                               transfer_dtype or _host_dtype(docs_host), k, chunk_size,
                               qflat.device, post_ids, post_wvals, sparse_comb_host)


def _int8_chunk_scorer(qflat, scales):
    """Quantize the queries once; score a streamed int8 chunk against its
    rows' scales, which stay on the device whole (4 bytes a row)."""
    q8, q_scale = quantize_rows_int8(qflat.float())
    scales = as_host_tensor(scales).to(qflat.device)
    return lambda c, lo: int8_scores(q8, q_scale, c, scales[lo : lo + c.shape[0]])


def dense_topk_host_streamed_int8(
    qflat, docs_q_host, scales, k, chunk_size=HOST_STREAM_CHUNK,
) -> TopK:
    """int8 twin of :func:`dense_topk_host_streamed`: each chunk moves one
    byte an element (``docs_q_host`` from :func:`quantize_rows_int8_np` or
    :func:`quantize_rows_int8_into`)."""
    return _topk_host_streamed(_int8_chunk_scorer(qflat, scales), docs_q_host, torch.int8, k,
                               chunk_size, qflat.device)


def hybrid_topk_host_streamed_int8(
    qflat, docs_q_host, scales, k, chunk_size=HOST_STREAM_CHUNK,
    post_ids=None, post_wvals=None, sparse_comb_host=None,
) -> TopK:
    """Hybrid x int8 host stream: the sparse scores stay f32."""
    _one_sparse_form(post_ids, sparse_comb_host)
    return _topk_host_streamed(_int8_chunk_scorer(qflat, scales), docs_q_host, torch.int8, k,
                               chunk_size, qflat.device, post_ids, post_wvals, sparse_comb_host)


# ----------------------------------------------------------------------
# The scatter-free bucketed hybrid ops (mfar_tpu/ops/scoring.py:1078-1445).
# BM25 impacts and post-softmax field weights are non-negative, so a
# document's hybrid score is at least its dense score, and the hybrid top-k
# lies in the union of the dense top-k and the documents with a posting.
# Each chunk keeps its dense top-k and adds one candidate for each distinct
# document among its postings (sorted and bucketed per chunk on the host,
# bucket_postings_np): the dense score read from the chunk's score tile
# plus the segmented sum of the document's impacts (a cumulative sum and
# the run boundaries, no scatter).  A document can enter twice (its dense
# entry and its candidate), so the scan carries 2k entries and a last
# dedup keeps each document's best.  No engine route calls these, as in
# the JAX package, whose engine keeps the scatter.


def bucket_postings_np(ids, vals, fields, n: int, chunk_size: int, pad_multiple: int = 128):
    """Host prep of the bucketed scan: each row's postings sorted by corpus
    row and split into per-chunk buckets ``[B, n_chunks, Mc]`` of a
    ``chunk_size`` scan over ``n`` rows.  Padding postings (value 0; real
    impacts are positive) and a bucket's empty slots carry the sentinel id
    ``n``, outside every chunk.  ``Mc`` is the :func:`bucket_width` of the
    largest count of one (row, chunk).  Bit for bit the JAX package's."""
    from mfar_tpu_torch.native import bucket_width

    ids = np.asarray(ids)
    vals = np.asarray(vals, np.float32)
    fields = np.asarray(fields)
    b, _ = ids.shape
    num_full, tail_len = divmod(n, chunk_size)
    nch = max(num_full + (1 if tail_len else 0), 1)
    ids_eff = np.where(vals != 0, ids, n).astype(np.int64)
    order = np.argsort(ids_eff, axis=1, kind="stable")
    ids_s = np.take_along_axis(ids_eff, order, axis=1)
    vals_s = np.take_along_axis(vals, order, axis=1)
    f_s = np.take_along_axis(fields, order, axis=1)
    edges = np.minimum(np.arange(1, nch + 1) * chunk_size, n)
    bounds = np.zeros((b, nch + 1), np.int64)
    for r in range(b):
        bounds[r, 1:] = np.searchsorted(ids_s[r], edges, side="left")
    counts = np.diff(bounds, axis=1)
    mc = bucket_width(int(counts.max()) if counts.size else 1, pad_multiple)
    out_ids = np.full((b, nch, mc), n, np.int32)
    out_vals = np.zeros((b, nch, mc), np.float32)
    out_f = np.zeros((b, nch, mc), fields.dtype)
    for r in range(b):
        for ch in range(nch):
            s0, s1 = bounds[r, ch], bounds[r, ch + 1]
            if s1 > s0:
                out_ids[r, ch, : s1 - s0] = ids_s[r, s0:s1]
                out_vals[r, ch, : s1 - s0] = vals_s[r, s0:s1]
                out_f[r, ch, : s1 - s0] = f_s[r, s0:s1]
    return out_ids, out_vals, out_f


def _posting_candidates(s: torch.Tensor, bids: torch.Tensor, bwv: torch.Tensor,
                        offset: int) -> TopK:
    """One chunk's posting candidates, without a scatter.  ``s`` [B, c]: the
    chunk's dense scores (-inf past valid_n); ``bids`` [B, Mc]: sorted
    global rows (sentinel >= n); ``bwv`` [B, Mc]: weighted impacts (0 at
    padding).  Returns [B, Mc] scores with one finite entry for each
    distinct in-chunk document (where its run starts), its dense score plus
    its impacts' sum, and -inf elsewhere, and the entries' global rows."""
    b, c = s.shape
    mc = bids.shape[1]
    rel_raw = bids.long() - offset
    in_rng = (rel_raw >= 0) & (rel_raw < c)
    rel = rel_raw.clamp(0, c - 1)
    wv = torch.where(in_rng, bwv.float(), 0.0)
    pos = torch.arange(mc, device=s.device).expand(b, mc)
    prev = torch.cat([torch.full((b, 1), -1, dtype=rel.dtype, device=s.device), rel[:, :-1]], 1)
    is_start = rel != prev
    csum = torch.cat([torch.zeros((b, 1), device=s.device), torch.cumsum(wv, dim=1)], 1)
    # the next run's start after each position: a cumulative min from the
    # right of the start positions, shifted left by one (the clip keeps the
    # ids sorted: sentinels clip to c - 1 at the tail)
    starts = torch.where(is_start, pos, mc)
    nxt_incl = torch.cummin(starts.flip(1), dim=1).values.flip(1)
    nxt = torch.cat([nxt_incl[:, 1:], torch.full((b, 1), mc, device=s.device)], 1)
    seg = csum.gather(1, nxt) - csum.gather(1, pos)
    cand_s = torch.where(is_start, s.gather(1, rel) + seg, float("-inf"))
    return cand_s, offset + rel


def _union_topk(top_s, top_i, cand_s, cand_i, kk: int) -> TopK:
    all_s = torch.cat([top_s, cand_s], dim=1)
    all_i = torch.cat([top_i, cand_i], dim=1)
    s2, sel = exact_topk_rows(all_s, min(kk, all_s.shape[1]))
    return _pad_topk(s2, all_i.gather(1, sel), kk)


def _dedup_topk(top_s: torch.Tensor, top_i: torch.Tensor, k: int) -> TopK:
    """Each document's best entry, then the top k: two stable sorts (score
    descending, then id) put a document's entries together, best first; the
    others drop to -inf."""
    o1 = torch.argsort(-top_s, dim=1, stable=True)
    s1, i1 = top_s.gather(1, o1), top_i.gather(1, o1)
    o2 = torch.argsort(i1, dim=1, stable=True)
    s2, i2 = s1.gather(1, o2), i1.gather(1, o2)
    prev = torch.cat([torch.full_like(i2[:, :1], -1), i2[:, :-1]], dim=1)
    s2 = torch.where(i2 == prev, float("-inf"), s2)
    fs, sel = exact_topk_rows(s2, k)
    return fs, i2.gather(1, sel)


def _hybrid_topk_buckets_impl(dense_chunk_scores, arrays_axes, bucket_ids, bucket_wvals,
                              valid_n: int, k: int, chunk_size: int, n: int) -> TopK:
    """The bucketed scan's loop: ``dense_chunk_scores(*chunk_slices)`` gives
    a chunk's [B, c] dense scores; each chunk's dense top-k and posting
    candidates merge into a running 2k carry, deduplicated at the end."""
    nch = max(-(-n // chunk_size), 1)
    if bucket_ids.shape[1] != nch:
        raise ValueError(f"postings bucketed for {bucket_ids.shape[1]} chunks but the scan "
                         f"has {nch} (n={n}, chunk_size={chunk_size})")
    if n > chunk_size and k > chunk_size:
        raise ValueError("top-k carry must fit in one chunk")
    kk = 2 * k
    out = None
    for ch in range(nch):
        lo, hi = ch * chunk_size, min(n, (ch + 1) * chunk_size)
        s = dense_chunk_scores(*(x.narrow(ax, lo, hi - lo) for x, ax in arrays_axes))
        s = s + _row_bias(lo, hi - lo, valid_n, s.device)
        top_s, sel = exact_topk_rows(s, min(k, hi - lo))
        top_s, top_i = _pad_topk(top_s, sel + lo, k)
        part = _union_topk(top_s, top_i,
                           *_posting_candidates(s, bucket_ids[:, ch], bucket_wvals[:, ch], lo),
                           kk)
        out = part if out is None else _merge_topk(out, part, kk)
    return _dedup_topk(*out, k)


def hybrid_topk_buckets(
    qflat: torch.Tensor,  # [B, F*E] folded queries (dense fields)
    docs_flat: torch.Tensor,  # [N, F*E]
    bucket_ids: torch.Tensor,  # [B, n_chunks, Mc] sorted in-chunk rows (sentinel N)
    bucket_wvals: torch.Tensor,  # [B, n_chunks, Mc] weighted impacts >= 0 (0 padding)
    valid_n: int,
    k: int,
    chunk_size: int = 131072,
) -> TopK:
    """Exact scatter-free hybrid top-k: the ranking of
    :func:`hybrid_topk_chunked` fed the scatter-densified ``[B, N]`` scores
    of the same postings, which never exist here.  Needs non-negative
    weighted impacts."""
    return _hybrid_topk_buckets_impl(lambda c: scores_f32(qflat, c), ((docs_flat, 0),),
                                     bucket_ids, bucket_wvals, valid_n, k, chunk_size,
                                     docs_flat.shape[0])


def hybrid_topk_buckets_int8(
    qflat: torch.Tensor,  # [B, F*E] folded queries (any float dtype)
    docs_q: torch.Tensor,  # [N, F*E] int8
    doc_scales: torch.Tensor,  # [N] f32
    bucket_ids: torch.Tensor,
    bucket_wvals: torch.Tensor,
    valid_n: int,
    k: int,
    chunk_size: int = 131072,
) -> TopK:
    """int8 twin of :func:`hybrid_topk_buckets` (the sparse scores stay f32)."""
    q8, q_scale = quantize_rows_int8(qflat)
    return _hybrid_topk_buckets_impl(lambda c, sc: int8_scores(q8, q_scale, c, sc),
                                     ((docs_q, 0), (doc_scales, 0)), bucket_ids, bucket_wvals,
                                     valid_n, k, chunk_size, docs_q.shape[0])


def _bucket_weighted_vals(weights: torch.Tensor, bucket_vals: torch.Tensor,
                          bucket_field: torch.Tensor, num_dense: int) -> torch.Tensor:
    """Each bucketed posting's raw impact times its sparse field's
    post-softmax weight (padding takes field 0's weight against a 0
    impact)."""
    b, nch, mc = bucket_vals.shape
    idx = num_dense + bucket_field.reshape(b, nch * mc).long()
    return bucket_vals.float() * torch.gather(weights, 1, idx).reshape(b, nch, mc)


def fused_hybrid_topk_buckets_from_query(
    q: torch.Tensor,  # [B, E]
    W: torch.Tensor,
    mask: Optional[torch.Tensor],
    docs_flat: torch.Tensor,  # [N, Fd*E]
    bucket_ids: torch.Tensor,  # [B, n_chunks, Mc] (bucket_postings_np)
    bucket_vals: torch.Tensor,  # [B, n_chunks, Mc] raw impacts
    bucket_field: torch.Tensor,  # [B, n_chunks, Mc] sparse-field index (int8 too)
    valid_n: int,
    num_dense: int,
    k: int,
    chunk_size: int = 131072,
) -> TopK:
    """Scatter-free twin of :func:`fused_hybrid_topk_postings_from_query`:
    weights -> fold -> each posting's field weight -> the bucketed scan."""
    weights = softmax_field_weights(W, q, mask).expand(q.shape[0], -1)
    qflat = fold_queries(q, weights[:, :num_dense]).to(docs_flat.dtype)
    bwv = _bucket_weighted_vals(weights, bucket_vals, bucket_field, num_dense)
    return hybrid_topk_buckets(qflat, docs_flat, bucket_ids, bwv, valid_n, k, chunk_size)


def fused_hybrid_topk_buckets_from_query_int8(
    q, W, mask, docs_q, doc_scales, bucket_ids, bucket_vals, bucket_field, valid_n, num_dense,
    k, chunk_size=131072,
) -> TopK:
    """int8 twin of :func:`fused_hybrid_topk_buckets_from_query`."""
    weights = softmax_field_weights(W, q, mask).expand(q.shape[0], -1)
    qflat = fold_queries(q, weights[:, :num_dense]).float()
    bwv = _bucket_weighted_vals(weights, bucket_vals, bucket_field, num_dense)
    return hybrid_topk_buckets_int8(qflat, docs_q, doc_scales, bucket_ids, bwv, valid_n, k,
                                    chunk_size)
