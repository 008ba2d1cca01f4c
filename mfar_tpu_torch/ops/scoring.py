"""Multi-field scoring ops in PyTorch: counterpart of ``mfar_tpu/ops/scoring.py``
for the single-device serving paths, dense and hybrid (dense + BM25).

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
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

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
    fused chunked hybrid top-k.  Raw impacts ship from the host; each
    posting picks up its field's post-softmax weight here, so the weights
    never leave the device.  A document hit by several terms or fields
    appears once per posting and the scatter sums them (on a card with
    atomics, in an order that varies: equal within float rounding)."""
    b = q.shape[0]
    weights = softmax_field_weights(W, q, mask)
    weights = weights.expand(b, weights.shape[-1])
    qflat = fold_queries(q, weights[:, :num_dense]).to(docs_flat.dtype)
    # the field index ships as int8: widen before the gather
    w_sparse = torch.gather(weights, 1, num_dense + post_field.long())  # [B, M]
    sparse_comb = torch.zeros(b, docs_flat.shape[0], dtype=torch.float32, device=q.device)
    sparse_comb.scatter_add_(1, post_ids.long(), post_vals.float() * w_sparse)
    return hybrid_topk_chunked(qflat, docs_flat, sparse_comb, valid_n, k, chunk_size)
