"""Contrastive loss family in global-batch form: the counterpart of
``mfar_tpu/train/losses.py`` in PyTorch, function for function.

- :func:`contrastive_loss`            <-> ContrastiveLoss (single vector)
- :func:`decomposed_contrastive_loss` <-> DecomposedContrastiveLoss
  (per-field score components mixed by query-conditioned softmax weights)
- :func:`hybrid_contrastive_loss`     <-> HybridContrastiveLoss
  (+ per-field BM25 sparse scores concatenated before mixing)

As in the JAX package: the temperature divides the dense score components
only, never the sparse ones; an optional normalization (batchnorm) runs
over the field axis of the concatenated score tensor, once per direction;
the reverse (doc -> query) direction conditions its field weights on the
query embeddings; negatives enter every query's softmax denominator.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

# normalize_fn: [Q, D, F] score components -> same shape (batchnorm or identity)
NormalizeFn = Callable[[torch.Tensor], torch.Tensor]
# mix_fn: (components [Q, D, F], query_embs [Q, E]) -> [Q, D]
MixFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _diag_nll(scores: torch.Tensor, offset: int = 0, total: Optional[int] = None) -> torch.Tensor:
    """-sum(log softmax diagonal) / total: row i's positive is column
    ``offset + i`` (the rows are global rows ``offset..`` of a batch of
    ``total``; one device: the mean over the diagonal)."""
    log_probs = torch.log_softmax(scores, dim=-1)
    rows = scores.shape[0]
    diag = torch.diagonal(log_probs[:, offset : offset + rows])
    return -diag.mean() if total is None else -diag.sum() / total


def contrastive_loss(
    q: torch.Tensor,  # [B, E]
    d_pos: torch.Tensor,  # [B, E]
    d_neg: Optional[torch.Tensor],  # [B, Nn, E]
    temperature: float = 0.01,
    reverse: bool = True,
    in_batch: bool = True,
) -> torch.Tensor:
    """Single-vector InfoNCE with in-batch + explicit negatives."""
    q, d_pos = q.float(), d_pos.float()
    if in_batch:
        parts = [q @ d_pos.T / temperature]
        if d_neg is not None and d_neg.numel():
            parts.append(q @ d_neg.float().reshape(-1, d_neg.shape[-1]).T / temperature)
        nll = _diag_nll(torch.cat(parts, dim=1))
        if reverse:
            nll = nll + _diag_nll(d_pos @ q.T / temperature)
        return nll
    # simple (own-negatives-only) variant
    pos = torch.einsum("be,be->b", q, d_pos)[:, None] / temperature
    neg = torch.einsum("be,bne->bn", q, d_neg.float()) / temperature
    return -torch.log_softmax(torch.cat([pos, neg], dim=1), dim=-1)[:, 0].mean()


def dense_field_components(
    q: torch.Tensor,  # [B, E]
    d_pos: torch.Tensor,  # [B, F, E]
    d_neg: Optional[torch.Tensor],  # [B, F, Nn, E]
    temperature: float,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Per-field dense score components for every (query, global doc) pair;
    negatives flatten doc-major (doc m's negatives are contiguous)."""
    pos = torch.einsum("be,mfe->bmf", q.float(), d_pos.float()) / temperature
    neg = None
    if d_neg is not None and d_neg.numel():
        b, f, nn_, e = d_neg.shape
        flat = d_neg.float().permute(0, 2, 1, 3).reshape(b * nn_, f, e)
        neg = torch.einsum("be,mfe->bmf", q.float(), flat) / temperature
    return pos, neg


def decomposed_simple_loss(
    q: torch.Tensor,  # [B, E]
    d_pos: torch.Tensor,  # [B, F, E]
    d_neg: torch.Tensor,  # [B, F, Nn, E]
    mix_fn: MixFn,
    temperature: float = 0.01,
    total: Optional[int] = None,  # the global batch's rows, when these are a rank's
) -> torch.Tensor:
    """Multi-field own-negatives-only loss (the reference's
    ``in_batch_negative=False`` branch): each query scores its own positive
    and its own negatives per field; the positive is column 0.  No sparse
    scores and no reverse direction, as in the reference.  On a rank's
    rows, ``total`` makes it their share of the global mean."""
    pos = torch.einsum("be,bfe->bf", q.float(), d_pos.float())[:, None, :] / temperature
    neg = torch.einsum("be,bfne->bnf", q.float(), d_neg.float()) / temperature
    all_scores = torch.cat([mix_fn(pos, q), mix_fn(neg, q)], dim=1)
    nll = -torch.log_softmax(all_scores, dim=-1)[:, 0]
    return nll.mean() if total is None else nll.sum() / total


def decomposed_contrastive_loss(
    q: torch.Tensor,
    d_pos: torch.Tensor,  # [B, F, E]
    d_neg: Optional[torch.Tensor],  # [B, F, Nn, E]
    mix_fn: MixFn,
    temperature: float = 0.01,
    reverse: bool = True,
) -> torch.Tensor:
    """Per-field decomposition, no sparse scores."""
    return hybrid_contrastive_loss(
        q, d_pos, d_neg, None, None, mix_fn, temperature=temperature, reverse=reverse
    )


def hybrid_contrastive_loss(
    q: torch.Tensor,  # [Bl, E]: global rows offset..offset+Bl (one device: all B)
    d_pos: torch.Tensor,  # [B, Fd, E]
    d_neg: Optional[torch.Tensor],  # [B, Fd, Nn, E]
    sparse_pos: Optional[torch.Tensor],  # [B, B, Fs] BM25(query b, pos doc m)
    sparse_neg: Optional[torch.Tensor],  # [B, B*Nn, Fs] doc-major flattened
    mix_fn: MixFn,
    temperature: float = 0.01,
    reverse: bool = True,
    normalize_fn: Optional[NormalizeFn] = None,
    q_all: Optional[torch.Tensor] = None,  # [B, E] every rank's queries
    offset: int = 0,
) -> torch.Tensor:
    """The full mFAR training loss in global-batch form.

    On one device ``q`` holds every query.  On a rank of a data-parallel
    mesh it holds the rank's ``Bl`` queries, global rows ``offset`` on, and
    ``q_all`` the gathered global queries; the documents and the BM25
    scores are the global batch's.  The rank's queries score every global
    document (the positive of local row i is column ``offset + i``); the
    reverse direction scores the rank's own positive documents against
    every global query; both sum their rows' terms over the global B, so
    the ranks' losses sum to the one-device loss."""
    normalize_fn = normalize_fn or (lambda x: x)
    sharded = q_all is not None
    q_all = q if q_all is None else q_all
    b = d_pos.shape[0]
    rows = slice(offset, offset + q.shape[0])
    total = b if sharded else None
    dense_pos, dense_neg = dense_field_components(q, d_pos, d_neg, temperature)

    def with_sparse(dense, sparse, index):
        if sparse is None:
            return dense
        sparse = torch.as_tensor(sparse, device=dense.device)[index]
        return torch.cat([dense, sparse.to(dense.dtype)], dim=-1)

    pos_comp = with_sparse(dense_pos, sparse_pos, rows)  # [Bl, B, Ftot]
    if dense_neg is not None:
        comp = torch.cat([pos_comp, with_sparse(dense_neg, sparse_neg, rows)], dim=1)
    else:
        comp = pos_comp
    nll = _diag_nll(mix_fn(normalize_fn(comp), q), offset, total)  # [Bl, B(+B*Nn)]

    if reverse:
        # doc -> query: every query scores this rank's positive docs; the
        # field weights condition on the query embeddings.  normalize_fn
        # runs a second time per step, as the reference's batchnorm does
        # (both directions).
        rev_dense = torch.einsum("ge,mfe->gmf", q_all.float(), d_pos[rows].float()) / temperature
        rev_scores = mix_fn(normalize_fn(with_sparse(rev_dense, sparse_pos, (slice(None), rows))),
                            q_all)
        # rows = docs, columns = queries; doc offset+i pairs with query offset+i
        nll = nll + _diag_nll(rev_scores.T, offset, total)
    return nll
