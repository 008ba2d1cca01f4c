"""Distributed retrieval routes over the ranks' mesh: the dense and hybrid
routes of ``mfar_tpu/parallel/topk.py``.

The corpus shards its rows over the corpus axes in contiguous blocks: shard
``i`` holds rows ``[i * shard_n, (i + 1) * shard_n)`` of the corpus padded
to a multiple of the shard count, and every route takes this rank's block
(``docs``) only.  Each shard runs the port's one-device scan
(:mod:`mfar_tpu_torch.ops.scoring`) over its block with ``local_valid =
clip(valid_n - offset, 0, shard_n)`` and keeps a local top-``local_k``;
the ``[B, local_k]`` lists are all-gathered over the corpus group and a
top-k of ``[B, n_shards * local_k]`` gives the result, padded with ``-inf``
to k (:func:`merge_topk_lists`).  Rerank's stage 2
(:func:`distributed_candidate_scores`) scores on each shard only the
candidates it owns and an all-reduce sums the ``[B, C, F]`` tensor.

``query_axis``: with a corpus per slice and several replicas, the replica
groups serve disjoint slices of the query batch, and the results are
all-gathered over that axis, so every rank holds the whole batch's answer.

The collectives run on the card under NCCL.  Under gloo they take host
tensors: the routes copy their ``[B, k]`` lists (or ``[B, C, F]`` scores)
to the host and back, the only difference between the two backends.  Every
rank of a group issues the same collectives in the same order; a route
returns device tensors that a caller fetches later without another
collective.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from mfar_tpu_torch.ops.scoring import (
    TopK,
    _fold_and_densify,
    _pad_topk,
    dense_topk_chunked,
    fold_queries,
    hybrid_topk_chunked,
    per_field_topk_chunked_approx,
    softmax_field_weights,
)
from mfar_tpu_torch.parallel.mesh import DATA_AXIS, Mesh


def _shard_geometry(n_shards: int, n: int, k: int, chunk_size: int) -> Tuple[int, int, int]:
    """(shard_n, local_k, chunk_size) for an ``n``-row padded corpus over
    ``n_shards`` shards.  The streamed scans take a ragged tail chunk, so
    the chunk need not divide ``shard_n``; it only has to hold the local
    top-k carry."""
    if n % n_shards:
        raise ValueError(f"corpus rows ({n}) must divide the corpus axes ({n_shards} shards);"
                         f" pad rows first (RetrievalEngine does this)")
    shard_n = n // n_shards
    local_k = min(k, shard_n)
    return shard_n, local_k, max(min(chunk_size, shard_n), local_k)


def merge_topk_lists(cs: torch.Tensor, ci: torch.Tensor, k: int) -> TopK:
    """[..., n_shards * local_k] candidate lists -> the top k along the last
    axis, padded with -inf scores (index 0) when fewer than k exist."""
    top_s, sel = torch.topk(cs, min(k, cs.shape[-1]), dim=-1)
    top_i = torch.gather(ci, -1, sel)
    if top_s.shape[-1] == k:
        return top_s, top_i
    lead = top_s.shape[:-1]
    s2, i2 = _pad_topk(top_s.reshape(-1, top_s.shape[-1]), top_i.reshape(-1, top_i.shape[-1]), k)
    return s2.reshape(*lead, k), i2.reshape(*lead, k)


def _query_rows(mesh: Mesh, query_axis: Optional[str], b: int) -> slice:
    """This rank's rows of a ``b``-query batch: its replica group's slice
    under ``query_axis``, else all of them."""
    if query_axis is None:
        return slice(0, b)
    r = mesh.size(query_axis)
    if b % r:
        raise ValueError(f"a batch of {b} queries does not divide over {r} {query_axis} groups")
    i = mesh.index(query_axis)
    return slice(i * (b // r), (i + 1) * (b // r))


def _gather_queries(mesh: Mesh, query_axis: Optional[str], *parts: torch.Tensor):
    """Whole-batch results from each replica group's slice (query_axis)."""
    if query_axis is None:
        return parts if len(parts) > 1 else parts[0]
    out = tuple(torch.cat(mesh.all_gather(query_axis, p), dim=0) for p in parts)
    return out if len(out) > 1 else out[0]


def _sharded_topk(mesh, axis, query_axis, docs, valid_n, k, chunk_size, local_topk) -> TopK:
    """The shared frame of the top-k routes: this shard's geometry, its
    local top-k (``local_topk(local_valid, offset, local_k, chunk)`` returns
    shard-local row ids), the merge over the corpus group, and the query
    slices' gather."""
    n_shards = mesh.size(axis)
    shard_n, local_k, chunk = _shard_geometry(n_shards, docs.shape[0] * n_shards, k,
                                              chunk_size)
    offset = mesh.index(axis) * shard_n
    local_valid = int(np.clip(valid_n - offset, 0, shard_n))
    loc_s, loc_i = local_topk(local_valid, offset, local_k, chunk)
    loc_i = loc_i + offset
    cs = torch.cat(mesh.all_gather(axis, loc_s), dim=-1)
    ci = torch.cat(mesh.all_gather(axis, loc_i), dim=-1)
    return _gather_queries(mesh, query_axis, *merge_topk_lists(cs, ci, k))


def distributed_dense_topk(
    mesh: Mesh,
    qflat: torch.Tensor,  # [B, F*E] folded queries (the same on every rank)
    docs: torch.Tensor,  # [shard_n, F*E] this rank's row block
    valid_n: int,  # real rows of the whole corpus
    k: int,
    chunk_size: int = 131072,
    axis=DATA_AXIS,
    query_axis: Optional[str] = None,
) -> TopK:  # [B, k] scores, [B, k] global row ids
    q = qflat[_query_rows(mesh, query_axis, qflat.shape[0])]
    return _sharded_topk(mesh, axis, query_axis, docs, valid_n, k, chunk_size,
                         lambda lv, _off, lk, ch: dense_topk_chunked(q, docs, lv, lk, ch))


def distributed_hybrid_topk(
    mesh: Mesh,
    qflat: torch.Tensor,  # [B, F*E] folded queries
    docs: torch.Tensor,  # [shard_n, F*E] this rank's row block
    sparse_comb,  # [B, N] combined sparse scores of the whole corpus (host or device)
    valid_n: int,
    k: int,
    chunk_size: int = 131072,
    axis=DATA_AXIS,
    query_axis: Optional[str] = None,
) -> TopK:
    """Exact hybrid top-k from the host-mixed ``[B, N]`` sparse scores: each
    rank adds its rows' columns (zero past the corpus) to its dense scan."""
    rows = _query_rows(mesh, query_axis, qflat.shape[0])
    q = qflat[rows]

    def local(lv, offset, lk, ch):
        comb = torch.as_tensor(sparse_comb[rows, offset : offset + docs.shape[0]])
        if comb.shape[1] < docs.shape[0]:  # the padded tail of the corpus
            comb = torch.nn.functional.pad(comb, (0, docs.shape[0] - comb.shape[1]))
        return hybrid_topk_chunked(q, docs, comb.to(docs.device), lv, lk, ch)

    return _sharded_topk(mesh, axis, query_axis, docs, valid_n, k, chunk_size, local)


def distributed_fused_dense_topk(
    mesh: Mesh,
    q: torch.Tensor,  # [B, E] query embeddings
    W: torch.Tensor,  # mixer weight [E, F] or [F, 1]/[1, F]
    mask: Optional[torch.Tensor],  # [F] ablation mask or None
    docs: torch.Tensor,  # [shard_n, Fd*E] this rank's row block
    valid_n: int,
    num_dense: int,
    k: int,
    chunk_size: int = 131072,
    axis=DATA_AXIS,
    query_axis: Optional[str] = None,
) -> TopK:
    """Mesh twin of :func:`mfar_tpu_torch.ops.scoring.fused_dense_topk_from_query`:
    softmax field weights, the fold, then each shard's scan and the merge."""
    q = q[_query_rows(mesh, query_axis, q.shape[0])]
    weights = softmax_field_weights(W, q, mask).expand(q.shape[0], -1)
    qflat = fold_queries(q, weights[:, :num_dense]).to(docs.dtype)
    return _sharded_topk(mesh, axis, query_axis, docs, valid_n, k, chunk_size,
                         lambda lv, _off, lk, ch: dense_topk_chunked(qflat, docs, lv, lk, ch))


def distributed_fused_hybrid_topk_postings(
    mesh: Mesh,
    q: torch.Tensor,  # [B, E]
    W: torch.Tensor,  # mixer weight (all F fields, dense first)
    mask: Optional[torch.Tensor],
    docs: torch.Tensor,  # [shard_n, Fd*E] this rank's row block
    post_ids: torch.Tensor,  # [B, M] global corpus rows (0-padded)
    post_vals: torch.Tensor,  # [B, M] f32 raw impacts (0-padded)
    post_field: torch.Tensor,  # [B, M] sparse-field index per posting
    valid_n: int,
    num_dense: int,
    k: int,
    chunk_size: int = 131072,
    axis=DATA_AXIS,
    query_axis: Optional[str] = None,
) -> TopK:
    """Mesh twin of
    :func:`mfar_tpu_torch.ops.scoring.fused_hybrid_topk_postings_from_query`:
    raw impacts ship from the host, each posting picks up its field's
    softmax weight on the device, and each shard scatter-adds the postings
    whose rows it owns before its hybrid scan."""
    rows = _query_rows(mesh, query_axis, q.shape[0])
    q, post_ids, post_vals, post_field = q[rows], post_ids[rows], post_vals[rows], post_field[rows]

    def local(lv, offset, lk, ch):
        shard_n = docs.shape[0]
        ids = post_ids.long() - offset
        mine = (ids >= 0) & (ids < shard_n)
        qflat, comb = _fold_and_densify(
            q, W, mask, shard_n, num_dense, torch.where(mine, ids, 0),
            torch.where(mine, post_vals.float(), 0.0), post_field)
        return hybrid_topk_chunked(qflat.to(docs.dtype), docs, comb, lv, lk, ch)

    return _sharded_topk(mesh, axis, query_axis, docs, valid_n, k, chunk_size, local)


def distributed_per_field_topk(
    mesh: Mesh,
    q: torch.Tensor,  # [B, E] query embeddings (not folded)
    docs: torch.Tensor,  # [shard_n, F*E] this rank's row block
    valid_n: int,
    num_fields: int,
    k: int,
    chunk_size: int = 131072,
    axis=DATA_AXIS,
    query_axis: Optional[str] = None,
) -> TopK:  # [B, F, k] scores, [B, F, k] global row ids
    """Rerank's stage 1 over the mesh: one pass per shard gives all F
    per-field local top-ks; the [B, F, n_shards * local_k] candidates merge
    per field."""
    q = q[_query_rows(mesh, query_axis, q.shape[0])]
    return _sharded_topk(
        mesh, axis, query_axis, docs, valid_n, k, chunk_size,
        lambda lv, _off, lk, ch: per_field_topk_chunked_approx(q, docs, lv, num_fields, lk, ch))


def distributed_candidate_scores(
    mesh: Mesh,
    q: torch.Tensor,  # [B, E]
    docs: torch.Tensor,  # [shard_n, F*E] this rank's row block
    cand_ids: torch.Tensor,  # [B, C] global rows (padding entries any row)
    num_fields: int,
    axis=DATA_AXIS,
    query_axis: Optional[str] = None,
) -> torch.Tensor:  # [B, C, F] f32 per-field dense scores
    """Rerank's stage 2 over the mesh: each shard gathers and scores only
    the candidates whose rows it owns, writes zeros elsewhere, and an
    all-reduce over the corpus group sums the [B, C, F] tensor (only scores
    cross the interconnect, never rows)."""
    rows = _query_rows(mesh, query_axis, q.shape[0])
    q, cand_ids = q[rows], cand_ids[rows]
    shard_n = docs.shape[0]
    local = cand_ids.long() - mesh.index(axis) * shard_n
    mine = (local >= 0) & (local < shard_n)
    gathered = docs[torch.where(mine, local, 0)]  # [B, C, F*E]
    b, c = cand_ids.shape
    scores = torch.einsum("be,bcfe->bcf", q.float(),
                          gathered.view(b, c, num_fields, -1).float())
    scores = mesh.all_reduce_sum(axis, torch.where(mine[..., None], scores, 0.0))
    return _gather_queries(mesh, query_axis, scores)
