"""Distributed retrieval routes over the ranks' mesh: the dense and hybrid
routes of ``mfar_tpu/parallel/topk.py``, over a corpus on the cards in
f32/bf16 or int8, or streamed from host memory.

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

An int8 corpus shards the same way (its rows and their scales), and each
route runs the one-device int8 scan on its block (``torch._int_mm``).

A corpus in host memory shards the same way too: each rank streams its own
block's real rows through the one-device host stream
(:func:`mfar_tpu_torch.ops.scoring._host_stream_loop`), keeps a running
top-k of its rows, and the ranks merge once, after the stream, by the same
all-gather.  The JAX package shards each streamed chunk over the corpus
axes and merges after every chunk (``_mesh_host_stream_loop``); here a
merge per chunk would put a collective, and a wait for every rank, inside
each rank's copy pipeline.  The two give the same top-k (ties aside): a
document in the corpus's top-k is in its block's top-k.

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
    HOST_STREAM_CHUNK,
    TopK,
    _fold_and_densify,
    _one_sparse_form,
    _pad_topk,
    dense_topk_chunked,
    dense_topk_chunked_int8,
    dense_topk_host_streamed,
    dense_topk_host_streamed_int8,
    fold_queries,
    hybrid_topk_chunked,
    hybrid_topk_chunked_int8,
    hybrid_topk_host_streamed,
    hybrid_topk_host_streamed_int8,
    per_field_topk_chunked_approx,
    softmax_field_weights,
)
from mfar_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, shard_rows


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


def _sharded_topk(mesh, axis, query_axis, shard_n, valid_n, k, chunk_size, local_topk) -> TopK:
    """The shared frame of the top-k routes: this shard's geometry (blocks
    of ``shard_n`` rows), its local top-k (``local_topk(local_valid, offset,
    local_k, chunk)`` returns shard-local row ids), the merge over the
    corpus group, and the query slices' gather."""
    n_shards = mesh.size(axis)
    shard_n, local_k, chunk = _shard_geometry(n_shards, shard_n * n_shards, k, chunk_size)
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
    return _sharded_topk(mesh, axis, query_axis, docs.shape[0], valid_n, k, chunk_size,
                         lambda lv, _off, lk, ch: dense_topk_chunked(q, docs, lv, lk, ch))


def _shard_columns(sparse_comb, rows: slice, offset: int, shard_n: int, device) -> torch.Tensor:
    """This shard's columns of a ``[B, N]`` combined sparse tensor (host or
    device) for the query rows ``rows``, zero past the corpus's end."""
    comb = torch.as_tensor(sparse_comb[rows, offset : offset + shard_n])
    if comb.shape[1] < shard_n:  # the padded tail of the corpus
        comb = torch.nn.functional.pad(comb, (0, shard_n - comb.shape[1]))
    return comb.to(device)


def _shard_postings(post_ids, post_vals, offset: int, shard_n: int):
    """The postings whose rows this shard owns, as shard-local ids; the
    others become id 0 with value 0, which adds nothing."""
    ids = post_ids.long() - offset
    mine = (ids >= 0) & (ids < shard_n)
    return torch.where(mine, ids, 0), torch.where(mine, post_vals.float(), 0.0)


def _densify(ids: torch.Tensor, vals: torch.Tensor, shard_n: int) -> torch.Tensor:
    """[B, shard_n] f32 sparse scores: the postings scatter-added."""
    out = torch.zeros(ids.shape[0], shard_n, dtype=torch.float32, device=ids.device)
    return out.scatter_add_(1, ids, vals)


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
    return _combined_topk(
        mesh, qflat, docs.shape[0], docs.device, sparse_comb, valid_n, k, chunk_size, axis,
        query_axis, lambda q, comb, lv, lk, ch: hybrid_topk_chunked(q, docs, comb, lv, lk, ch))


def _combined_topk(mesh, qflat, shard_n, device, sparse_comb, valid_n, k, chunk_size, axis,
                   query_axis, scan) -> TopK:
    """The combined routes' frame: ``scan(q, comb, local_valid, local_k,
    chunk)`` on this shard's columns of the ``[B, N]`` sparse scores."""
    rows = _query_rows(mesh, query_axis, qflat.shape[0])
    q = qflat[rows]

    def local(lv, offset, lk, ch):
        return scan(q, _shard_columns(sparse_comb, rows, offset, shard_n, device), lv, lk, ch)

    return _sharded_topk(mesh, axis, query_axis, shard_n, valid_n, k, chunk_size, local)


def _postings_topk(mesh, qflat, shard_n, post_ids, post_vals, valid_n, k, chunk_size, axis,
                   query_axis, scan) -> TopK:
    """The postings routes' frame: each shard scatter-adds the weighted
    postings that land in its rows into a ``[B, shard_n]`` slice, then
    ``scan(q, comb, local_valid, local_k, chunk)``."""
    rows = _query_rows(mesh, query_axis, qflat.shape[0])
    q, post_ids, post_vals = qflat[rows], post_ids[rows], post_vals[rows]

    def local(lv, offset, lk, ch):
        comb = _densify(*_shard_postings(post_ids, post_vals, offset, shard_n), shard_n)
        return scan(q, comb, lv, lk, ch)

    return _sharded_topk(mesh, axis, query_axis, shard_n, valid_n, k, chunk_size, local)


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
    return _sharded_topk(mesh, axis, query_axis, docs.shape[0], valid_n, k, chunk_size,
                         lambda lv, _off, lk, ch: dense_topk_chunked(qflat, docs, lv, lk, ch))


def distributed_hybrid_topk_postings(
    mesh: Mesh,
    qflat: torch.Tensor,  # [B, F*E] folded queries
    docs: torch.Tensor,  # [shard_n, F*E] this rank's row block
    post_ids: torch.Tensor,  # [B, M] global corpus rows (0-padded)
    post_vals: torch.Tensor,  # [B, M] f32 weight-premultiplied impacts (0-padded)
    valid_n: int,
    k: int,
    chunk_size: int = 131072,
    axis=DATA_AXIS,
    query_axis: Optional[str] = None,
) -> TopK:
    """Exact hybrid top-k fed by postings: each shard scatter-adds the
    postings that land in its rows into a ``[B, shard_n]`` slice and fuses
    it with its dense scan (duplicates sum)."""
    return _postings_topk(
        mesh, qflat, docs.shape[0], post_ids, post_vals, valid_n, k, chunk_size, axis,
        query_axis, lambda q, comb, lv, lk, ch: hybrid_topk_chunked(q, docs, comb, lv, lk, ch))


def _fused_hybrid_postings(mesh, q, W, mask, shard_n, post_ids, post_vals, post_field, valid_n,
                           num_dense, k, chunk_size, axis, query_axis, scan) -> TopK:
    """The fused postings routes' frame: weights, the fold, each posting's
    field weight and the shard's scatter, then ``scan(qflat, comb,
    local_valid, local_k, chunk)`` on the shard's block."""
    rows = _query_rows(mesh, query_axis, q.shape[0])
    q, post_ids, post_vals, post_field = q[rows], post_ids[rows], post_vals[rows], post_field[rows]

    def local(lv, offset, lk, ch):
        ids, vals = _shard_postings(post_ids, post_vals, offset, shard_n)
        qflat, comb = _fold_and_densify(q, W, mask, shard_n, num_dense, ids, vals, post_field)
        return scan(qflat, comb, lv, lk, ch)

    return _sharded_topk(mesh, axis, query_axis, shard_n, valid_n, k, chunk_size, local)


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
    return _fused_hybrid_postings(
        mesh, q, W, mask, docs.shape[0], post_ids, post_vals, post_field, valid_n, num_dense, k,
        chunk_size, axis, query_axis,
        lambda qflat, comb, lv, lk, ch: hybrid_topk_chunked(qflat.to(docs.dtype), docs, comb,
                                                            lv, lk, ch))


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
        mesh, axis, query_axis, docs.shape[0], valid_n, k, chunk_size,
        lambda lv, _off, lk, ch: per_field_topk_chunked_approx(q, docs, lv, num_fields, lk, ch))


def _owned_candidate_scores(mesh, axis, query_axis, q, cand_ids, shard_n, num_fields,
                            rows_of) -> torch.Tensor:
    """Stage 2's frame: ``rows_of(local_ids)`` gives the ``[B, C, F*E]`` rows
    of this shard's ids; the candidates it does not own read row 0 and
    score zero, and an all-reduce over the corpus group sums the shards."""
    rows = _query_rows(mesh, query_axis, q.shape[0])
    q, cand_ids = q[rows], cand_ids[rows]
    local = cand_ids.long() - mesh.index(axis) * shard_n
    mine = (local >= 0) & (local < shard_n)
    gathered = rows_of(torch.where(mine, local, 0))  # [B, C, F*E]
    b, c = cand_ids.shape
    scores = torch.einsum("be,bcfe->bcf", q.float(),
                          gathered.view(b, c, num_fields, -1).float())
    scores = mesh.all_reduce_sum(axis, torch.where(mine[..., None], scores, 0.0))
    return _gather_queries(mesh, query_axis, scores)


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
    return _owned_candidate_scores(mesh, axis, query_axis, q, cand_ids, docs.shape[0],
                                   num_fields, lambda ids: docs[ids])


# ----------------------------------------------------------------------
# The int8 corpus (mfar_tpu/parallel/topk.py:384-614, :1107-1191): each
# rank holds its block's int8 rows and their f32 scales.


def distributed_dense_topk_int8(
    mesh: Mesh,
    qflat: torch.Tensor,  # [B, F*E] folded queries (any float dtype; quantized here)
    docs_q: torch.Tensor,  # [shard_n, F*E] int8 rows of this rank's block
    doc_scales: torch.Tensor,  # [shard_n] f32 scales of those rows
    valid_n: int,
    k: int,
    chunk_size: int = 131072,
    axis=DATA_AXIS,
    query_axis: Optional[str] = None,
) -> TopK:
    """int8 twin of :func:`distributed_dense_topk`: the quantized corpus
    (half of bf16's bytes, so twice the documents a mesh) shards over the
    corpus axes, each shard runs the int8 chunked scan and the lists merge.
    It also stands for the JAX package's ``exact=False`` form (rerank's
    recall), whose selection is exact here."""
    q = qflat[_query_rows(mesh, query_axis, qflat.shape[0])]
    return _sharded_topk(
        mesh, axis, query_axis, docs_q.shape[0], valid_n, k, chunk_size,
        lambda lv, _off, lk, ch: dense_topk_chunked_int8(q, docs_q, doc_scales, lv, lk, ch))


def distributed_hybrid_topk_postings_int8(
    mesh: Mesh,
    qflat: torch.Tensor,  # [B, F*E] folded queries
    docs_q: torch.Tensor,  # [shard_n, F*E] int8
    doc_scales: torch.Tensor,  # [shard_n] f32
    post_ids: torch.Tensor,  # [B, M] global corpus rows
    post_vals: torch.Tensor,  # [B, M] f32 weight-premultiplied impacts
    valid_n: int,
    k: int,
    chunk_size: int = 131072,
    axis=DATA_AXIS,
    query_axis: Optional[str] = None,
) -> TopK:
    """int8 twin of :func:`distributed_hybrid_topk_postings` (the sparse
    scores stay f32)."""
    return _postings_topk(
        mesh, qflat, docs_q.shape[0], post_ids, post_vals, valid_n, k, chunk_size, axis,
        query_axis, lambda q, comb, lv, lk, ch: hybrid_topk_chunked_int8(q, docs_q, doc_scales,
                                                                         comb, lv, lk, ch))


def distributed_hybrid_topk_int8(
    mesh: Mesh,
    qflat: torch.Tensor,  # [B, F*E] folded queries
    docs_q: torch.Tensor,  # [shard_n, F*E] int8
    doc_scales: torch.Tensor,  # [shard_n] f32
    sparse_comb,  # [B, N] combined sparse scores of the whole corpus (host or device)
    valid_n: int,
    k: int,
    chunk_size: int = 131072,
    axis=DATA_AXIS,
    query_axis: Optional[str] = None,
) -> TopK:
    """int8 twin of :func:`distributed_hybrid_topk` (the host-combined
    fallback)."""
    return _combined_topk(
        mesh, qflat, docs_q.shape[0], docs_q.device, sparse_comb, valid_n, k, chunk_size, axis,
        query_axis, lambda q, comb, lv, lk, ch: hybrid_topk_chunked_int8(q, docs_q, doc_scales,
                                                                         comb, lv, lk, ch))


def distributed_fused_hybrid_topk_postings_int8(
    mesh: Mesh,
    q: torch.Tensor,  # [B, E]
    W: torch.Tensor,  # mixer weight (all F fields, dense first)
    mask: Optional[torch.Tensor],
    docs_q: torch.Tensor,  # [shard_n, Fd*E] int8
    doc_scales: torch.Tensor,  # [shard_n] f32
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
    """int8 twin of :func:`distributed_fused_hybrid_topk_postings`: the fold
    in f32, then each shard's scatter and quantized scan."""
    return _fused_hybrid_postings(
        mesh, q, W, mask, docs_q.shape[0], post_ids, post_vals, post_field, valid_n, num_dense,
        k, chunk_size, axis, query_axis,
        lambda qflat, comb, lv, lk, ch: hybrid_topk_chunked_int8(qflat.float(), docs_q,
                                                                 doc_scales, comb, lv, lk, ch))


def distributed_candidate_scores_int8(
    mesh: Mesh,
    q: torch.Tensor,  # [B, E]
    docs_q: torch.Tensor,  # [shard_n, F*E] int8
    doc_scales: torch.Tensor,  # [shard_n] f32
    cand_ids: torch.Tensor,  # [B, C] global rows
    num_fields: int,
    axis=DATA_AXIS,
    query_axis: Optional[str] = None,
) -> torch.Tensor:  # [B, C, F] f32 per-field dense scores (dequantized rows)
    """int8 twin of :func:`distributed_candidate_scores`: each shard
    dequantizes only the candidate rows it owns."""
    return _owned_candidate_scores(
        mesh, axis, query_axis, q, cand_ids, docs_q.shape[0], num_fields,
        lambda ids: docs_q[ids].float() * doc_scales[ids][..., None])


# ----------------------------------------------------------------------
# The host-streamed corpus (mfar_tpu/parallel/topk.py:787-1104).  A rank's
# host rows are the real rows of its block (block_rows).  A memmap view of
# those rows pages in only them.


def block_rows(valid_n: int, mesh: Mesh, axis) -> Tuple[int, int]:
    """(offset, rows) of this rank's real rows of a ``valid_n``-row corpus:
    its block's start and the rows of the block that hold documents (0 for
    a block of padding only)."""
    offset, shard_n = shard_rows(valid_n, mesh, axis)
    return offset, int(np.clip(valid_n - offset, 0, shard_n))


def _streamed_topk(mesh, axis, query_axis, docs_host, valid_n, k, q, stream) -> TopK:
    """The mesh host streams' frame: ``stream(local_k, offset)`` streams
    this rank's host rows and returns its top ``local_k`` (block-local
    ids); a block of padding only gives ``-inf`` without a stream."""
    offset, rows = block_rows(valid_n, mesh, axis)
    if docs_host.shape[0] != rows:
        raise ValueError(f"rank {mesh.rank} holds {docs_host.shape[0]} host rows; its block "
                         f"at row {offset} has {rows} of the corpus's {valid_n}")
    shard_n = shard_rows(valid_n, mesh, axis)[1]

    def local(lv, off, lk, _ch):
        if lv == 0:
            return (torch.full((q.shape[0], lk), float("-inf"), device=q.device),
                    torch.zeros((q.shape[0], lk), dtype=torch.int64, device=q.device))
        return stream(lk, off)

    return _sharded_topk(mesh, axis, query_axis, shard_n, valid_n, k, shard_n, local)


def _block_sparse(rows: slice, offset: int, n_rows: int, post_ids, post_wvals, sparse_comb_host):
    """The hybrid streams' sparse operands for this rank's rows: postings
    with block-local ids (the others fall outside every chunk), or the
    block's columns of the host's ``[B, N]`` tensor (a view, streamed chunk
    by chunk)."""
    _one_sparse_form(post_ids, sparse_comb_host)
    if post_ids is not None:
        return dict(post_ids=post_ids[rows].long() - offset, post_wvals=post_wvals[rows])
    return dict(sparse_comb_host=sparse_comb_host[rows, offset : offset + n_rows])


def distributed_dense_topk_host_streamed(
    mesh: Mesh,
    qflat: torch.Tensor,  # [B, F*E] folded queries (device)
    docs_host,  # [rows, F*E] this rank's real rows (block_rows): CPU tensor / array / memmap
    valid_n: int,  # rows of the whole corpus
    k: int,
    chunk_size: int = HOST_STREAM_CHUNK,
    transfer_dtype: Optional[torch.dtype] = None,
    axis=DATA_AXIS,
    query_axis: Optional[str] = None,
) -> TopK:  # [B, k] scores, [B, k] global row ids
    """Mesh twin of :func:`mfar_tpu_torch.ops.scoring.dense_topk_host_streamed`:
    each rank streams its rows over its own PCIe link, so the mesh reads
    the corpus at the sum of the cards' links; one merge at the end."""
    q = qflat[_query_rows(mesh, query_axis, qflat.shape[0])]
    return _streamed_topk(
        mesh, axis, query_axis, docs_host, valid_n, k, q,
        lambda lk, _off: dense_topk_host_streamed(q, docs_host, lk, chunk_size, transfer_dtype))


def distributed_dense_topk_host_streamed_int8(
    mesh: Mesh,
    qflat: torch.Tensor,  # [B, F*E] folded queries
    docs_q_host,  # [rows, F*E] int8 rows of this rank's block (host)
    scales,  # [rows] f32 scales of those rows (host or device)
    valid_n: int,
    k: int,
    chunk_size: int = HOST_STREAM_CHUNK,
    axis=DATA_AXIS,
    query_axis: Optional[str] = None,
) -> TopK:
    """int8 twin of :func:`distributed_dense_topk_host_streamed`: each link
    moves one byte an element."""
    q = qflat[_query_rows(mesh, query_axis, qflat.shape[0])]
    return _streamed_topk(
        mesh, axis, query_axis, docs_q_host, valid_n, k, q,
        lambda lk, _off: dense_topk_host_streamed_int8(q, docs_q_host, scales, lk, chunk_size))


def distributed_hybrid_topk_host_streamed(
    mesh: Mesh,
    qflat: torch.Tensor,  # [B, Fd*E] folded queries
    docs_host,  # [rows, Fd*E] this rank's real rows (host)
    valid_n: int,
    k: int,
    chunk_size: int = HOST_STREAM_CHUNK,
    transfer_dtype: Optional[torch.dtype] = None,
    post_ids=None,  # [B, M] global corpus rows (0-padded), device
    post_wvals=None,  # [B, M] f32 weight-premultiplied impacts, device
    sparse_comb_host=None,  # [B, N] host combined sparse scores of the whole corpus
    axis=DATA_AXIS,
    query_axis: Optional[str] = None,
) -> TopK:
    """Hybrid twin of :func:`distributed_dense_topk_host_streamed`: each
    rank's chunks add the postings that land in its rows, or stream its
    columns of the host's combined tensor beside its rows."""
    rows = _query_rows(mesh, query_axis, qflat.shape[0])
    q = qflat[rows]

    def stream(lk, offset):
        return hybrid_topk_host_streamed(
            q, docs_host, lk, chunk_size, transfer_dtype,
            **_block_sparse(rows, offset, docs_host.shape[0], post_ids, post_wvals,
                            sparse_comb_host))

    return _streamed_topk(mesh, axis, query_axis, docs_host, valid_n, k, q, stream)


def distributed_hybrid_topk_host_streamed_int8(
    mesh: Mesh,
    qflat: torch.Tensor,
    docs_q_host,  # [rows, Fd*E] int8 rows of this rank's block (host)
    scales,  # [rows] f32
    valid_n: int,
    k: int,
    chunk_size: int = HOST_STREAM_CHUNK,
    post_ids=None,
    post_wvals=None,
    sparse_comb_host=None,
    axis=DATA_AXIS,
    query_axis: Optional[str] = None,
) -> TopK:
    """Hybrid x int8 x mesh host stream: the sparse scores stay f32."""
    rows = _query_rows(mesh, query_axis, qflat.shape[0])
    q = qflat[rows]

    def stream(lk, offset):
        return hybrid_topk_host_streamed_int8(
            q, docs_q_host, scales, lk, chunk_size,
            **_block_sparse(rows, offset, docs_q_host.shape[0], post_ids, post_wvals,
                            sparse_comb_host))

    return _streamed_topk(mesh, axis, query_axis, docs_q_host, valid_n, k, q, stream)
