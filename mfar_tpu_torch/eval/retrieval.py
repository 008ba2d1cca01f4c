"""The retrieval engine: query -> top-k documents, on one device, over a
dense corpus, BM25 (sparse) fields, or both (hybrid).

Counterpart of ``mfar_tpu/eval/retrieval.py`` for the single-device paths,
with the same constructor arguments (plus ``device``) and the same two
modes:

- ``exact`` (what ``auto`` means): softmax field weights fold into the
  query and the full corpus is scored in one matmul per chunk with a running
  exact top-k (``singlechip-dense``; ``singlechip-int8-dense`` over an int8
  corpus, ``host-stream-dense[-int8]`` over a corpus in host memory).
  Hybrid: each sparse field's BM25
  engine gives the batch's query-term postings on the host (row ids and raw
  impacts), which scatter-add on the device, each weighted by its field's
  softmax weight, into the dense scan (``singlechip-hybrid-postings``);
  when the postings are denser than half the corpus, the host sums the
  weighted full-corpus BM25 scores instead (``singlechip-hybrid-combined``).
  A corpus with no dense matrix is scored on the host (``host-sparse-only``).
  The int8 and host-streamed corpora have the same two hybrid routes
  (``singlechip-int8-hybrid-{postings,combined}``,
  ``host-stream-hybrid[-int8]-{postings,combined}``).
- ``rerank`` (the reference-compatible pipeline): stage 1 takes each dense
  field's own top-``recall_k`` over the corpus in one pass, and each sparse
  field's BM25 top-``recall_k`` on the host; the per-query candidate union
  (``np.unique``) pads to a geometric width; stage 2 scores every
  candidate's fields and mixes them with the query-conditioned weights.
  Stage 2's dense scores come from kernel K1
  (:func:`mfar_tpu_torch.ops.gather_scores.gather_per_field_scores`), which
  reads candidate rows from the corpus in place
  (``singlechip-rerank[-hybrid]-k1``), or, with ``pallas_cross_row``, from
  its cross-row schedule K1x (``...-k1x``), or from a plain gather;
  its sparse columns are gathered from the full BM25 score vectors.  An
  int8 or host-streamed corpus recalls through one-hot folded queries (one
  folded scan gives each field's own scores) and scores its candidates
  without K1: the int8 rows dequantized on the device, the host corpus's
  rows gathered on the host.

``quantize="int8"`` keeps the corpus as int8 rows and an f32 scale a row
(half of bf16's memory); ``corpus_on_host`` keeps it in host memory (RAM or
a memmap) and streams it to the device per scan, through pinned memory and
a copy stream (:func:`mfar_tpu_torch.ops.scoring.dense_topk_host_streamed`);
the two compose.

``mesh`` (:mod:`mfar_tpu_torch.parallel.mesh`, one rank per card) shards
the corpus rows over the ranks: each rank places only its block of the flat
matrix (zero-padded at the tail; from an ``.npy`` memmap it reads only those
rows), the mixer and the queries stay replicated, and the routes of
:mod:`mfar_tpu_torch.parallel.topk` merge the shards' top-ks:
``mesh-dense``, ``mesh-hybrid-postings``, ``mesh-hybrid-combined``, and
rerank ``mesh-rerank[-hybrid]`` (per-field recall, then each shard scores
the candidates it owns; the sparse stages stay on the host).  An int8
corpus shards the same way, each rank quantizing its block a slab of rows
at a time from the source (``mesh-int8-{dense,hybrid-postings,
hybrid-combined}``, rerank ``mesh-rerank[-hybrid]-int8``).  A corpus in
host memory keeps each rank's block's rows on its host and each rank
streams them (``host-stream-{dense,hybrid}[-int8]-mesh[-{postings,
combined}]``); rerank's stage 2 gathers the candidates from the corpus the
caller passed, on every rank, as one device does
(``host-stream-rerank[-hybrid]-{rows,int8}-mesh``).  With
``corpus_per_slice`` and several replicas, the replica groups serve disjoint
slices of the query batch.  Every collective of a call is issued in its
dispatch half, none in :meth:`RetrievalEngine.finish`.

A query's answer does not depend on its batch, as in the JAX daemon's one
compiled shape, nor on the run: :meth:`RetrievalEngine.encode_queries`
runs the encoder in calls of one row count a bucket width
(:func:`query_call_rows`); the products of query rows with the corpus and
the mixer run in blocks of one row count
(:func:`mfar_tpu_torch.ops.scoring.query_row_blocks`); rerank's stage-2
dots of gathered rows sum in one fixed order whatever the batch and its
candidate count (K1 and K1x sum each candidate's field in one order
whatever their grid); and the hybrid routes sum a document's postings in
one fixed order with no scatter-add
(:func:`mfar_tpu_torch.ops.scoring.sum_postings`).  Among queries of one
bucket width, a query's answer is the same bits alone, in any batch and
in any run.

``pallas_cross_row`` keeps the JAX engine's semantics: it needs the K1
gather (``use_pallas_gather=False`` raises before any work), sends the
one-device K1 route through K1x, and changes nothing where the JAX flag
changes nothing (a mesh, an int8 or host-streamed corpus, exact mode, a
corpus K1 cannot read).
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mfar_tpu_torch.data import trec
from mfar_tpu_torch.data.schema import dense_keys, sparse_keys
from mfar_tpu_torch.data.types import Field
from mfar_tpu_torch.native import bucket_width
from mfar_tpu_torch.ops.gather_scores import gather_per_field_scores
from mfar_tpu_torch.ops.scoring import (
    SCORE_ROWS,
    as_host_tensor,
    dense_topk_chunked_int8,
    dense_topk_host_streamed,
    dense_topk_host_streamed_int8,
    fold_queries,
    fused_dense_topk_from_query,
    fused_dense_topk_from_query_int8,
    fused_hybrid_topk_postings_from_query,
    fused_hybrid_topk_postings_from_query_int8,
    hybrid_topk_chunked,
    hybrid_topk_chunked_int8,
    hybrid_topk_host_streamed,
    hybrid_topk_host_streamed_int8,
    onehot_queries,
    per_field_candidate_scores,
    per_field_topk_chunked_approx,
    pinned_empty,
    quantize_rows_int8_into,
    quantize_slab,
    rerank_candidates,
    softmax_field_weights,
)
from mfar_tpu_torch.parallel import topk as mesh_topk
from mfar_tpu_torch.parallel.mesh import REPLICA_AXIS, corpus_sharding, shard_rows
from mfar_tpu_torch.train.data_pipeline import clean_query
from mfar_tpu_torch.train.model import FieldMixer
from mfar_tpu_torch.utils.device import DeviceLike, resolve_device

# Corpus chunk floor for the streaming top-k scans (a ragged tail chunk
# streams too, so the corpus needs no chunk-multiple padding).
TOPK_CHUNK = 131072

# f32 score-tile budget for one streamed chunk ([B, chunk] f32).
TOPK_SCORE_TILE_BYTES = 1 << 30

# The query encoder runs a batch at bucket width W in calls of
# query_call_rows(W) rows (the tail call padded with copies of the last
# query), so each width has one encoder shape, whatever the batch.  cuBLAS
# picks a kernel by shape, and so an order of summation (the plain
# attention's f32 logits of 8 queries and of 16 take two kernels on the
# H100), so a query encoded in calls of another row count gets other bits,
# which bf16 layers carry up to a 6e-3 move of its scores; at one shape its
# row is the same bits in any batch, as in the JAX daemon, which pads every
# batch to one compiled shape.  QUERY_CALL_TOKENS: the serving daemon's
# full batch of 256 queries at the 16-token bucket in one call.
# QUERY_CALL_MIN_ROWS: a serving batch of 64 long queries in one call too,
# since every call costs the host a fixed run of eager operators (at 16 rows
# a call, 64 queries of the 256-token bucket took 3x as long).
QUERY_CALL_TOKENS, QUERY_CALL_MIN_ROWS = 4096, 64


def query_call_rows(width: int) -> int:
    """Rows in every query encoder call at bucket width ``width``."""
    return max(QUERY_CALL_MIN_ROWS, QUERY_CALL_TOKENS // width)


def topk_chunk(n_rows: int, batch: int) -> int:
    """Corpus rows per streamed top-k chunk for a ``batch``-row dispatch: as
    large as the f32 score-tile budget allows for the batch's rows in
    blocks of SCORE_ROWS (so every batch of up to SCORE_ROWS rows scans in
    the same chunks), never below TOPK_CHUNK."""
    cap = TOPK_SCORE_TILE_BYTES // (4 * SCORE_ROWS * max(-(-batch // SCORE_ROWS), 1))
    if cap >= n_rows:
        return max(n_rows, 1)
    return max(TOPK_CHUNK, cap - cap % TOPK_CHUNK)


# the host streams by (int8, hybrid): on one device, and over a mesh
_HOST_STREAMS = {
    (False, False): (dense_topk_host_streamed, mesh_topk.distributed_dense_topk_host_streamed),
    (False, True): (hybrid_topk_host_streamed, mesh_topk.distributed_hybrid_topk_host_streamed),
    (True, False): (dense_topk_host_streamed_int8,
                    mesh_topk.distributed_dense_topk_host_streamed_int8),
    (True, True): (hybrid_topk_host_streamed_int8,
                   mesh_topk.distributed_hybrid_topk_host_streamed_int8),
}


def _row_block(matrix, offset: int, rows: int) -> torch.Tensor:
    """Rows ``[offset, offset + rows)`` of a host array, memmap or tensor as
    a tensor, zero-padded past the matrix's end (a memmap reads only these
    rows)."""
    n = matrix.shape[0]
    block = matrix[min(offset, n) : min(offset + rows, n)]
    if not torch.is_tensor(block):
        block = torch.from_numpy(np.ascontiguousarray(block))
    if block.shape[0] < rows:
        block = torch.cat([block, block.new_zeros((rows - block.shape[0], *block.shape[1:]))])
    return block


class RetrievalEngine:
    """Holds the dense and sparse indices + scoring params and answers
    query batches."""

    def __init__(
        self,
        field_info: Dict[str, Field],
        doc_keys: Sequence[str],
        encode_fn,  # (input_ids, attention_mask) -> [B, E] tensor on `device`
        tokenizer,
        mixer_params: Dict,  # {'weight': [E or 1, Ftot]}
        dense_matrix=None,  # [N, Fd, E] or [N, Fd*E], numpy or torch
        sparse_indices: Optional[Dict[str, object]] = None,
        query_max_length: int = 512,
        recall_k: int = 100,
        mask: Optional[np.ndarray] = None,  # [Ftot] field ablation mask
        use_pallas_gather="auto",  # stage-2 gather through kernel K1
        #   whenever the engine reranks, whatever its default mode:
        #   "auto" = K1 for a CUDA corpus (raising on one K1 cannot read),
        #   the K1 wrapper's plain version for a CPU corpus K1 reads, else
        #   the plain gather, and never for an int8 or host-streamed corpus;
        #   True = K1 (raising on a corpus it cannot read); False = the
        #   plain gather
        pallas_cross_row: bool = False,  # the K1 route through K1x, the
        #   cross-row schedule (the TPU kernel's cross_row_prefetch)
        quantize: Optional[str] = None,  # "int8": int8 rows + an f32 scale a row
        mesh=None,
        corpus_per_slice: bool = False,
        mode: str = "auto",  # default retrieve() mode: auto|exact|rerank
        dense_dtype: Optional[torch.dtype] = None,  # device dtype of the corpus
        #   (None keeps the input dtype; torch.bfloat16 halves its memory)
        dense_topk: str = "exact",  # 'approx' is accepted; selection is exact
        corpus_on_host: bool = False,  # keep the corpus in host memory and
        #   stream it to the device per scan (dense_dtype is then the
        #   transfer dtype; an in-RAM corpus is cast once, here)
        device: DeviceLike = None,  # default cuda; raises without a card
    ):
        self.check_gather_flags(use_pallas_gather, pallas_cross_row)
        if mode not in ("auto", "exact", "rerank"):
            raise ValueError(f"mode={mode!r}")
        if dense_topk not in ("exact", "approx"):
            raise ValueError(f"dense_topk={dense_topk!r}")
        if quantize not in (None, "int8"):
            raise ValueError(f"unknown quantize mode {quantize!r}")
        has_dense = dense_matrix is not None and int(np.prod(dense_matrix.shape)) > 0
        if not has_dense and not sparse_keys(field_info):
            raise ValueError("the engine serves a dense corpus or sparse fields: "
                             "pass dense_matrix or declare sparse fields")

        self.device = resolve_device(device)
        self.field_info = field_info
        self.doc_keys = list(doc_keys)
        self._doc_keys_arr = None  # lazy np object array (see _to_keyed)
        self.last_serve_path = None  # the route of the latest dispatch
        self.encode_fn = encode_fn
        self.tokenizer = tokenizer
        self.mixer_params = mixer_params
        w = mixer_params["weight"]
        self._W = torch.as_tensor(
            w if torch.is_tensor(w) else np.asarray(w), dtype=torch.float32, device=self.device
        )
        self.query_max_length = query_max_length
        self.recall_k = recall_k
        self.dense_keys = dense_keys(field_info)
        self.sparse_keys = sparse_keys(field_info)
        self.sparse_indices = sparse_indices or {}
        self.mask = mask
        self.n_docs = len(self.doc_keys)
        self.mode = mode
        self.dense_topk = dense_topk
        self.has_dense = has_dense
        self.mesh = mesh
        self.pallas_cross_row = pallas_cross_row
        self._corpus_axes = self._query_axis = None
        if mesh is not None:
            self._corpus_axes = corpus_sharding(mesh, replicate_across_slices=corpus_per_slice)
            # with a corpus per slice, the replica groups serve disjoint
            # slices of the query batch instead of repeating the scan
            if corpus_per_slice and mesh.shape[REPLICA_AXIS] > 1:
                self._query_axis = REPLICA_AXIS
        self.docs_flat = None  # device corpus, f32/bf16 (a mesh rank's row block)
        self.docs_q = self.doc_scales = None  # int8 rows and their device scales
        self.docs_host = None  # host corpus (CPU tensor or memmap)
        self.docs_host_q = self.docs_host_scales = None  # host int8 rows, scales
        self._host_source = None  # on a mesh: the caller's host corpus, for stage 2
        self._host_transfer_dtype = None
        self.emb_dim = None
        self.use_gather_kernel = False
        if has_dense:
            self._place_dense(dense_matrix, dense_dtype, use_pallas_gather, quantize,
                              corpus_on_host)
        self._build_row_maps()

    @staticmethod
    def check_gather_flags(use_pallas_gather, pallas_cross_row) -> None:
        """Raise ``ValueError`` on a stage-2 gather setting the engine
        refuses (the commands call this before any work).  The cross-row
        schedule needs the K1 gather, as the JAX engine asserts
        (mfar_tpu/eval/retrieval.py:159-162)."""
        if use_pallas_gather not in (True, False, "auto"):
            raise ValueError(f"use_pallas_gather={use_pallas_gather!r}")
        if pallas_cross_row and not use_pallas_gather:
            raise ValueError("pallas_cross_row schedules the K1 gather and does nothing "
                             "without use_pallas_gather")

    def _place_dense(self, dense_matrix, dense_dtype, use_pallas_gather, quantize,
                     corpus_on_host) -> None:
        """The dense corpus in the flat [N, Fd*E] layout, where the options
        put it (on the device, as int8, in host memory), and the stage-2
        gather gate."""
        fd = len(self.dense_keys)
        flat = dense_matrix
        if flat.ndim == 3:
            n, fd_in, e = flat.shape
            if fd_in != fd:
                raise ValueError(f"dense_matrix has {fd_in} fields, field_info {fd} dense")
            flat = flat.reshape(n, fd * e)
        else:
            n, fe = flat.shape
            if fe % max(fd, 1):
                raise ValueError(f"dense_matrix width {fe} is not {fd} fields")
            e = fe // fd
        if n != self.n_docs:
            raise ValueError(f"dense_matrix has {n} rows for {self.n_docs} doc keys")
        self.emb_dim = e
        if quantize or corpus_on_host:
            # K1 reads a device corpus of f32/bf16 rows: the int8 rows are
            # dequantized candidate by candidate, a host corpus's gathered
            # on the host (the JAX engine asserts the same,
            # mfar_tpu/eval/retrieval.py:165-169, :298-302)
            if use_pallas_gather is True:
                raise ValueError("the K1 gather reads a device corpus in f32/bf16; "
                                 "an int8 or host-streamed corpus has none")
            if corpus_on_host:
                self._place_on_host(flat, dense_dtype, quantize)
            else:
                self._place_int8(flat)
            return
        if self.mesh is not None:
            # this rank's row block only, zero-padded at the corpus's tail;
            # K1 reads one device's whole corpus, so "auto" resolves to the
            # plain gather (the JAX engine asserts the same,
            # mfar_tpu/eval/retrieval.py:182-191)
            if use_pallas_gather is True:
                raise ValueError("the K1 gather reads one device's whole corpus and is "
                                 "not composed with the mesh")
            offset, shard_n = shard_rows(n, self.mesh, self._corpus_axes)
            block = _row_block(flat, offset, shard_n)
            self.docs_flat = block.to(self.device, dtype=dense_dtype or block.dtype).contiguous()
            return
        if isinstance(flat, np.ndarray):
            with warnings.catch_warnings():
                # a read-only memmap (--dense-index .npy): the engine never
                # writes the corpus, and a device copy is made just below
                warnings.simplefilter("ignore", UserWarning)
                flat = torch.as_tensor(flat)
        self.docs_flat = flat.to(self.device, dtype=dense_dtype or flat.dtype).contiguous()

        # The gather gate.  K1 reads f32/bf16 corpora whose field segments
        # are a whole number of 16-byte loads.  On a CUDA corpus "auto"
        # means K1, and a corpus K1 cannot read raises rather than falling
        # back.  On a CPU corpus "auto" takes the K1 wrapper (its plain
        # version) where K1 reads the corpus, else the plain gather.  The
        # gate does not look at the engine's default mode: a rerank served
        # through retrieve(mode="rerank") or dispatch() goes through K1 too.
        # The TPU gate keys on mode="rerank" and weighs a memory model (two
        # corpus copies + scan workspace must fit HBM,
        # mfar_tpu/eval/retrieval.py:393-444) because the Pallas kernel
        # reads a second, row-DMA-layout copy of the corpus; the CUDA
        # kernel reads the flat [N, F*E] matrix in place, so there is no
        # second copy and nothing to weigh.
        readable = (self.docs_flat.dtype in (torch.float32, torch.bfloat16)
                    and e % (16 // self.docs_flat.element_size()) == 0)
        if use_pallas_gather == "auto":
            use_pallas_gather = readable or self.docs_flat.is_cuda
        if use_pallas_gather and not readable:
            raise ValueError(
                f"the K1 gather reads f32/bf16 corpora with 16-byte field "
                f"segments; got {self.docs_flat.dtype}, E={e}"
            )
        self.use_gather_kernel = use_pallas_gather

    def _place_int8(self, flat) -> None:
        """int8 rows and an f32 scale a row on the device, quantized a slab of
        rows at a time where the corpus lies (on the card for a corpus
        there, on the host for a host array or memmap).  On a mesh, this
        rank's block: its rows are read slab by slab from the source and
        the block is zero past the corpus's end, so no f32 or bf16 copy of
        the block ever exists."""
        n, rows, offset = flat.shape[0], flat.shape[0], 0
        if self.mesh is not None:
            offset, rows = shard_rows(n, self.mesh, self._corpus_axes)
        self.docs_q = torch.zeros((rows, flat.shape[1]), dtype=torch.int8, device=self.device)
        self.doc_scales = torch.zeros(rows, dtype=torch.float32, device=self.device)
        real = int(np.clip(n - offset, 0, rows))
        quantize_rows_int8_into(flat, self.docs_q[:real], self.doc_scales[:real], offset=offset)

    def _place_on_host(self, flat, dense_dtype, quantize) -> None:
        """A corpus kept in host memory for the streamed scans.  On a card
        the streams copy from pinned memory only: an in-RAM corpus is cast
        once to the transfer dtype (``dense_dtype``, else its own) into a
        pinned tensor, and int8 rows are quantized into one (where the
        corpus lies: on the card for a corpus there); a memmap stays on disk
        and each chunk is cast into a pinned staging buffer as it streams.
        On a mesh a rank keeps its block's rows only (a memmap view of
        them), and the caller's corpus for stage 2 (:meth:`_host_rows`)."""
        pin = self.device.type == "cuda"
        offset, rows = 0, flat.shape[0]
        if self.mesh is not None:
            offset, rows = mesh_topk.block_rows(flat.shape[0], self.mesh, self._corpus_axes)
            self._host_source = flat
        if quantize:
            shape = (rows, flat.shape[1])
            self.docs_host_q = (pinned_empty(shape, torch.int8) if pin
                                else torch.empty(shape, dtype=torch.int8))
            self.docs_host_scales = torch.empty(rows, dtype=torch.float32)
            quantize_rows_int8_into(flat, self.docs_host_q, self.docs_host_scales, offset=offset)
            self.doc_scales = self.docs_host_scales.to(self.device)
        elif isinstance(flat, np.memmap):
            self.docs_host = flat[offset : offset + rows]
            self._host_transfer_dtype = dense_dtype
        else:
            src = as_host_tensor(flat)[offset : offset + rows]
            dtype = dense_dtype or src.dtype
            self.docs_host = (pinned_empty(src.shape, dtype).copy_(src) if pin
                              else src.to("cpu", dtype))

    def _build_row_maps(self) -> None:
        """A prebuilt sparse index may cover another doc set or order than
        the corpus (``--lexical-index`` built elsewhere).  Per field: None =
        rows aligned with ``doc_keys``, else an int64 [n_bm25] map of BM25
        row -> corpus row (-1 = not in the corpus)."""
        missing = [fk for fk in self.sparse_keys if fk not in self.sparse_indices]
        if missing:
            # fail here, not with a KeyError on the first query: every route
            # scores each declared sparse field through its index
            raise ValueError(
                f"field_info declares sparse fields {missing} but sparse_indices "
                f"has no index for them (got {sorted(self.sparse_indices)})"
            )
        self._sparse_row_map: Dict[str, Optional[np.ndarray]] = {}
        self._sparse_inv_map: Dict[str, np.ndarray] = {}  # corpus row -> BM25 row
        key_to_row = None
        for fk in self.sparse_keys:
            keys = list(self.sparse_indices[fk].keys)
            if keys == self.doc_keys:
                self._sparse_row_map[fk] = None
                continue
            if key_to_row is None:
                key_to_row = {k_: i for i, k_ in enumerate(self.doc_keys)}
            self._sparse_row_map[fk] = np.asarray(
                [key_to_row.get(k_, -1) for k_ in keys], np.int64
            )

    def _map_postings(self, fk: str, ids: np.ndarray, vals: np.ndarray):
        """BM25-row postings -> corpus-row postings (docs outside the corpus
        drop to id 0 / val 0, which scatter-adds nothing)."""
        rm = self._sparse_row_map.get(fk)
        if rm is None:
            return ids, vals
        mapped = rm[ids]
        keep = mapped >= 0
        return (
            np.where(keep, mapped, 0).astype(np.int32),
            np.where(keep, vals, 0.0).astype(np.float32),
        )

    def _map_dense_scores(self, fk: str, scores: np.ndarray) -> np.ndarray:
        """[B, n_bm25] BM25 scores -> [B, n_docs] corpus-row-aligned scores."""
        out = np.zeros((scores.shape[0], self.n_docs), np.float32)
        rm = self._sparse_row_map.get(fk)
        if rm is None:
            out[:, : scores.shape[1]] = scores
        else:
            keep = rm >= 0
            out[:, rm[keep]] = scores[:, keep]
        return out

    def _inv_map(self, fk: str) -> Optional[np.ndarray]:
        """corpus row -> BM25 row (-1 = doc absent from the index)."""
        rm = self._sparse_row_map.get(fk)
        if rm is None:
            return None
        if fk not in self._sparse_inv_map:
            inv = np.full(self.n_docs, -1, np.int64)
            keep = rm >= 0
            inv[rm[keep]] = np.nonzero(keep)[0]
            self._sparse_inv_map[fk] = inv
        return self._sparse_inv_map[fk]

    def _qaxis(self, b: int) -> Optional[str]:
        """Query-slice axis for a batch of b rows (None unless the batch
        divides across the replica groups)."""
        if self._query_axis is not None and b % self.mesh.shape[self._query_axis] == 0:
            return self._query_axis
        return None

    def set_mask(self, mask: Optional[np.ndarray]) -> None:
        """Field ablation mask over [dense..., sparse...] (schema order)."""
        self.mask = mask

    def _mask_tensor(self) -> Optional[torch.Tensor]:
        if self.mask is None:
            return None
        return torch.as_tensor(np.asarray(self.mask, np.float32), device=self.device)

    def _masked_out(self, field_idx: int) -> bool:
        """Host-known ablation-mask skip (the mixer weights also zero masked
        fields on the device, so skipping is an optimisation, not the source
        of the correct result)."""
        return self.mask is not None and float(self.mask[field_idx]) == 0.0

    def _to_device(self, a) -> torch.Tensor:
        """A host array (or CPU tensor) on the engine's device; on a card
        through pinned memory without blocking, so the dispatch half never
        waits for the device."""
        t = a.contiguous() if torch.is_tensor(a) else torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _field_weights(self, q: torch.Tensor) -> torch.Tensor:
        """[B, F] post-softmax, post-mask field weights."""
        w = softmax_field_weights(self._W, q, self._mask_tensor())
        return w.expand(q.shape[0], w.shape[-1])

    def encode_queries(self, queries: Sequence[str]) -> torch.Tensor:
        """f32 ``[len(queries), E]`` query embeddings, encoded in calls of a
        fixed row count for the batch's bucket width (:func:`query_call_rows`),
        so that a query's row does not depend on the rest of its batch."""
        toks = self.tokenizer.encode_batch(
            [clean_query(q) for q in queries], self.query_max_length
        )
        ids, mask = toks["input_ids"], toks["attention_mask"]
        n, width = ids.shape
        rows = query_call_rows(width)
        if n % rows:
            fill = np.full(rows - n % rows, n - 1)
            ids, mask = np.concatenate([ids, ids[fill]]), np.concatenate([mask, mask[fill]])
        with torch.inference_mode():
            if n == 0:
                return self.encode_fn(ids, mask).float()
            out = [self.encode_fn(ids[i : i + rows], mask[i : i + rows])
                   for i in range(0, len(ids), rows)]
            return (out[0] if len(out) == 1 else torch.cat(out))[:n].float()

    # -- sparse fields on the host ----------------------------------------

    def _sparse_full_scores(self, cleaned: List[str], weights: np.ndarray) -> np.ndarray:
        """Combined (weight-mixed) full-corpus sparse scores [B, n_docs]: each
        sparse field's full-corpus BM25 scores, times the field's post-softmax
        (and post-mask) weight."""
        fd = len(self.dense_keys)
        comb = np.zeros((len(cleaned), self.n_docs), np.float32)
        for s_i, fk in enumerate(self.sparse_keys):
            w = weights[:, fd + s_i]
            if not np.any(w):
                continue  # field masked out: skip the corpus scan entirely
            scores = self.sparse_indices[fk].get_scores_batch(cleaned)
            comb += w[:, None] * self._map_dense_scores(fk, scores)
        return comb

    def _collect_sparse_postings(self, cleaned: List[str]):
        """Per unmasked sparse field, the batch's query-term postings
        (row-mapped to corpus rows).  Returns (per_field list of (ids, vals,
        s_i), dense): dense is true when the postings, counted unpadded,
        exceed half the corpus, where the [B, N] host path is the cheaper
        transfer."""
        fd = len(self.dense_keys)
        per_field = []
        for s_i, fk in enumerate(self.sparse_keys):
            if self._masked_out(fd + s_i):
                continue
            # padded to the batch's longest: nothing here compiles per width
            ids, vals = self.sparse_indices[fk].get_postings_batch(cleaned, pad_multiple=None)
            ids, vals = self._map_postings(fk, ids, vals)
            per_field.append((ids, np.asarray(vals), s_i))
        nnz_total = sum(float((v != 0).sum()) for _, v, _ in per_field)
        return per_field, nnz_total * 2 > len(cleaned) * self.n_docs

    def _sparse_postings_raw(
        self, cleaned: List[str]
    ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """All sparse fields' query-term postings concatenated per query:
        ids [B, M] i32, raw impacts [B, M] f32 and the sparse-field index of
        each posting [B, M] int8 (each picks up its field's weight on the
        device).  Host numpy only.  None when the postings are denser than
        half the corpus."""
        b = len(cleaned)
        per_field, dense = self._collect_sparse_postings(cleaned)
        if not per_field:
            z = np.zeros((b, 128), np.int32)
            return z, np.zeros((b, 128), np.float32), z.astype(np.int8)
        if dense:
            return None
        ids = np.concatenate([i for i, _, _ in per_field], axis=1)
        vals = np.concatenate([v for _, v, _ in per_field], axis=1)
        fidx = np.concatenate(
            [np.full(i.shape, s_i, np.int8) for i, _, s_i in per_field], axis=1
        )
        return ids.astype(np.int32, copy=False), vals.astype(np.float32, copy=False), fidx

    # -- exact mode -----------------------------------------------------

    def retrieve_exact(self, queries: Sequence[str], top_k: int = 100) -> List[List[Tuple[str, float]]]:
        """Exact full-corpus retrieval: fold + one matmul per chunk + top-k."""
        return self._finish_exact(self._dispatch_exact(queries, top_k))

    def _dispatch_exact(self, queries: Sequence[str], top_k: int):
        """Dispatch phase: host prep + device work enqueued, no fetch, so
        :meth:`retrieve_many` can overlap batches.  Returns ("device",
        top_s, top_i), or ("host", results) for a sparse-only corpus."""
        k = min(top_k, self.n_docs)
        fd = len(self.dense_keys)
        chunk = topk_chunk(self.n_docs, len(queries))
        with torch.inference_mode():
            q = self.encode_queries(queries)
            if not self.has_dense:
                return ("host", self._sparse_only_exact(queries, q, k))
            if self.docs_host is not None or self.docs_host_q is not None:
                return self._dispatch_host_stream(queries, q, k)
            if self.mesh is not None:
                return self._dispatch_mesh(queries, q, k)
            int8 = self.docs_q is not None
            route = "singlechip-int8-" if int8 else "singlechip-"
            W, mask = self._W, self._mask_tensor()
            if not self.sparse_keys:
                if int8:
                    top_s, top_i = fused_dense_topk_from_query_int8(
                        q, W, mask, self.docs_q, self.doc_scales, self.n_docs, fd, k,
                        chunk_size=chunk)
                else:
                    top_s, top_i = fused_dense_topk_from_query(
                        q, W, mask, self.docs_flat, self.n_docs, fd, k,
                        chunk_size=chunk, approx=self.dense_topk == "approx")
                self.last_serve_path = route + "dense"
                return ("device", top_s, top_i)
            cleaned = [clean_query(t) for t in queries]
            raw = self._sparse_postings_raw(cleaned)
            if raw is not None:
                ids, vals, fidx = (self._to_device(a) for a in raw)
                if int8:
                    top_s, top_i = fused_hybrid_topk_postings_from_query_int8(
                        q, W, mask, self.docs_q, self.doc_scales, ids, vals, fidx,
                        self.n_docs, fd, k, chunk_size=chunk)
                else:
                    top_s, top_i = fused_hybrid_topk_postings_from_query(
                        q, W, mask, self.docs_flat, ids, vals, fidx, self.n_docs, fd, k,
                        chunk_size=chunk)
                self.last_serve_path = route + "hybrid-postings"
                return ("device", top_s, top_i)
            # postings denser than half the corpus: the host sums the
            # weighted full-corpus scores (the one route that fetches the
            # weights)
            weights = self._field_weights(q)
            comb = self._to_device(self._sparse_full_scores(cleaned, weights.cpu().numpy()))
            qflat = fold_queries(q, weights[:, :fd])
            if int8:
                top_s, top_i = hybrid_topk_chunked_int8(
                    qflat.float(), self.docs_q, self.doc_scales, comb, self.n_docs, k,
                    chunk_size=chunk)
            else:
                top_s, top_i = hybrid_topk_chunked(
                    qflat.to(self.docs_flat.dtype), self.docs_flat, comb, self.n_docs, k,
                    chunk_size=chunk)
            self.last_serve_path = route + "hybrid-combined"
            return ("device", top_s, top_i)

    def _host_stream(self, qflat, k, **sparse):
        """The streamed top-k over the host corpus as it was placed: int8 or
        not, on one device or this rank's rows on a mesh; ``sparse`` holds
        the hybrid routes' postings or combined scores."""
        int8 = self.docs_host_q is not None
        corpus = (self.docs_host_q, self.doc_scales) if int8 else (self.docs_host,)
        opts = {} if int8 else dict(transfer_dtype=self._host_transfer_dtype)
        one_device, over_mesh = _HOST_STREAMS[int8, bool(sparse)]
        if self.mesh is None:
            return one_device(qflat, *corpus, k, **opts, **sparse)
        return over_mesh(self.mesh, qflat, *corpus, self.n_docs, k, **opts, **sparse,
                         axis=self._corpus_axes, query_axis=self._qaxis(qflat.shape[0]))

    def _dispatch_host_stream(self, queries, q, k):
        """Exact retrieval over the host corpus: fold on the device, then
        stream the corpus through the chunked scan (on a mesh, each rank its
        rows); hybrid fields scatter their weighted postings per chunk, or
        (postings denser than half the corpus) the host's combined scores
        stream beside the rows."""
        fd = len(self.dense_keys)
        weights = self._field_weights(q)
        qflat = fold_queries(q, weights[:, :fd])
        route = (["host-stream", "hybrid" if self.sparse_keys else "dense"]
                 + ["int8"] * (self.docs_host_q is not None) + ["mesh"] * (self.mesh is not None))
        if not self.sparse_keys:
            top_s, top_i = self._host_stream(qflat, k)
        else:
            cleaned = [clean_query(t) for t in queries]
            raw = self._sparse_postings_raw(cleaned)
            if raw is not None:
                ids, vals, fidx = (self._to_device(a) for a in raw)
                # each posting's impact times its field's weight, on the device
                wvals = vals * torch.gather(weights, 1, fd + fidx.long())
                top_s, top_i = self._host_stream(qflat, k, post_ids=ids, post_wvals=wvals)
                route.append("postings")
            else:
                comb = self._sparse_full_scores(cleaned, weights.cpu().numpy())
                top_s, top_i = self._host_stream(qflat, k, sparse_comb_host=comb)
                route.append("combined")
        self.last_serve_path = "-".join(route)
        return ("device", top_s, top_i)

    def _dispatch_mesh(self, queries, q, k):
        """Exact retrieval over the mesh: the routes of
        :mod:`mfar_tpu_torch.parallel.topk` (weights, fold, each shard's
        scan, the merge) over this rank's block in f32/bf16 or int8, the
        same on every rank."""
        fd = len(self.dense_keys)
        int8 = self.docs_q is not None
        corpus = (self.docs_q, self.doc_scales) if int8 else (self.docs_flat,)
        route = "mesh-int8-" if int8 else "mesh-"
        W, mask = self._W, self._mask_tensor()
        kw = dict(chunk_size=topk_chunk(corpus[0].shape[0], len(queries)),
                  axis=self._corpus_axes, query_axis=self._qaxis(len(queries)))
        if not self.sparse_keys:
            if int8:
                qflat = fold_queries(q, self._field_weights(q)[:, :fd]).float()
                top_s, top_i = mesh_topk.distributed_dense_topk_int8(
                    self.mesh, qflat, *corpus, self.n_docs, k, **kw)
            else:
                top_s, top_i = mesh_topk.distributed_fused_dense_topk(
                    self.mesh, q, W, mask, *corpus, self.n_docs, fd, k, **kw)
            self.last_serve_path = route + "dense"
            return ("device", top_s, top_i)
        cleaned = [clean_query(t) for t in queries]
        raw = self._sparse_postings_raw(cleaned)
        if raw is not None:
            ids, vals, fidx = (self._to_device(a) for a in raw)
            fn = (mesh_topk.distributed_fused_hybrid_topk_postings_int8 if int8
                  else mesh_topk.distributed_fused_hybrid_topk_postings)
            top_s, top_i = fn(self.mesh, q, W, mask, *corpus, ids, vals, fidx, self.n_docs, fd,
                              k, **kw)
            self.last_serve_path = route + "hybrid-postings"
            return ("device", top_s, top_i)
        # postings denser than half the corpus: each rank adds its columns
        # of the host's weighted full-corpus scores
        weights = self._field_weights(q)
        comb = self._sparse_full_scores(cleaned, weights.cpu().numpy())
        qflat = fold_queries(q, weights[:, :fd])
        if int8:
            top_s, top_i = mesh_topk.distributed_hybrid_topk_int8(
                self.mesh, qflat.float(), *corpus, comb, self.n_docs, k, **kw)
        else:
            top_s, top_i = mesh_topk.distributed_hybrid_topk(
                self.mesh, qflat.to(self.docs_flat.dtype), *corpus, comb, self.n_docs, k, **kw)
        self.last_serve_path = route + "hybrid-combined"
        return ("device", top_s, top_i)

    def _sparse_only_exact(self, queries, q, k) -> List[List[Tuple[str, float]]]:
        """No dense matrix: the weighted host BM25 scores are the totals."""
        cleaned = [clean_query(t) for t in queries]
        total = self._sparse_full_scores(cleaned, self._field_weights(q).cpu().numpy())
        part = np.argpartition(-total, k - 1, axis=1)[:, :k]
        part_s = np.take_along_axis(total, part, axis=1)
        order = np.argsort(-part_s, axis=1, kind="stable")
        self.last_serve_path = "host-sparse-only"
        return self._to_keyed(np.take_along_axis(part_s, order, axis=1),
                              np.take_along_axis(part, order, axis=1))

    def _finish_exact(self, dispatched) -> List[List[Tuple[str, float]]]:
        if dispatched[0] == "host":
            return dispatched[1]
        _, top_s, top_i = dispatched
        return self._to_keyed(top_s.cpu().numpy(), top_i.cpu().numpy())

    # -- rerank mode ----------------------------------------------------

    def retrieve_rerank(self, queries: Sequence[str], top_k: int = 100) -> List[List[Tuple[str, float]]]:
        """Recall (per-field top-k union) + rerank, the reference pipeline."""
        return self._rerank_finish(self._rerank_dispatch(queries, top_k), top_k)

    def _rerank_dispatch(self, queries: Sequence[str], top_k: int = 100):
        """Stage-1 dispatch: query encode + per-field dense recall enqueued
        on the device (not fetched) + per-field BM25 recall on the host, so
        retrieve_many can overlap the next batch's recall with this batch's
        candidate assembly + stage 2.  On a mesh, stage 2 runs here too: its
        all-reduce is a collective, and finish issues none."""
        b = len(queries)
        fd = len(self.dense_keys)
        k = min(self.recall_k, self.n_docs)
        s = idx = None
        with torch.inference_mode():
            q = self.encode_queries(queries)
            if self.has_dense and fd:
                # Recall scans F field blocks per chunk, so the score-tile
                # budget sees B*Fd rows.
                chunk = topk_chunk(self.n_docs, b * fd)
                if self.docs_host is not None or self.docs_host_q is not None:
                    # a host corpus: one-hot folded queries [B*Fd, Fd*E]
                    # (one folded scan gives each field's own scores)
                    # through the dense host stream
                    s, idx = self._host_stream(onehot_queries(q, fd), k)
                elif self.mesh is not None and self.docs_q is not None:
                    onehot = onehot_queries(q, fd)  # int8 rows: one scale a row
                    s, idx = mesh_topk.distributed_dense_topk_int8(
                        self.mesh, onehot, self.docs_q, self.doc_scales, self.n_docs, k,
                        chunk_size=topk_chunk(self.docs_q.shape[0], b * fd),
                        axis=self._corpus_axes, query_axis=self._qaxis(onehot.shape[0]))
                elif self.mesh is not None:
                    s, idx = mesh_topk.distributed_per_field_topk(
                        self.mesh, q.to(self.docs_flat.dtype), self.docs_flat, self.n_docs,
                        fd, k, chunk_size=topk_chunk(self.docs_flat.shape[0], b * fd),
                        axis=self._corpus_axes, query_axis=self._qaxis(b))
                elif self.docs_flat is not None:
                    s, idx = per_field_topk_chunked_approx(
                        q.to(self.docs_flat.dtype), self.docs_flat, self.n_docs, fd, k,
                        chunk_size=chunk,
                    )
                else:
                    # int8 rows (one scale a row): one-hot folded queries
                    s, idx = dense_topk_chunked_int8(
                        onehot_queries(q, fd), self.docs_q, self.doc_scales, self.n_docs, k,
                        chunk_size=chunk)
        # stage 1b: each sparse field's BM25 top-k on the host (unordered
        # rows: the union below needs only membership)
        cleaned = [clean_query(t) for t in queries]
        cand_lists: List[List[np.ndarray]] = [[] for _ in range(b)]
        for fk in self.sparse_keys:
            rm = self._sparse_row_map.get(fk)
            hits = self.sparse_indices[fk].retrieve_rows_batch(cleaned, top_k=k)
            for i, rows in enumerate(hits):
                if rm is not None:  # prebuilt index with another doc set
                    rows = rm[rows]
                    rows = rows[rows >= 0]  # docs absent from the corpus
                cand_lists[i].append(rows)
        st = dict(b=b, q=q, s=s, idx=idx, fd=fd, k=k, cand_lists=cand_lists,
                  cleaned=cleaned)
        if self.mesh is not None:
            st["scored"] = self._rerank_score(st, top_k)
        return st

    def _rerank_finish(self, st, top_k: int) -> List[List[Tuple[str, float]]]:
        """Stage 2 (unless the dispatch ran it), then fetch the results."""
        top_s, top_pos, cand = st.get("scored") or self._rerank_score(st, top_k)
        with torch.inference_mode():
            top_s, top_pos = top_s.cpu().numpy(), top_pos.cpu().numpy()
        return self._to_keyed(top_s, np.take_along_axis(cand, top_pos, axis=1))

    def _rerank_score(self, st, top_k: int):
        """Fetch the stage-1 recall, union candidates on the host, score and
        rerank them (stage 2).  Returns the device (scores, candidate
        positions) and the host candidate matrix."""
        b, q, fd, k = st["b"], st["q"], st["fd"], st["k"]
        cand_lists = st["cand_lists"]
        if st["s"] is not None:
            s = st["s"].cpu().numpy().reshape(b, fd * k)
            idx = st["idx"].cpu().numpy().reshape(b, fd * k)
            for i in range(b):  # -inf hits are padding (k > corpus chunk)
                cand_lists[i].append(idx[i][np.isfinite(s[i])])
        # Per-query sorted-unique union.
        uniq = [np.unique(np.concatenate(lst)) if lst else np.zeros(0, np.int64)
                for lst in cand_lists]
        # static-width candidate matrix (padded; pad entries masked out),
        # a geometric bucket so the set of stage-2 shapes stays small
        width = bucket_width(max(max(len(u) for u in uniq), 1), 128)
        cand = np.zeros((b, width), np.int64)
        valid = np.zeros((b, width), bool)
        for i, ids in enumerate(uniq):
            cand[i, : len(ids)] = ids
            valid[i, : len(ids)] = True

        with torch.inference_mode():
            qf = q.float().contiguous()
            hybrid = "hybrid-" if self.sparse_keys else ""
            if self.has_dense and fd:
                cand_t = self._to_device(cand)
                if self.docs_flat is None:
                    dense_scores = self._candidate_scores_without_k1(qf, cand, cand_t, hybrid)
                elif self.mesh is not None:
                    dense_scores = mesh_topk.distributed_candidate_scores(
                        self.mesh, qf, self.docs_flat, cand_t, fd, axis=self._corpus_axes,
                        query_axis=self._qaxis(b))
                    self.last_serve_path = "mesh-rerank" + ("-hybrid" if hybrid else "")
                elif self.use_gather_kernel:
                    dense_scores = gather_per_field_scores(
                        qf, self.docs_flat, cand_t, fd, cross_row=self.pallas_cross_row)
                    self.last_serve_path = (f"singlechip-rerank-{hybrid}k1"
                                            + ("x" if self.pallas_cross_row else ""))
                else:
                    rows = self.docs_flat[cand_t]  # [B, C, Fd*E]
                    dense_scores = per_field_candidate_scores(
                        qf, rows.view(b, width, fd, self.emb_dim)
                    )
                    self.last_serve_path = f"singlechip-rerank-{hybrid}plain"
            else:
                # no dense matrix: zero columns for the declared dense
                # fields, so the scores still span every mixer field
                dense_scores = torch.zeros(b, width, fd, device=self.device)
                self.last_serve_path = "singlechip-rerank-sparse-only"
            sparse_scores = None
            if self.sparse_keys:
                sparse_scores = self._to_device(self._sparse_candidate_scores(
                    st["cleaned"], cand))
            top_s, top_pos = rerank_candidates(
                qf, dense_scores, sparse_scores, self._W, mask=self._mask_tensor(),
                cand_valid=self._to_device(valid),
                k=min(top_k, width),
            )
        return top_s, top_pos, cand

    def _candidate_scores_without_k1(self, qf, cand: np.ndarray, cand_t,
                                     hybrid: str) -> torch.Tensor:
        """[B, C, Fd] dense scores of an int8 or host corpus's candidates.
        int8 rows are dequantized on the device (on a mesh, each rank its
        own candidates, summed over the ranks); a host corpus's rows are
        gathered on the host, the batch's distinct candidates once
        (:meth:`_host_rows`), copied over and indexed per candidate."""
        b, width = cand.shape
        fd = len(self.dense_keys)
        if self.docs_q is not None and self.mesh is not None:
            self.last_serve_path = f"mesh-rerank-{hybrid}int8"
            return mesh_topk.distributed_candidate_scores_int8(
                self.mesh, qf, self.docs_q, self.doc_scales, cand_t, fd,
                axis=self._corpus_axes, query_axis=self._qaxis(b))
        if self.docs_q is not None:
            rows = self.docs_q[cand_t].float() * self.doc_scales[cand_t][..., None]
            self.last_serve_path = f"singlechip-rerank-{hybrid}int8"
        else:
            uniq = np.unique(cand)
            pos = self._to_device(np.searchsorted(uniq, cand))
            rows = self._to_device(self._host_rows(uniq))[pos]
            self.last_serve_path = ("host-stream-rerank-" + hybrid
                                    + ("int8" if self.docs_host_q is not None else "rows")
                                    + ("-mesh" if self.mesh is not None else ""))
        return per_field_candidate_scores(qf, rows.view(b, width, fd, self.emb_dim))

    def _host_rows(self, ids: np.ndarray) -> torch.Tensor:
        """[U, Fd*E] f32 rows ``ids`` of the host corpus as the streams read
        them: int8 rows dequantized, an in-RAM corpus in its cast dtype.  A
        mesh rank holds only its block, so it reads the rows from the
        caller's corpus and quantizes them where its block was quantized
        (:func:`quantize_slab`, row by row: a row comes out the same), or
        casts them as its block was."""
        src = self._host_source
        if src is None:
            if self.docs_host_q is not None:
                at = torch.from_numpy(ids)
                return self.docs_host_q[at].float() * self.docs_host_scales[at][:, None]
            return as_host_tensor(self.docs_host[ids]).float()
        rows = src[torch.from_numpy(ids).to(src.device)] if torch.is_tensor(src) else src[ids]
        if self.docs_host_q is not None:
            q8, scale = quantize_slab(rows)
            return (q8.float() * scale[:, None]).cpu()
        rows = as_host_tensor(rows).cpu()
        if not isinstance(src, np.memmap):  # a memmap streams uncast
            rows = rows.to(self.docs_host.dtype)
        return rows.float()

    def _sparse_candidate_scores(self, cleaned: List[str], cand: np.ndarray) -> np.ndarray:
        """[B, C, Fs] BM25 scores of the candidates: one full-corpus scoring
        pass per field (cached from stage 1b), then a column gather."""
        out = np.zeros((*cand.shape, len(self.sparse_keys)), np.float32)
        for s_i, fk in enumerate(self.sparse_keys):
            all_scores = self.sparse_indices[fk].get_scores_batch(cleaned)  # [B, n_bm25]
            inv = self._inv_map(fk)
            if inv is None:  # index rows == corpus rows
                out[:, :, s_i] = np.take_along_axis(all_scores, cand, axis=1)
            else:  # prebuilt index with another doc set or order
                cand_bm = inv[cand]
                vals = np.take_along_axis(all_scores, np.maximum(cand_bm, 0), axis=1)
                out[:, :, s_i] = np.where(cand_bm >= 0, vals, 0.0)
        return out

    # -- batching -------------------------------------------------------

    def retrieve_many(
        self,
        queries: Sequence[str],
        top_k: int = 100,
        mode: Optional[str] = None,
        batch_size: int = 256,
        window: int = 4,
    ) -> List[List[Tuple[str, float]]]:
        """Batched retrieval over a query list, pipelined: in exact mode up
        to ``window`` batches are dispatched before the oldest is fetched; in
        rerank mode one batch's recall runs ahead.  Results match per-batch
        :meth:`retrieve`."""
        mode = self._resolve_mode(mode)
        chunks = [
            list(queries[s : s + batch_size]) for s in range(0, len(queries), batch_size)
        ]
        # Pad a ragged tail chunk to batch_size (repeating its last query),
        # as the JAX engine does to reuse its compiled batch shape; the
        # duplicate results are sliced off below.
        if len(chunks) > 1 and len(chunks[-1]) < batch_size:
            chunks[-1] = chunks[-1] + [chunks[-1][-1]] * (batch_size - len(chunks[-1]))
        out: List[List[Tuple[str, float]]] = []
        if mode == "rerank":
            pend = None
            for chunk in chunks:
                st = self._rerank_dispatch(chunk, top_k)
                if pend is not None:
                    out.extend(self._rerank_finish(pend, top_k))
                pend = st
            if pend is not None:
                out.extend(self._rerank_finish(pend, top_k))
            return out[: len(queries)]
        pending: List[Any] = []
        for chunk in chunks:
            pending.append(self._dispatch_exact(chunk, top_k))
            if len(pending) >= window:
                out.extend(self._finish_exact(pending.pop(0)))
        for d in pending:
            out.extend(self._finish_exact(d))
        return out[: len(queries)]

    def retrieve(
        self, queries: Sequence[str], top_k: int = 100, mode: Optional[str] = None
    ) -> List[List[Tuple[str, float]]]:
        """``mode``: 'exact', 'rerank', or 'auto' (= exact)."""
        if self._resolve_mode(mode) == "exact":
            return self.retrieve_exact(queries, top_k)
        return self.retrieve_rerank(queries, top_k)

    def dispatch(self, queries: Sequence[str], top_k: int = 100, mode: Optional[str] = None):
        """Dispatch half of :meth:`retrieve` (no result fetch); returns an
        opaque handle for :meth:`finish`."""
        if self._resolve_mode(mode) == "rerank":
            return ("rerank", self._rerank_dispatch(queries, top_k), top_k)
        return ("exact", self._dispatch_exact(queries, top_k), top_k)

    def finish(self, handle) -> List[List[Tuple[str, float]]]:
        """Fetch half of :meth:`retrieve` for a :meth:`dispatch` handle."""
        kind, st, top_k = handle
        if kind == "rerank":
            return self._rerank_finish(st, top_k)
        return self._finish_exact(st)

    def _resolve_mode(self, mode: Optional[str]) -> str:
        mode = mode or self.mode
        return "exact" if mode == "auto" else mode

    # ------------------------------------------------------------------

    def _to_keyed(self, scores: np.ndarray, ids: np.ndarray) -> List[List[Tuple[str, float]]]:
        """[B, k] (scores, row ids) -> per-query [(doc_key, score)] lists,
        dropping -inf (padding) entries."""
        arr = self._doc_keys_arr
        if arr is None:
            arr = self._doc_keys_arr = np.asarray(self.doc_keys, dtype=object)
        keys = arr[np.clip(np.asarray(ids, np.int64), 0, self.n_docs - 1)]
        scores = np.asarray(scores, np.float32)
        finite = np.isfinite(scores)
        key_rows, score_rows = keys.tolist(), scores.tolist()
        if finite.all():
            return [list(zip(kr, sr)) for kr, sr in zip(key_rows, score_rows)]
        return [
            [(kk, ss) for kk, ss, f in zip(kr, sr, fr) if f]
            for kr, sr, fr in zip(key_rows, score_rows, finite.tolist())
        ]

    def to_qres(
        self, query_ids: Sequence[str], results: List[List[Tuple[str, float]]]
    ) -> List[trec.QRes]:
        qres = []
        for qid, hits in zip(query_ids, results):
            for rank, (doc_key, score) in enumerate(hits):
                qres.append(trec.QRes(qid, doc_key, score, rank=rank))
        return qres

    def field_weight_report(self, queries: Sequence[str]) -> np.ndarray:
        """Softmax field weights for analysis (what mask_fields inspects)."""
        q = self.encode_queries(queries)
        return FieldMixer.weights_of({"weight": self._W}, q).cpu().numpy()
