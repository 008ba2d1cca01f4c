"""Smoke run of the PyTorch port on one CUDA card: build, check, serve, train.

    python3 chip_smoke.py [--seed 0] [--phases k1,k2,...]

Drives ``mfar_tpu_torch`` (and nothing of JAX or ``mfar_tpu``) end to end at
Contriever-base and GTR-T5-base width with seeded random weights:

1. device    -- the card's name and power limit (nvidia-smi)
2. build     -- every CUDA kernel of the port, from ``mfar_tpu_torch/csrc``,
                one nvcc per source, all started together
3. k1        -- kernel K1 (rerank gather) and K1x (its cross-row schedule,
                --pallas-cross-row) against their plain PyTorch version for
                bf16 and f32 corpora at B=64 C=512 N=131072 F=5 E=768, plus
                edge cases (K1x's own: 7 x 37 candidates, which no warp's
                span divides, and ids outside [0, N) among valid ones); K1x
                against K1's bits; CUDA-event times of both kernels (in
                turns), plain version and a library yardstick, beside the
                bytes bound
4. k2        -- kernel K2 (flash attention) against its plain PyTorch version
                at the index build's [256, 12, 512, 64] bf16 with ragged
                segments, plus edge cases (S = 128, 256 and 384, B = 1,
                H = 1, pad rows whose first key tiles are wholly masked) and
                the segment-id cases (several segments, interleaved ids,
                one-segment rows), there with its logsumexp too; times of
                kernel, plain version and a library yardstick (SDPA with the
                boolean segment mask), beside the bound, and the share of
                key tiles skipped; K2 with the logsumexp timed at the
                training shape [96, 12, 512, 64]
5. k2b       -- K2's logsumexp output and the backward kernels (dq, which
                also writes di, then dkv) against their plain version at
                the training shape [96, 12, 512, 64] bf16 and edge cases
                (several segments, interleaved ids, S = 128, B = 1, H = 1),
                dq's di against the plain row dots; the share of tile pairs
                the kernels skip; the autograd Function against autograd
                through the plain version; times of each kernel, the whole
                backward, the plain backward and SDPA's backward, beside the
                bounds
5b. k2g      -- K2's forwards and K2b's pairs off the wgmma D = 64 route
                against the plain versions, each input on the routes the
                routing rule gives (bf16 at another head dim: the wgmma
                kernels at ceil(D / 64) slabs, the backward past D = 128
                in blocks of one warpgroup with dkv's grid split into dV
                and dK blocks; f32: the 3xTF32 kernels of
                csrc/flash_attention_tf32.cu and
                csrc/flash_attention_tf32_bwd.cu, the backward past D =
                64 in blocks of one warpgroup streaming 32-row half tiles,
                dkv split so too; heads TMA cannot read one by one but can
                as rows of heads side by side (TinyBERT's D = 26 in the
                encoder's [B, S, H*D] projections): the wgmma and 3xTF32
                forwards on row maps ("wgmma_rows", "tf32_rows"); what
                neither map reads: the forward and the backward over
                zero-padded copies at D rounded up to 8 in bf16 (the
                "wgmma_pad" route) or 4 in f32 ("tf32_pad")), forward,
                logsumexp, dq (with di, its bits on a second run) and dkv:
                small segment-id cases at D = 2-256 in f32 and bf16 (D = 2,
                26 and 62 f32 and D = 2, 20, 25, 26 and 126 bf16 at 8 heads
                on the rows routes; D = 26 f32, D = 2, 20, 25, 26 and 126
                bf16 contiguous, D = 64 in layouts TMA cannot read, f32 D
                = 66 and 254 and bf16 D = 130 and 250 at 8 heads, on the
                padding routes; the wide pairs at f32 D = 68-256 and bf16
                D = 136-256), then the main
                paths' shapes (f32 [256, 12, 512, 64] and [96, 12, 512,
                64], D = 32 [256, 12, 512, 32] in both dtypes and its bf16
                backward at [96, 12, 512, 32], TinyBERT's D = 26 at [256,
                12, 512, 26] and [96, 12, 512, 26] in bf16 and f32, D = 16
                [256, 4, 128, 16]), the padding forwards at a contiguous
                [256, 12, 512, 26], the forwards at [256, 12, 512, 128]
                and [256, 12, 512, 256] in both dtypes and the wide pairs
                at bf16 [96, 12, 512, 256] and f32 [96, 12, 512, D] (D =
                96, 128, 192, 256; dq, dkv and dq then dkv); times of each route's
                kernels, on the rows routes the same kernel on zero-padded
                copies (its output and logsumexp bit-equal), on the
                padding routes the kernel on the copies alone, the whole
                padded backward (copies and pair), the plain versions and
                SDPA with the boolean segment mask, beside the bound
6. e2e       -- a synthetic mag-shaped corpus (2048 docs x 5 dense fields)
                encoded by the full-width encoder with attention_impl="auto"
                (the 512-token fields through K2), held against the same
                corpus encoded with plain attention; then the engine in
                rerank mode (through K1) and exact mode, each held against a
                reference (the plain-gather engine; a brute-force f32 scan);
                the rerank engine with pallas_cross_row (through K1x) against
                the one through K1
7. long      -- 64 queries of 150 words (the 256-token bucket) through the
                "auto" engine (K2) against a plain-attention engine
8. cli       -- the encode_corpus command on a 512-doc dataset directory and
                a local BERT directory at Contriever-base width (seeded
                weights), both written here, into .npz and .npy, read back
                and held against the same weights built through K2; then
                retrieve --mode rerank over the .npz with --pallas-cross-row
                (K1x) against the run without it (K1); the analysis scripts
                on those run files (compare_results, find_failures at k 10)
                and on the dataset (corpus_stats with the BERT directory and
                with whitespace), each held to counts made here
9. train     -- MFARModel at Contriever-base width on the e2e corpus: one
                batch through K2/K2b against the plain path, Trainer.fit
                (the counted main path of training), steps/s through K2/K2b
                and plain in turns, a profiled step, a trec eval over an
                index rebuilt by the trained encoder, a checkpoint round trip
10. train_mesh -- data-parallel training at that width (bf16, remat,
                K2/K2b) over mag all_dense, global batch 16 with one BM25
                negative: (a) two gloo ranks sharing the card, child
                processes; (b) with several cards, one NCCL rank per card.
                Each: one batch's loss, grad_norm and per-group gradients on
                a rank's rows, summed over the ranks, against one device's
                on the whole batch, each rank's K2/K2b launches; one AdamW
                step leaving every rank's weights bit-equal, after which a
                validation batch's loss matches one device's after its
                step; Trainer.fit over the ranks (launches
                counted per rank), rank 0's checkpoint and
                restore_broadcast; (b) adds steps/s at global batches 16
                and 64 against one card and the gradient all-reduce's time
10b. train_tp -- tensor-parallel training (--n-model) at that width with
                BERT-base's 30522-word vocabulary (4 layers where two ranks
                share the card, 12 on four cards): (a) two gloo ranks sharing
                card 0 as (data 1 x model 2): one batch's loss, grad_norm and
                joined gradients against one card's, each rank's K2/K2b
                launches at 6 heads, after one AdamW step the replicated
                leaves and joined weights bit-equal on both ranks and a
                validation loss against one card's; Trainer.fit (launches
                counted a rank), rank 0's checkpoint in one card's layout,
                restore_broadcast; (b) GTR-T5-base with Adafactor on that
                pair; after each step the joined weights against one card's
                optimizer stepped on the joined gradients; (c) with four cards, one
                NCCL rank a card (the phase train_tp_cards, skipped on
                fewer), (data 2 x model 2) and (data 1 x model 4) held as
                (a), the vocabulary guard at 4, steps/s at global batches
                16 and 64 beside one card and the data-parallel four, peak
                memory, the model-group all-reduces of a step counted and
                replayed for their time, then the train command with
                --n-model 2 over the four; (d) K2/K2b against their plain
                versions at [96, 6, 512, 64] and [96, 3, 512, 64], with
                times and bounds; (e) train --n-model 2 over two gloo ranks
                sharing card 0, then a one-card retrieve --checkpoint-dir
11. train_cli -- the train command on a dataset directory and a BERT
                directory, one iteration on the card, then retrieve
                --checkpoint-dir on its output
11b. f32     -- K2's other routes on the main paths: (a) Contriever-base
                width in f32 (--precision 32) with attention "auto": the
                build of the cli phase's 512 docs (the 3xTF32 forward)
                against plain attention's, rerank (K1 on the f32 index) and
                exact against the plain-attention engine, one train batch
                against the plain path, Trainer.fit for 6 steps (the 3xTF32
                forward and backward); (b) a BERT directory at
                all-MiniLM-L6-v2's width (bf16, D = 32: the wgmma forward
                and backward at one slab) through prepare_model: the build
                against "xla", one train batch; (c) the same at
                TinyBERT_General_4L_312D's width (D = 26: the wgmma forward
                on row maps, the wgmma backward on zero-padded copies); (d)
                one train batch at that width in f32 (the 3xTF32 forward on
                row maps, the 3xTF32 backward on zero-padded copies)
12. serving  -- the same engine over a prebuilt random [131072, 5, 768] bf16
                corpus in rerank mode: QPS, one batch's stages, and the
                device's busy share and time by kernel from torch.profiler
13. hybrid   -- all_dense,all_sparse (10 mixer fields) on the e2e corpus:
                the K2-built matrix and a native BM25 index per sparse
                field; exact mode on the postings route (queries of rare
                words) and on the combined route (the e2e queries, whose
                postings are dense) against a brute-force reference (the
                dense scan plus the weight-mixed full scores of the scipy
                BM25 backend); rerank through K1 with sparse stages 1b and 2
                against the plain-gather engine; a sparse-only engine; every
                sparse field masked against a dense-only engine
14. hybrid_serving -- 131072 mag-shaped documents (STaRK-Prime's entity
                count) with native BM25 over the 5 sparse fields and the
                serving phase's random bf16 matrix: BM25 build seconds,
                postings width, exact (postings route) and rerank QPS on
                8-word queries, exact (combined route) QPS on 12-word
                queries, one batch's stages, a torch.profiler window, one
                batch of each route against the reference; the int8
                corpus's two hybrid routes and the host stream's postings
                route (against a device-resident engine); the scatter-free
                bucketed op (fused_hybrid_topk_buckets_from_query) beside
                the scatter route on one batch, against it; the drift (below)
                of the postings route, the bucketed op, hybrid rerank, the
                int8 postings route and the host stream's postings route
15. hybrid_cli -- the port's own command chain at Contriever-base width:
                make_synth_data, create_sparse_index,
                precompute_sparse_scores, train --field-names
                all_dense,all_sparse --sparse-scores-path, mask_fields on
                its output, retrieve --lexical-index --checkpoint-dir, and
                serve --smoke-out in rerank (K1) and exact mode against the
                same engine
16. gtr      -- the T5/GTR family at GTR-T5-base's published widths with
                seeded weights, written as a local sentence-transformers
                directory and loaded by prepare_model: the e2e corpus's bf16
                index (a subset against an f32 build), rerank (K1) and exact
                serving against references, serve --smoke-out, Trainer.fit
                with Adafactor and remat (steps/s, tokens/s, peak memory, a
                profiled step, a checkpoint round trip), the train command
                and retrieve --checkpoint-dir, and a seq2seq grafted from a
                seeded local T5-base directory (bf16 logits against f32)
17. mesh     -- serving over several ranks (mfar_tpu_torch.parallel): (a) one
                NCCL rank (a world of 1 made here, make_mesh over it): the
                mesh engine, exact and rerank, dense and all_dense,all_sparse,
                on the e2e corpus and the [131072, 5, 768] corpus, against the
                one-device engine; (b) two gloo ranks sharing the card, child
                processes: the 2048-doc build split over them through K2
                against the one-device K2 build, the routes of (a) on 2047
                docs, and the daemon (rank 0's RetrievalServer over
                MultihostEngineProxy, rank 1 in follower_loop) answering HTTP
                requests from here, against retrieve; each rank's K2 launches
                join K2's count; (c) with several cards, one NCCL rank per
                card: encode_corpus (the MFAR_* triple), retrieve and serve
                --smoke-out (torchrun --multihost pod) against one card's
                output, exact and rerank QPS at batch 256 over the
                [1048576, 5, 768] bf16 corpus (each rank making only its rows)
                beside one card's, and the daemon with 64 HTTP clients for 10 s;
                (a) and (b) serve each case over the corpus on the card in bf16
                and int8 and in host memory in bf16 and int8, against the
                one-device engine of the same placement; (b) also holds the
                drift (below) of dense exact and rerank and hybrid postings
                and rerank on the card in bf16, on both ranks alike
18. mesh_capacity -- with several cards, one NCCL rank per card (skipped
                on one): retrieve --quantize int8 and retrieve
                --corpus-on-host under torchrun against one card's, and
                mask_fields --corpus-on-host over the ranks against one
                card's; the [1048576, 5, 768] corpus (each rank making its
                rows) as int8 on the cards, exact and rerank, and in host
                memory from one f32 .npy every rank memmaps, streamed in bf16
                and int8: QPS at batch 256 on one card, then on every card,
                bytes and peak memory a card, stream GB/s a card against one
                pinned copy, the ranks' answers against one card's; then
                33554432 int8 rows over the cards (more than one card
                holds), exact, 64 queries against rank 0's own scan of every
                row made again on its card
19. serve    -- the serving daemon (mfar_tpu_torch.serve) over a random bf16
                [1048576, 5, 768] corpus made on the card: first the drift
                (below) of exact at three query sets, with whether the
                encoded queries move, and of rerank through K1, K1x and the
                plain gather, then max_batch 256, max_wait_ms 5, top_k 100, 64
                closed-loop HTTP clients of 8 queries in a child process,
                10 s a run; exact at pipeline depth 2, 1, 2, then rerank
                through K1: QPS, request latency p50/p95, batch fill, the
                dispatcher's phase seconds, K1 launches; the port closed
                until warmup ends; sampled answers == engine.retrieve (a
                failure also says whether the answer is engine.retrieve on
                the whole batch the daemon served it in)
20. int8     -- that corpus quantized on the card: exact QPS in bf16 and int8
                in turns, corpus bytes, recall@100 of int8 against bf16, a
                131072-row slice against a brute-force int8 reference with
                exact integer dots, int8_dot (torch._int_mm) at a 1-query
                batch and row counts off a multiple of 8, int8 rerank on the
                e2e corpus; the drift (below) of int8 exact and rerank
21. host_stream -- that corpus copied to host memory (cut if MemAvailable is
                short of 3x it) and streamed per scan in bf16 and int8: QPS,
                chunks, the achieved copy rate against one pinned copy of a
                chunk, device memory over the encoder's working set, every
                batch against the device-resident engines; the drift (below)
                of both streams

The drift of a served route (answer_drift): 8 queries of one bucket width
retrieved alone against the same queries first in batches of 16-256 and
last in one of 256, and 256 queries retrieved twice; every answer must be
the same bits, as the JAX daemon's one compiled shape and XLA's scatter
give.  A route that moves is named with the first aten operator whose
outputs move (first_moved_op), and the run fails at its end, after every
phase has reported.  ``--phases hybrid_serving,mesh,serve,int8,host_stream``
runs every drift check.

TF32 is switched off for matmuls and cuDNN, so f32 comparisons run in full
f32.  Any failed check raises and the run exits non-zero; a rank that fails
or outlives its timeout fails the mesh or train_mesh phase, and every rank
is killed.  ``--phases`` runs only the listed phases (and those they read
from) after device and build, e.g. ``--phases build,mesh``, ``--phases
build,mesh_capacity``, ``--phases train,train_mesh`` or ``--phases
build,train_tp_cards`` on four cards.  The last two
lines are one JSON object with every kernel's numbers (in a run of every
phase) and one with ``"ok": true`` and the device.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import contextlib
import dataclasses
import hashlib
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.nn import functional as F

from mfar_tpu_torch.commands import (
    create_sparse_index,
    encode_corpus,
    make_synth_data,
    mask_fields,
    precompute_sparse_scores,
)
from mfar_tpu_torch.commands import retrieve as retrieve_cmd
from mfar_tpu_torch.commands import serve as serve_cmd
from mfar_tpu_torch.commands import train as train_cmd
from mfar_tpu_torch.commands.common import (
    build_engine,
    corpus_texts_for_vocab,
    load_corpus,
    load_negative_sampler_index,
)
from mfar_tpu_torch.data import trec
from mfar_tpu_torch.data.negative_sampler import IndexNegativeSampler
from mfar_tpu_torch.data.format import format_documents
from mfar_tpu_torch.data.schema import resolve_fields
from mfar_tpu_torch.data.types import Corpus
from mfar_tpu_torch.eval.compare import mismatched_queries, rankings_agree
from mfar_tpu_torch.eval.index_build import (
    build_dense_corpus_matrix,
    build_sparse_indices,
    load_dense_matrix,
    make_encode_fn,
)
from mfar_tpu_torch.eval.retrieval import RetrievalEngine, query_call_rows, topk_chunk
from mfar_tpu_torch.models import T5Config, build_encoder
from mfar_tpu_torch.models.encoder import Encoder, EncoderConfig, init_encoder
from mfar_tpu_torch.models.registry import prepare_model, save_bert_dir, save_gtr_dir, save_t5_dir
from mfar_tpu_torch.models.t5_decoder import T5Seq2Seq, T5Seq2SeqConfig, init_t5_seq2seq
from mfar_tpu_torch.models.t5_encoder import init_t5_encoder
from mfar_tpu_torch.models.tokenizer import SimpleVocabTokenizer
from mfar_tpu_torch.ops import _build
from mfar_tpu_torch.parallel import tensor_parallel
from mfar_tpu_torch.scripts import compare_results, corpus_stats, find_failures
from mfar_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_bwd_headdim_dkv,
    flash_attention_bwd_headdim_dq,
    flash_attention_bwd_plain,
    flash_attention_fwd,
    flash_attention_headdim,
    flash_attention_plain,
    flash_attention_rows,
    flash_attention_tf32,
    flash_attention_tf32_bwd_dkv,
    flash_attention_tf32_bwd_dq,
    flash_attention_tf32_rows,
    pad_heads,
    _row_dots,
)
from mfar_tpu_torch.ops.gather_scores import (
    gather_per_field_scores,
    gather_per_field_scores_plain,
)
from mfar_tpu_torch.ops.scoring import (
    HOST_STREAM_CHUNK,
    bucket_postings_np,
    fused_hybrid_topk_buckets_from_query,
    fused_hybrid_topk_postings_from_query,
    int8_dot,
)
from mfar_tpu_torch.serve import RetrievalServer
from mfar_tpu_torch.sparse.bm25 import BM25Index
from mfar_tpu_torch.sparse.tokenize import STOPWORDS_EN
from mfar_tpu_torch.train.data_pipeline import (
    ContrastiveDataset,
    clean_query,
    strip_meta,
    token_stats,
)
from mfar_tpu_torch.train.model import MFARModel
from mfar_tpu_torch.train.optim import make_optimizer, param_labels
from mfar_tpu_torch.train.train_step import eval_loss_step, init_state, to_device, train_step
from mfar_tpu_torch.train.trainer import Trainer, TrainerConfig

DEVICE = "cuda"
CARD = "card not read yet"  # nvidia-smi's name and power limit, set by main
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
F32_FLOPS_PER_S = 67e12  # H100 SXM f32 rate outside the tensor cores
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate
TF32_FLOPS_PER_S = 495e12  # H100 SXM dense TF32 tensor-core rate

# K1's tolerance against its plain version: both sum f32 products of the
# same values, in different orders.
K1_ATOL = K1_RTOL = 1e-4
# K2 against its plain version: both round the output to bf16 (one ulp is up
# to 1.6e-2 for outputs in [2, 4)), and K2 rounds the softmax weights to
# bf16 for the P.V product where the plain version stays in f32.
K2_ATOL = K2_RTOL = 1e-2
# Engine against engine / reference: bf16 rows upcast and summed in f32 in
# different orders, at scores of magnitude ~10-100.
E2E_RTOL, E2E_ATOL = 1e-4, 1e-3
# The corpus matrix through K2 against the one through plain attention, and
# long-query scores of the two engines: bf16 activations through 12 layers,
# where a bf16 rounding that differs in one layer's attention output (one
# ulp is 2**-8 relative) carries through the rest.
INDEX_MIN_COSINE = 0.999  # per embedding row
INDEX_MAX_REL_ERR = 2e-2  # max abs difference over the matrix's max abs value
LONG_RTOL, LONG_ATOL = 2e-2, 1e-2
# K2b against its plain version: the gradients are rounded to bf16 (one ulp
# is 2**-8 relative), and the kernels round P and dS to bf16 (2**-9
# relative) before products summed over up to 512 rows, where the plain
# version stays in f32: rtol 2e-2, and atol 1e-2 of the largest gradient
# (entries near 0 carry the absolute error of the large ones they sum).
K2B_RTOL, K2B_ATOL_REL = 2e-2, 1e-2
# the forward's logsumexp against the plain one: both sum f32 exponentials
# of the same f32 logits, in different orders and bases (exp2 in the kernel)
K2B_LSE_ATOL = 1e-3
# dq's di against the plain row dots: f32 sums of the same 64 products of
# bf16 values, in another order: rtol 1e-5, atol 1e-5 of the largest |di|
K2B_DI_RTOL, K2B_DI_ATOL_REL = 1e-5, 1e-5
# One train step's loss and gradients through K2/K2b against the plain path
# on the same weights, batch and dropout masks: bf16 activations through 12
# layers forward and back, where the two paths round attention at different
# places (K2 rounds P to bf16 inside the kernel, the plain path rounds the
# f32 softmax); the loss (~6) agrees to 1e-2 relative, the global gradient
# norm to 5e-2, and each optimizer group's gradient points the same way.
TRAIN_LOSS_RTOL, TRAIN_NORM_RTOL, TRAIN_MIN_COSINE = 1e-2, 5e-2, 0.99
# One step after a checkpoint restore against the same step without one:
# the same state, batch and dropout masks through deterministic kernels
# (K2/K2b use no atomics); any difference is the order of cuBLAS's sums.
CKPT_ATOL = 1e-6
# K2/K2b's f32 routes (3xTF32) against the plain version, in f32 (TF32
# off): f32-accurate products summed in other orders; the output within
# 2e-5, the logsumexp within 1e-5, each gradient within 2e-5 of its largest
# entry.  In bf16 the K2 and K2b gates above hold.
K2G_ATOL, K2G_LSE_ATOL, K2G_GRAD_REL = 2e-5, 1e-5, 2e-5
# The slice's f32 path against plain attention on the same weights: the
# f32 index within 1e-4 (max abs) of the "xla"-built one; one train batch's
# loss within 1e-5 relative, its gradient norm within 1e-4 relative and each
# group's gradient cosine >= 0.9999 (f32 through 12 layers, attention
# summed in another order)
F32_INDEX_ATOL = 1e-4
F32_LOSS_RTOL, F32_NORM_RTOL, F32_MIN_COSINE = 1e-5, 1e-4, 0.9999


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def time_cuda(fn, reps: int = 21, inner: int = 10, warmup: int = 3) -> float:
    """Milliseconds per call of ``fn()``: CUDA events around ``inner``
    back-to-back calls, divided by ``inner``; the median of ``reps`` such
    runs after ``warmup`` calls.  Back-to-back launches keep the host's
    launch overhead off the device timeline, so this is device time."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


# ----------------------------------------------------------------------
# phase 3: K1 against its plain version


def k1_inputs(gen, b, c, n, f, e, dtype):
    """Inputs with the edge cases: repeated ids, rows 0 and N-1, and one
    query whose candidates are all the same row."""
    docs = torch.randn(n, f * e, device=DEVICE, generator=gen).to(dtype)
    q = torch.randn(b, e, device=DEVICE, generator=gen)
    ids = torch.randint(0, n, (b, c), device=DEVICE, generator=gen)
    ids[0, : min(c, 4)] = 0  # first row, repeated
    ids[-1, -1] = n - 1  # last row
    ids[b // 2, :] = ids[b // 2, 0].item()  # one query's candidates all the same row
    return q, docs, ids


def serving_ids(gen, b, c, n):
    """Candidate ids as the engine's stage 2 gets them: distinct and sorted
    within each query (the ``np.unique`` union); queries may share rows."""
    ids = torch.rand(b, n, device=DEVICE, generator=gen).topk(c, dim=1).indices
    return ids.sort(dim=1).values.contiguous()


def k1_bound(ids, f, e, dtype):
    """Least time for K1's work on these ids: each input read once, the
    output written once (the distinct candidate rows + ids + q + out) over
    the memory rate, against the f32 multiply-adds over the f32 rate; the
    larger one bounds it.  Returns (ms, bound_by, distinct rows)."""
    b, c = ids.shape
    rows = torch.unique(ids).numel()
    elem = torch.empty((), dtype=dtype).element_size()
    nbytes = rows * f * e * elem + b * c * 8 + b * e * 4 + b * c * f * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * b * c * f * e / F32_FLOPS_PER_S * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", rows
    return t_ops, "operations", rows


def library_gather_scores(q, docs, ids, f):
    """One PyTorch gather + one einsum: a yardstick only, never called by
    the port."""
    b, c = ids.shape
    rows = torch.index_select(docs, 0, ids.reshape(-1)).view(b, c, f, -1).float()
    return torch.einsum("be,bcfe->bcf", q, rows)


def same_bits(a, b) -> bool:
    """Two f32 tensors hold the same bits (NaN included)."""
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def check_k1x(q, docs, ids, f, k1_out, label) -> tuple:
    """K1x, the cross-row schedule, on the inputs K1 just scored: against
    the plain version at K1's tolerance (NaN where an id lies outside [0,
    N), as K1), and whether its bits are K1's.  Returns (max abs err,
    bit-equal)."""
    got = gather_per_field_scores(q, docs, ids, f, cross_row=True)
    torch.cuda.synchronize()
    n = docs.shape[0]
    valid = (ids >= 0) & (ids < n)
    want = gather_per_field_scores_plain(q, docs, ids.clamp(0, n - 1), f)
    check(bool(torch.isnan(got[~valid]).all()), f"K1x {label}: an id outside [0, N) scored a value")
    got_v, want_v = got[valid], want[valid]
    err = (got_v - want_v).abs().max().item() if got_v.numel() else 0.0
    check(torch.allclose(got_v, want_v, rtol=K1_RTOL, atol=K1_ATOL),
          f"K1x {label}: max err {err} against the plain version")
    return err, same_bits(got, k1_out)


def run_k1(seed: int, serving_shape=(64, 512, 131072, 5, 768)) -> dict:
    """K1 and K1x (the cross-row schedule) against the plain version, and
    K1x against K1's bits, on edge cases and at the serving shapes; times of
    both kernels, the plain version and the library yardstick."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    max_err = k1x_err = 0.0
    bit_equal = True
    # edge cases at small N: odd C, B=1, F=1, C < one block of candidates;
    # for K1x also a candidate count that no warp's span divides (7 x 37
    # over the persistent grid's warps: spans end inside query rows), one
    # that leaves most warps without a candidate (5 x 1), and ids outside
    # [0, N) among valid ones
    for b, c, n, f, e in [(1, 7, 33, 1, 128), (3, 13, 101, 4, 128), (5, 1, 9, 5, 768),
                          (2, 129, 1001, 3, 256), (7, 37, 1001, 5, 768)]:
        for dtype in (torch.bfloat16, torch.float32):
            q, docs, ids = k1_inputs(gen, b, c, n, f, e, dtype)
            label = f"{dtype} B={b} C={c} N={n} F={f} E={e}"
            got = gather_per_field_scores(q, docs, ids, f)
            torch.cuda.synchronize()
            want = gather_per_field_scores_plain(q, docs, ids, f)
            err = (got - want).abs().max().item()
            check(torch.allclose(got, want, rtol=K1_RTOL, atol=K1_ATOL),
                  f"K1 {label}: max err {err}")
            max_err = max(max_err, err)
            err_x, same = check_k1x(q, docs, ids, f, got, label)
            k1x_err, bit_equal = max(k1x_err, err_x), bit_equal and same
            bad = ids.clone()
            bad[0, 0], bad[-1, -1], bad[b // 2, c // 2] = -1, n, n + 7
            err_x, same = check_k1x(q, docs, bad, f, gather_per_field_scores(q, docs, bad, f),
                                    f"{label}, ids outside [0, N)")
            k1x_err, bit_equal = max(k1x_err, err_x), bit_equal and same
    phase("k1", f"edge cases (odd C, B=1, F=1, small N) agree, max abs err {max_err:.3g}; "
                f"K1x on them and on ids outside [0, N) (NaN, as K1): max abs err "
                f"{k1x_err:.3g}, bit-equal to K1: {bit_equal}")

    # serving shapes: checked on the edge-case ids and on serving ids, timed
    # on the serving ids, whose distinct rows the bound counts
    b, c, n, f, e = serving_shape
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, docs, edge_ids = k1_inputs(gen, b, c, n, f, e, dtype)
        ids = serving_ids(gen, b, c, n)
        for label, i in (("edge-case", edge_ids), ("serving", ids)):
            got = gather_per_field_scores(q, docs, i, f)
            torch.cuda.synchronize()
            want = gather_per_field_scores_plain(q, docs, i, f)
            err = (got - want).abs().max().item()
            check(torch.allclose(got, want, rtol=K1_RTOL, atol=K1_ATOL),
                  f"K1 {dtype} at serving shapes, {label} ids: max err {err}")
            max_err = max(max_err, err)
            err_x, same = check_k1x(q, docs, i, f, got, f"{dtype} at serving shapes, {label} ids")
            k1x_err, bit_equal = max(k1x_err, err_x), bit_equal and same
        lib = library_gather_scores(q, docs, ids, f)
        check(torch.allclose(lib, want, rtol=K1_RTOL, atol=K1_ATOL), "library yardstick disagrees")
        bound_ms, bound_by, distinct = k1_bound(ids, f, e, dtype)
        # in turns: K1, K1x, K1x, K1 (the medians of the two of each)
        k1_ms, k1x_ms = [], []
        for fn, into in ((False, k1_ms), (True, k1x_ms), (True, k1x_ms), (False, k1_ms)):
            into.append(time_cuda(lambda: gather_per_field_scores(q, docs, ids, f,
                                                                  cross_row=fn)))
        r = dict(
            kernel_ms=statistics.mean(k1_ms), cross_row_ms=statistics.mean(k1x_ms),
            kernel_ms_runs=k1_ms, cross_row_ms_runs=k1x_ms,
            plain_ms=time_cuda(lambda: gather_per_field_scores_plain(q, docs, ids, f)),
            library_ms=time_cuda(lambda: library_gather_scores(q, docs, ids, f)),
            bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err, cross_row_max_abs_err=err_x,
            distinct_rows=distinct,
        )
        name = "bf16" if dtype == torch.bfloat16 else "f32"
        rows[name] = r
        corpus_gb = docs.numel() * docs.element_size() / 1e9
        phase("k1", f"{name} B={b} C={c} N={n} F={f} E={e} ({corpus_gb:.2f} GB corpus; "
                    f"ids distinct per query, {distinct} distinct rows of {b * c}): "
                    f"max abs err {err:.3g} (K1x {err_x:.3g}); kernel_ms {r['kernel_ms']:.4f} "
                    f"({k1_ms[0]:.4f} / {k1_ms[1]:.4f}), K1x cross_row_ms "
                    f"{r['cross_row_ms']:.4f} ({k1x_ms[0]:.4f} / {k1x_ms[1]:.4f}), in turns "
                    f"K1, K1x, K1x, K1; plain_ms {r['plain_ms']:.4f} library_ms "
                    f"{r['library_ms']:.4f} bound_ms {bound_ms:.4f} ({bound_by}); "
                    f"K1 {r['bound_ms'] / r['kernel_ms']:.1%}, K1x "
                    f"{r['bound_ms'] / r['cross_row_ms']:.1%} of the bound")
        del q, docs, ids, edge_ids, got, want, lib
    rows["max_abs_err"] = max_err
    rows["k1x_max_abs_err"] = k1x_err
    rows["k1x_bit_equal"] = bit_equal
    phase("k1", f"K1x bit-equal to K1 on every case: {bit_equal}")
    return rows


# ----------------------------------------------------------------------
# phase 4: K2 against its plain version


def k2_inputs(gen, b, h, s, lengths):
    """bf16 q/k/v as the encoder gives them ([B, S, H*D] projections viewed
    as [B, H, S, D], not contiguous) and int32 segment ids: 1 for the first
    lengths[i] tokens of row i, 0 for the pad after them."""
    q, k, v = (torch.randn(b, s, h * 64, device=DEVICE, generator=gen).bfloat16()
               .view(b, s, h, 64).transpose(1, 2) for _ in range(3))
    lengths = torch.as_tensor(lengths, device=DEVICE)
    seg = (torch.arange(s, device=DEVICE)[None, :] < lengths[:, None]).to(torch.int32)
    return q, k, v, seg


def library_attention(q, k, v, seg, scale):
    """One PyTorch SDPA call with the boolean segment mask: a yardstick
    only, never called by the port."""
    same = seg[:, None, :, None] == seg[:, None, None, :]
    return F.scaled_dot_product_attention(q, k, v, attn_mask=same, scale=scale)


def flops_rate(q) -> float:
    """The card's rate for the products' arithmetic: the bf16 tensor cores
    for bf16 inputs; for f32, three TF32 products a product (3xTF32: an
    f32-accurate product is the least the card can do in f32 on its tensor
    cores; one TF32 product would not keep f32 products)."""
    return TF32_FLOPS_PER_S / 3 if q.dtype == torch.float32 else BF16_FLOPS_PER_S


def k2_bound(q, seg, lse=False):
    """Least time for K2's work on these inputs: q/k/v read once, the output
    (and with ``lse`` the f32 row logsumexp) written once, the segment ids
    read once, over the memory rate, against the two products' operations
    over ``flops_rate``, counted for the same-segment (query, key) pairs
    only (all the masked pairs add nothing); the larger one bounds it.
    Returns (ms, bound_by, the bytes time, the operations time)."""
    b, h, s, d = q.shape
    nbytes = 4 * b * h * s * d * q.element_size() + seg.numel() * 4 + lse * b * h * s * 4
    pairs = sum((r[:, None] == r[None, :]).sum().item() for r in seg)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 4 * h * d * pairs / flops_rate(q) * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", t_bytes, t_ops
    return t_ops, "operations", t_bytes, t_ops


def check_k2(q, k, v, seg, label) -> float:
    scale = 1.0 / math.sqrt(q.shape[-1])
    got = flash_attention(q, k, v, seg, scale)
    torch.cuda.synchronize()
    want = flash_attention_plain(q, k, v, seg, scale)
    err = (got.float() - want.float()).abs().max().item()
    check(torch.allclose(got.float(), want.float(), rtol=K2_RTOL, atol=K2_ATOL),
          f"K2 {label}: max abs err {err}")
    return err


def masked_logsumexp(q, k, seg, scale):
    """The plain row logsumexp of the scaled logits over each row's segment."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    same = seg[:, None, :, None] == seg[:, None, None, :]
    return torch.logsumexp(logits.masked_fill_(~same, float("-inf")), dim=-1)


def check_k2_lse(q, k, v, seg, label):
    """K2 with the logsumexp (the forward training runs): its output against
    the plain version and its logsumexp against ``masked_logsumexp``.
    Returns (out, lse, max abs err of the output, of the logsumexp)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    out, lse = flash_attention_fwd(q, k, v, seg, scale)
    torch.cuda.synchronize()
    want = flash_attention_plain(q, k, v, seg, scale)
    err = (out.float() - want.float()).abs().max().item()
    check(torch.allclose(out.float(), want.float(), rtol=K2_RTOL, atol=K2_ATOL),
          f"K2 with the logsumexp {label}: max abs err {err}")
    lse_err = (lse - masked_logsumexp(q, k, seg, scale)).abs().max().item()
    check(lse_err <= K2B_LSE_ATOL, f"K2 logsumexp {label}: max abs err {lse_err}")
    return out, lse, err, lse_err


# edge cases of the segment ids: runs of 2/1/0, ids that return after
# another segment (defeating a valid-prefix assumption), tiles of ids 0 and 2
# alternating against a tile of 1 (their [min, max] meets, no id is shared),
# a row all of one id, and tile pairs wholly masked in both directions
SEG_CASES = [
    (2, 2, 512, [[2] * 100 + [1] * 150 + [0] * 262,
                 [1] * 70 + [0] * 58 + [1] * 128 + [0] * 256]),
    (3, 2, 256, [[0, 2] * 32 + [1] * 64 + [2] * 128, [7] * 256,
                 [0] * 64 + [3] * 64 + [0] * 64 + [3] * 64]),
    (1, 1, 128, [[1] * 40 + [0] * 30 + [2] * 58]),
    (1, 3, 384, [[5] * 128 + [4] * 128 + [5] * 128]),
]


def run_k2(seed: int, build_shape=(256, 12, 512), train_shape=(96, 12, 512)) -> dict:
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 3)
    max_err = lse_err = 0.0
    # edge cases: S = 128, 256 and 384, B = 1, H = 1, a row of 2 tokens, a
    # full row, and pad rows whose first key tiles are all valid tokens
    # (wholly masked for them: lengths 70, 131, 150, 200)
    for b, h, s, lengths in [(1, 12, 128, [70]), (3, 1, 256, [2, 256, 131]),
                             (2, 4, 512, [512, 200]), (4, 2, 128, [128, 2, 64, 127]),
                             (2, 2, 384, [384, 150])]:
        err = check_k2(*k2_inputs(gen, b, h, s, lengths), f"B={b} H={h} S={s} {lengths}")
        max_err = max(max_err, err)
    # the segment-id cases, with the logsumexp too
    for b, h, s, rows in SEG_CASES:
        label = f"B={b} H={h} S={s} {[r if isinstance(r, int) else '...' for r in rows]}"
        q, k, v, seg, _ = k2b_inputs(gen, b, h, s, rows)
        max_err = max(max_err, check_k2(q, k, v, seg, label))
        _, _, err, e = check_k2_lse(q, k, v, seg, label)
        max_err, lse_err = max(max_err, err), max(lse_err, e)
    phase("k2", f"edge cases (S=128/256/384, B=1, H=1, wholly masked key tiles, several "
                f"segments, interleaved ids, one-segment rows) agree, max abs err "
                f"{max_err:.3g}; logsumexp max abs err {lse_err:.3g} (atol {K2B_LSE_ATOL})")

    b, h, s = build_shape
    rng = np.random.default_rng(seed)
    lengths = rng.integers(2, s + 1, size=b)
    lengths[0], lengths[1] = s, 2  # a full row and a row of 2 valid tokens
    q, k, v, seg = k2_inputs(gen, b, h, s, lengths.tolist())
    err = check_k2(q, k, v, seg, f"at {list(q.shape)}")
    max_err = max(max_err, err)
    scale = 1.0 / math.sqrt(q.shape[-1])
    lib = library_attention(q, k, v, seg, scale)
    want = flash_attention_plain(q, k, v, seg, scale)
    check(torch.allclose(lib.float(), want.float(), rtol=K2_RTOL, atol=K2_ATOL),
          "library yardstick disagrees")
    del lib, want
    bound_ms, bound_by, bytes_ms, ops_ms = k2_bound(q, seg)
    skip_blocks, skip_groups = skipped_tile_pairs(seg)
    r = dict(
        kernel_ms=time_cuda(lambda: flash_attention(q, k, v, seg, scale)),
        plain_ms=time_cuda(lambda: flash_attention_plain(q, k, v, seg, scale), reps=5, inner=2),
        library_ms=time_cuda(lambda: library_attention(q, k, v, seg, scale), reps=11, inner=5),
        bound_ms=bound_ms, bound_by=bound_by, skipped_block_tiles=skip_blocks,
        skipped_group_tiles=skip_groups,
    )
    phase("k2", f"bf16 {list(q.shape)} (segment lengths {int(lengths.min())}-"
                f"{int(lengths.max())}, mean {lengths.mean():.1f}): max abs err {err:.3g} "
                f"(tolerance rtol=atol={K2_ATOL}); kernel_ms {r['kernel_ms']:.4f} "
                f"plain_ms {r['plain_ms']:.4f} library_ms {r['library_ms']:.4f} "
                f"bound_ms {bound_ms:.4f} ({bound_by}; bytes {bytes_ms:.4f}, operations "
                f"{ops_ms:.4f}); {bound_ms / r['kernel_ms']:.1%} of the bound; key tiles "
                f"skipped: {skip_blocks:.1%} of (128-row block, 64-key tile) pairs, "
                f"{skip_groups:.1%} of (warpgroup, tile) products")
    del q, k, v, seg

    # with the logsumexp, at the training shape and lengths
    b, h, s = train_shape
    lengths = np.random.default_rng(seed + 5).integers(2, s + 1, size=b)
    lengths[0], lengths[1] = s, 2
    q, k, v, seg = k2_inputs(gen, b, h, s, lengths.tolist())
    _, _, err, e = check_k2_lse(q, k, v, seg, f"at {list(q.shape)}")
    max_err, lse_err = max(max_err, err), max(lse_err, e)
    lse_bound = k2_bound(q, seg, lse=True)
    r.update(
        lse_ms=time_cuda(lambda: flash_attention_fwd(q, k, v, seg, scale)),
        lse_bound_ms=lse_bound[0], lse_bound_by=lse_bound[1],
        lse_library_ms=time_cuda(lambda: library_attention(q, k, v, seg, scale), reps=11, inner=5),
        max_abs_err=max_err, lse_max_abs_err=lse_err,
    )
    phase("k2", f"with the logsumexp, bf16 {list(q.shape)} (segment lengths "
                f"{int(lengths.min())}-{int(lengths.max())}, mean {lengths.mean():.1f}): max "
                f"abs err {err:.3g}, logsumexp {e:.3g}; lse_ms {r['lse_ms']:.4f} (bound "
                f"{lse_bound[0]:.4f}, {lse_bound[1]}; {lse_bound[0] / r['lse_ms']:.1%}); SDPA "
                f"forward {r['lse_library_ms']:.4f}")
    return r


# ----------------------------------------------------------------------
# phase 5: K2b (the backward kernels) against their plain version


def k2b_bound(q, seg):
    """Least times for K2b's work on these inputs, each the larger of its
    bytes over the memory rate and its operations (counted for the
    same-segment (query, key) pairs only) over ``flops_rate``:
    dq reads q, k, v, o, dO (bf16), lse (f32) and the segment ids and writes
    dq (bf16) and di (f32), three products; dkv reads q, k, v, dO, lse, di
    and the segment ids and writes dk and dv, four products; the whole
    backward reads q, k, v, o, dO, lse and the segment ids and writes dq, dk
    and dv, five products (S, dP, dV, dQ, dK), di never leaving the chip.
    Returns {name: (ms, bound_by)} for "dq", "dkv" and "bwd"."""
    b, h, s, d = q.shape
    tensor, rows = b * h * s * d * q.element_size(), b * h * s * 4
    pairs = sum((r[:, None] == r[None, :]).sum().item() for r in seg)
    out = {}
    for name, nbytes, n_products in (("dq", 6 * tensor + 2 * rows, 3),
                                     ("dkv", 6 * tensor + 2 * rows, 4),
                                     ("bwd", 8 * tensor + rows, 5)):
        t_bytes = (nbytes + seg.numel() * 4) / HBM_BYTES_PER_S * 1e3
        t_ops = 2 * n_products * h * d * pairs / flops_rate(q) * 1e3
        out[name] = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return out


def skipped_tile_pairs(seg, rows=128, tile=64):
    """The share of (block, streamed tile) pairs that K2b's kernels skip,
    and of (warpgroup, tile) products: a tile is skipped when the [min, max]
    of its segment ids misses that of the block's ``rows`` rows (or of the
    warpgroup's 64)."""
    b, s = seg.shape
    t = seg.view(b, s // tile, tile)
    lo, hi = t.min(dim=2).values, t.max(dim=2).values  # [B, tiles]

    def share(group):
        glo = lo.view(b, -1, group).min(dim=2).values  # [B, blocks]
        ghi = hi.view(b, -1, group).max(dim=2).values
        meets = (lo[:, None, :] <= ghi[:, :, None]) & (glo[:, :, None] <= hi[:, None, :])
        return 1.0 - meets.float().mean().item()

    return share(rows // tile), share(1)


def k2b_inputs(gen, b, h, s, rows):
    """k2_inputs with any segment ids (each entry of ``rows`` a valid length,
    as k2_inputs takes it, or a list of S ids) plus dO as autograd hands it
    to the attention: the gradient of the [B, S, H*D] context, viewed as
    [B, H, S, D]."""
    q, k, v, seg = k2_inputs(gen, b, h, s, [r if isinstance(r, int) else s for r in rows])
    for i, r in enumerate(rows):
        if not isinstance(r, int):
            seg[i] = torch.as_tensor(r, dtype=torch.int32, device=DEVICE)
    dout = torch.randn(b, s, h * 64, device=DEVICE, generator=gen).bfloat16()
    return q, k, v, seg, dout.view(b, s, h, 64).transpose(1, 2)


def check_k2b(q, k, v, seg, dout, label) -> float:
    """The forward's logsumexp against the plain one, then the backward
    kernels against the plain backward on the same o and lse, and dq's di
    against the plain row dots; returns the largest error relative to the
    largest gradient, and the largest absolute error of each kernel's
    gradients (dkv: dk and dv; dq)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    out, lse, _, _ = check_k2_lse(q, k, v, seg, label)
    got = flash_attention_bwd(q, k, v, seg, out, lse, dout, scale)
    torch.cuda.synchronize()
    want = flash_attention_bwd_plain(q, k, v, seg, out, lse, dout, scale)
    rel, abs_err = 0.0, {"dkv": 0.0, "dq": 0.0}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        check(g.shape == w.shape and g.dtype == q.dtype and g.transpose(1, 2).is_contiguous(),
              f"K2b {name} {label}: {tuple(g.shape)} {g.dtype}")
        g, w = g.float(), w.float()
        scale_w = w.abs().max().item()
        err = (g - w).abs().max().item()
        check(bool(torch.isfinite(g).all()), f"K2b {name} {label}: non-finite gradient")
        check(torch.allclose(g, w, rtol=K2B_RTOL, atol=K2B_ATOL_REL * scale_w),
              f"K2b {name} {label}: max abs err {err} (max |want| {scale_w})")
        kernel = "dq" if name == "dq" else "dkv"
        rel, abs_err[kernel] = max(rel, err / scale_w), max(abs_err[kernel], err)
    _, di = flash_attention_bwd_dq(q, k, v, seg, lse, out, dout, scale)
    want_di = _row_dots(out, dout)
    di_err = (di - want_di).abs().max().item()
    check(torch.allclose(di, want_di, rtol=K2B_DI_RTOL,
                         atol=K2B_DI_ATOL_REL * want_di.abs().max().item()),
          f"K2b di {label}: max abs err {di_err}")
    return rel, abs_err


def library_attention_fwd_bwd(q, k, v, seg, scale, dout):
    """SDPA with the boolean segment mask, forward and backward through
    autograd: a yardstick only, never called by the port."""
    out = library_attention(q, k, v, seg, scale)
    return torch.autograd.grad(out, (q, k, v), dout)


def run_k2b(seed: int, train_shape=(96, 12, 512)) -> dict:
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 5)
    rel, abs_err = 0.0, {"dkv": 0.0, "dq": 0.0}
    # edge cases: S = 128 and 256, B = 1, H = 1, valid lengths 64, 65, 127,
    # 131, 200 (pad queries and keys whose first tiles are wholly masked for
    # them), a row of 2 tokens and a full row; then the segment-id cases
    for b, h, s, rows in [(1, 12, 128, [65]), (3, 1, 256, [2, 256, 131]),
                          (2, 4, 512, [512, 200]), (4, 2, 128, [128, 64, 127, 2]),
                          (5, 3, 256, [64, 65, 127, 131, 200])] + SEG_CASES:
        label = f"B={b} H={h} S={s} {[r if isinstance(r, int) else '...' for r in rows]}"
        r, a = check_k2b(*k2b_inputs(gen, b, h, s, rows), label)
        rel, abs_err = max(rel, r), {k: max(v, a[k]) for k, v in abs_err.items()}
    phase("k2b", f"edge cases (S=128/256/384/512, B=1, H=1, lengths 64/65/127/131/200, "
                 f"several segments, interleaved ids, wholly masked tiles both ways) agree, "
                 f"max err {rel:.3g} of the largest gradient; dq's di agrees with the plain "
                 f"row dots (rtol {K2B_DI_RTOL}, atol {K2B_DI_ATOL_REL} x max |di|)")

    b, h, s = train_shape
    rng = np.random.default_rng(seed + 5)
    lengths = rng.integers(2, s + 1, size=b)
    lengths[0], lengths[1] = s, 2
    q, k, v, seg, dout = k2b_inputs(gen, b, h, s, lengths.tolist())
    r, a = check_k2b(q, k, v, seg, dout, f"at {list(q.shape)}")
    rel, abs_err = max(rel, r), {k: max(v, a[k]) for k, v in abs_err.items()}
    scale = 1.0 / math.sqrt(q.shape[-1])
    skip_blocks, skip_groups = skipped_tile_pairs(seg)

    # the autograd Function end to end against autograd through the plain version
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    launches = (flash_attention_bwd_dkv.launches, flash_attention_bwd_dq.launches)
    got = torch.autograd.grad(flash_attention(*leaves, seg, scale), leaves, dout)
    check((flash_attention_bwd_dkv.launches, flash_attention_bwd_dq.launches)
          == (launches[0] + 1, launches[1] + 1), "the autograd Function skipped a kernel")
    want = torch.autograd.grad(flash_attention_plain(*leaves, seg, scale), leaves, dout)
    fn_rel = 0.0
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        scale_w = w.float().abs().max().item()
        check(torch.allclose(g.float(), w.float(), rtol=K2B_RTOL, atol=K2B_ATOL_REL * scale_w),
              f"autograd Function {name}: max abs err {(g.float() - w.float()).abs().max()}")
        fn_rel = max(fn_rel, (g.float() - w.float()).abs().max().item() / scale_w)
    lib = library_attention_fwd_bwd(*leaves, seg, scale, dout)
    for name, g, w in zip(("dq", "dk", "dv"), lib, want):
        scale_w = w.float().abs().max().item()
        check(torch.allclose(g.float(), w.float(), rtol=K2B_RTOL, atol=K2B_ATOL_REL * scale_w),
              f"library yardstick {name} disagrees")
    del got, want, lib

    out, lse = flash_attention_fwd(q, k, v, seg, scale)
    _, di = flash_attention_bwd_dq(q, k, v, seg, lse, out, dout, scale)

    def fwd_bwd():
        return torch.autograd.grad(flash_attention(*leaves, seg, scale), leaves, dout)

    lib_out = library_attention(*leaves, seg, scale)
    r = dict(
        dq_ms=time_cuda(lambda: flash_attention_bwd_dq(q, k, v, seg, lse, out, dout, scale)),
        dkv_ms=time_cuda(lambda: flash_attention_bwd_dkv(q, k, v, seg, lse, di, dout, scale)),
        bwd_ms=time_cuda(lambda: flash_attention_bwd(q, k, v, seg, out, lse, dout, scale)),
        fwd_bwd_ms=time_cuda(fwd_bwd),
        plain_bwd_ms=time_cuda(
            lambda: flash_attention_bwd_plain(q, k, v, seg, out, lse, dout, scale), reps=5, inner=2),
        library_bwd_ms=time_cuda(
            lambda: torch.autograd.grad(lib_out, leaves, dout, retain_graph=True),
            reps=11, inner=5),
        library_fwd_bwd_ms=time_cuda(
            lambda: library_attention_fwd_bwd(*leaves, seg, scale, dout), reps=11, inner=5),
        max_rel_err=rel, dkv_max_abs_err=abs_err["dkv"], dq_max_abs_err=abs_err["dq"],
        function_max_rel_err=fn_rel, skipped_block_tiles=skip_blocks,
        skipped_group_tiles=skip_groups,
    )
    for name, (ms, by) in k2b_bound(q, seg).items():
        r[f"{name}_bound_ms"], r[f"{name}_bound_by"] = ms, by

    def vs_bound(name, ms):
        return (f"{ms:.4f} (bound {r[name + '_bound_ms']:.4f}, {r[name + '_bound_by']}; "
                f"{r[name + '_bound_ms'] / ms:.1%})")

    phase("k2b", f"bf16 {list(q.shape)} (segment lengths {int(lengths.min())}-"
                 f"{int(lengths.max())}, mean {lengths.mean():.1f}, dO as strided views): "
                 f"max err {rel:.3g} of the largest gradient (max abs err dkv "
                 f"{abs_err['dkv']:.3g}, dq {abs_err['dq']:.3g}), "
                 f"autograd Function vs plain "
                 f"autograd {fn_rel:.3g} (tolerance rtol {K2B_RTOL}, atol {K2B_ATOL_REL} x "
                 f"max |grad|); tile pairs skipped: {skip_blocks:.1%} of (128-row block, "
                 f"64-row tile) pairs, {skip_groups:.1%} of (warpgroup, tile) products; "
                 f"dq_ms with di {vs_bound('dq', r['dq_ms'])}, dkv_ms "
                 f"{vs_bound('dkv', r['dkv_ms'])}; whole backward {vs_bound('bwd', r['bwd_ms'])}, "
                 f"plain backward {r['plain_bwd_ms']:.4f}, SDPA backward "
                 f"{r['library_bwd_ms']:.4f}; K2 forward+backward through autograd "
                 f"{r['fwd_bwd_ms']:.4f}, SDPA forward+backward {r['library_fwd_bwd_ms']:.4f}; "
                 f"dO copies {flash_attention_bwd.dout_copies}")
    return r


# ----------------------------------------------------------------------
# phase 5b: K2/K2b's other routes (f32, bf16 at a head dim != 64, what TMA
# cannot read per head)


# K2b's kernel pairs (dq, dkv) by the backward's route
BWD_PAIRS = {"wgmma": (flash_attention_bwd_dq, flash_attention_bwd_dkv),
             "wgmma_headdim": (flash_attention_bwd_headdim_dq, flash_attention_bwd_headdim_dkv),
             "tf32": (flash_attention_tf32_bwd_dq, flash_attention_tf32_bwd_dkv)}


# the pairs that run wide instances past a head dim (bf16 past 128: one
# warpgroup a block; f32 past 64: 32-row half tiles; dkv split into dV and
# dK blocks), by the route that names them
WIDE_PAIRS = {"wgmma_headdim": 128, "tf32": 64}


def k2_counts() -> dict:
    """Launches of K2's five forward kernels, by the route that names them
    (the padding routes count under the kernel they run, and apart as
    ``<route>_fwd``), and of K2b's three pairs (``<route>_dkv``,
    ``<route>_dq``; the wide instances also apart, ``<route>_wide_dkv``,
    ``<route>_wide_dq``)."""
    out = {"wgmma": flash_attention.launches, "wgmma_headdim": flash_attention_headdim.launches,
           "tf32": flash_attention_tf32.launches, "wgmma_rows": flash_attention_rows.launches,
           "tf32_rows": flash_attention_tf32_rows.launches}
    for route in PAD_MULTIPLE:
        out[f"{route}_fwd"] = flash_attention.pad_launches[route]
    for route, (dq_fn, dkv_fn) in BWD_PAIRS.items():
        out[f"{route}_dkv"], out[f"{route}_dq"] = dkv_fn.launches, dq_fn.launches
        if route in WIDE_PAIRS:
            out[f"{route}_wide_dkv"] = dkv_fn.wide_launches
            out[f"{route}_wide_dq"] = dq_fn.wide_launches
    return out


def reset_k2_counts() -> None:
    """Every K2/K2b count to 0: the five forwards, the padding routes', the
    three backward pairs, the wide instances'."""
    reset_counts()
    flash_attention_headdim.launches = flash_attention_tf32.launches = 0
    flash_attention_rows.launches = flash_attention_tf32_rows.launches = 0
    flash_attention.pad_launches = dict.fromkeys(PAD_MULTIPLE, 0)
    for dq_fn, dkv_fn in BWD_PAIRS.values():
        dq_fn.launches = dkv_fn.launches = 0
    for route in WIDE_PAIRS:
        BWD_PAIRS[route][0].wide_launches = BWD_PAIRS[route][1].wide_launches = 0


def launched(**want: int) -> dict:
    """k2_counts() with ``want``'s entries and 0 elsewhere: what a run after
    reset_k2_counts() should show."""
    return dict({k: 0 for k in k2_counts()}, **want)


def expected_route(t, rows=True) -> str:
    """The forward's route by the routing rule, for q, k and v laid out as
    ``t``: bf16 at D = 64 "wgmma", bf16 at another D that is a multiple of 8
    "wgmma_headdim", f32 at a D that is a multiple of 4 "tf32", each where
    TMA can read the operands (the B, H and S strides multiples of 16
    bytes, D contiguous, from a 16-byte boundary); with ``rows``, of the
    rest, "wgmma_rows" (bf16, D up to 249) and "tf32_rows" (f32, up to 253)
    where the heads lie side by side (the H stride D) in rows TMA can read
    (the B and S strides multiples of 16 bytes, from a 16-byte boundary);
    every other input the dtype's padding route, "wgmma_pad" or
    "tf32_pad"."""
    d = t.shape[-1]
    aligned = t.stride(-1) == 1 and t.data_ptr() % 16 == 0
    tma = aligned and all(st * t.element_size() % 16 == 0 for st in t.stride()[:3])
    if tma and t.dtype == torch.bfloat16 and d % 8 == 0:
        return "wgmma" if d == 64 else "wgmma_headdim"
    if tma and t.dtype == torch.float32 and d % 4 == 0:
        return "tf32"
    # (rows: D + 7 or D + 3 columns, as a head can start that far into a box)
    if rows and aligned and t.stride(1) == d and d + 16 // t.element_size() - 1 <= 256 and all(
            t.stride(i) * t.element_size() % 16 == 0 for i in (0, 2)):
        return "wgmma_rows" if t.dtype == torch.bfloat16 else "tf32_rows"
    return PAD_ROUTES[t.dtype][0]


def expected_backward_route(t) -> str:
    """The backward's route by the routing rule: the forward's without the
    rows routes."""
    return expected_route(t, rows=False)


# by dtype: the padding route and the column multiple its copies round D up
# to (16-byte rows)
PAD_ROUTES = {torch.bfloat16: ("wgmma_pad", 8), torch.float32: ("tf32_pad", 4)}
PAD_MULTIPLE = dict(PAD_ROUTES.values())


def padded_dim(route, d: int) -> int:
    """The head dim of a route's inputs to its kernels: on the padding
    routes D rounded up to 8 (bf16) or 4 (f32), else D."""
    m = PAD_MULTIPLE.get(route, 1)
    return -(-d // m) * m


def route_kernel(route, d) -> str:
    """The kernel (forward) or pair (backward) that ``route`` launches at
    head dim ``d``: on "wgmma_pad" the wgmma kernels at D rounded up to 8,
    on "tf32_pad" the 3xTF32 kernels, else its own."""
    if route == "tf32_pad":
        return "tf32"
    if route != "wgmma_pad":
        return route
    return "wgmma" if padded_dim(route, d) == 64 else "wgmma_headdim"


def k2g_inputs(gen, b, h, s, d, dtype, rows, contiguous=False):
    """k2b_inputs at head dim ``d`` and ``dtype``: q/k/v and dO as strided
    [B, H, S, d] views of [B, S, H*d] buffers (or, ``contiguous``,
    contiguous [B, H, S, d] tensors), and int32 segment ids (each entry of
    ``rows`` a valid length or a list of S ids)."""
    if contiguous:
        q, k, v, dout = (torch.randn(b, h, s, d, device=DEVICE, generator=gen).to(dtype)
                         for _ in range(4))
    else:
        q, k, v, dout = (torch.randn(b, s, h * d, device=DEVICE, generator=gen).to(dtype)
                         .view(b, s, h, d).transpose(1, 2) for _ in range(4))
    return q, k, v, segment_rows(b, s, rows), dout


def segment_rows(b, s, rows):
    """int32 [b, s] segment ids: each entry of ``rows`` a valid length (1
    before it, 0 after) or a list of s ids."""
    seg = torch.zeros(b, s, dtype=torch.int32, device=DEVICE)
    for i, r in enumerate(rows):
        if isinstance(r, int):
            seg[i, :r] = 1
        else:
            seg[i] = torch.as_tensor(r, dtype=torch.int32, device=DEVICE)
    return seg


def check_k2g(q, k, v, seg, dout, label, grads=True) -> dict:
    """K2's forwards other than the wgmma one at D = 64 (the wgmma kernel
    at another head dim or on row maps, the 3xTF32 kernel, also on row
    maps, either over zero-padded copies) and K2b's pairs off bf16 D = 64
    (the wgmma pair at another head dim, the 3xTF32 pair, either over
    zero-padded copies) against their plain versions: the
    forward with and without the logsumexp (the same output bits), the
    logsumexp, and with ``grads`` the backward (dq writing di, then dkv),
    di, and dq's bits on a second run, under the f32 gates (K2G_*) or the
    bf16 ones (K2, K2b).  Checks that both forwards launched on the route
    the routing rule gives (``expected_route``, ``route_kernel``) and the
    backward on its route's pair (``expected_backward_route``), nothing
    else.  Returns both routes, the backward's pair, the largest absolute
    errors (fwd, lse, dq, dkv) and the largest gradient error relative to
    the largest gradient."""
    b, h, s, d = q.shape
    scale = 1.0 / math.sqrt(d)
    f32 = q.dtype == torch.float32
    route, bwd_route = expected_route(q), expected_backward_route(q)
    fwd_kernel, pair = route_kernel(route, d), route_kernel(bwd_route, d)
    dw, d8 = padded_dim(route, d), padded_dim(bwd_route, d)
    before = k2_counts()
    got = flash_attention(q, k, v, seg, scale)
    out, lse = flash_attention_fwd(q, k, v, seg, scale)
    torch.cuda.synchronize()
    want = flash_attention_plain(q, k, v, seg, scale)
    err = (got.float() - want.float()).abs().max().item()
    ok = err <= K2G_ATOL if f32 else torch.allclose(got.float(), want.float(), rtol=K2_RTOL,
                                                    atol=K2_ATOL)
    check(ok, f"K2 ({route}) {label}: max abs err {err}")
    check(torch.equal(got, out), f"K2 ({route}) {label}: the logsumexp changed output bits")
    # a view of a [B, S, H, D'] buffer (D' = D off the padding routes)
    check(got.dtype == q.dtype and got.transpose(1, 2).stride() == (s * h * dw, h * dw, dw, 1),
          f"K2 {label} layout")
    lse_err = (lse - masked_logsumexp(q, k, seg, scale)).abs().max().item()
    check(lse_err <= (K2G_LSE_ATOL if f32 else K2B_LSE_ATOL),
          f"K2 ({route}) logsumexp {label}: max abs err {lse_err}")
    wide = pair in WIDE_PAIRS and d8 > WIDE_PAIRS[pair]
    r = {"route": route, "fwd_kernel": fwd_kernel, "bwd_route": bwd_route, "bwd_pair": pair,
         "bwd_wide": grads and wide, "fwd": err, "lse": lse_err,
         "dq": 0.0, "dkv": 0.0, "rel": 0.0}
    if grads:
        g = flash_attention_bwd(q, k, v, seg, out, lse, dout, scale)
        torch.cuda.synchronize()
        w = flash_attention_bwd_plain(q, k, v, seg, out, lse, dout, scale)
        for name, a, want in zip(("dq", "dk", "dv"), g, w):
            # views of [B, S, H, D8] buffers (D8 = D off the padding routes)
            check(a.dtype == q.dtype and a.shape == q.shape
                  and a.transpose(1, 2).stride() == (s * h * d8, h * d8, d8, 1),
                  f"{name} {label}")
            a, want = a.float(), want.float()
            top = want.abs().max().item()
            e = (a - want).abs().max().item()
            ok = e <= K2G_GRAD_REL * top if f32 else torch.allclose(
                a, want, rtol=K2B_RTOL, atol=K2B_ATOL_REL * top)
            check(ok and bool(torch.isfinite(a).all()),
                  f"K2b ({bwd_route}) {name} {label}: max abs err {e} (max |want| {top})")
            kernel = "dq" if name == "dq" else "dkv"
            r[kernel], r["rel"] = max(r[kernel], e), max(r["rel"], e / top)
        ins = (q, k, v, out, dout)
        if bwd_route in PAD_MULTIPLE:
            ins = tuple(pad_heads(t, d8) for t in ins)
        pq, pk, pv, po, pdo = ins
        dq, di = BWD_PAIRS[pair][0](pq, pk, pv, seg, lse, po, pdo, scale)
        want_di = _row_dots(out, dout)
        di_err = (di - want_di).abs().max().item()
        check(torch.allclose(di, want_di, rtol=K2B_DI_RTOL,
                             atol=K2B_DI_ATOL_REL * want_di.abs().max().item()),
              f"K2b ({bwd_route}) dq's di {label}: max abs err {di_err}")
        check(torch.equal(dq[..., :d], g[0]), f"K2b ({bwd_route}) dq {label}: two runs differ")
        check(not dq[..., d:].any(), f"K2b ({bwd_route}) dq {label}: padded columns not 0")
    # dq twice with grads: the backward, then di's check
    want_counts = dict(before)
    want_counts[fwd_kernel] += 2
    if route in PAD_MULTIPLE:
        want_counts[f"{route}_fwd"] += 2
    want_counts[f"{pair}_dkv"] += grads
    want_counts[f"{pair}_dq"] += 2 * grads
    if wide:
        want_counts[f"{pair}_wide_dkv"] += grads
        want_counts[f"{pair}_wide_dq"] += 2 * grads
    check(k2_counts() == want_counts,
          f"{label}: launched {k2_counts()} from {before} (routes {route}, {bwd_route})")
    return r


# small cases of every bucket of head dims, with the segment layouts of
# phases k2 and k2b: several segments, ids that return after another
# segment, interleaved ids against a tile of one id, a row of one id, ragged
# pads, S = 128 and 384, B = 1, H = 1; D = 48 and 136 fall inside a bucket
K2G_CASES = [
    (1, 1, 128, [[1] * 40 + [0] * 30 + [2] * 58]),
    (3, 2, 256, [[0, 2] * 32 + [1] * 64 + [2] * 128, [7] * 256,
                 [0] * 64 + [3] * 64 + [0] * 64 + [3] * 64]),
    (2, 3, 384, [2, 200]),
]
# by route: f32 at every D a multiple of 4 takes the 3xTF32 kernel (20: a
# slab whose last k step reads zeros past D; 48 and 136 inside a slab),
# bf16 at every D a multiple of 8 but 64 the wgmma kernel (40, 72 and 136
# stop inside a 64-column slab); the backward takes the 3xTF32 pair, past
# f32 D = 64 in its wide shape (68, 80, 96, 128: 32-row steps, dV and dK in
# one block; 136, 192, 256: 16-row steps, dV and dK blocks apart), and the
# wgmma pair, past bf16 D = 128 in its wide shape (136,
# 192, 256: three and four slabs); K2G_ROWS_DIMS, whose heads TMA cannot
# read one by one, at K2G_ROWS_HEADS heads a row (rows of 16-byte
# multiples) take the rows routes, the last head's box reaching the map's
# zero fill (f32 2, 26 and 62: up to three slabs; bf16 2, 20, 25: an odd D,
# 26, 126: up to three slabs), and K2G_WIDE_ROWS_DIMS, past the rows
# routes' D, the forward over zero-padded copies (f32 254 and bf16 250,
# padded to 256); f32 66 and bf16 130 take the wide pairs over copies
# padded to 68 and 136; K2G_CONTIGUOUS_DIMS, laid out contiguous (rows of
# D * 2 or D * 4 bytes, which no map reads), take the forward over
# zero-padded copies; all of them the backward over zero-padded copies: in
# f32 on the 3xTF32 pair (D = 26 padded to 28), in bf16 on the wgmma pair
# (126: padded to two slabs)
K2G_DIMS = {torch.float32: (16, 20, 32, 48, 64, 68, 80, 96, 128, 136, 192, 256),
            torch.bfloat16: (16, 32, 40, 48, 72, 128, 136, 192, 256)}
K2G_ROWS_DIMS = {torch.float32: (2, 26, 62, 66), torch.bfloat16: (2, 20, 25, 26, 126, 130)}
K2G_WIDE_ROWS_DIMS = {torch.float32: (254,), torch.bfloat16: (250,)}
K2G_ROWS_HEADS = 8
K2G_CONTIGUOUS_DIMS = {torch.float32: (26,), torch.bfloat16: (2, 20, 25, 26, 126)}


def misaligned_k2g_inputs(gen, dtype, rows, layout):
    """[3, 2, 256, 64] q/k/v and dO in layouts TMA cannot read, so the
    forward and the backward take them over padded copies (the 3xTF32
    kernels in f32, the wgmma ones in bf16): views that start one element
    (2 or 4 bytes) into their buffers (``layout`` "offset"), or views of
    [B, S, H*D + 2] buffers (rows 260 or 520 bytes apart: "padded_rows")."""
    b, h, s, d = 3, 2, 256, 64
    if layout == "offset":
        flat = [torch.randn(b * s * h * d + 1, device=DEVICE, generator=gen).to(dtype)
                for _ in range(4)]
        views = [t[1:].view(b, s, h, d).transpose(1, 2) for t in flat]
    else:
        buf = [torch.randn(b, s, h * d + 2, device=DEVICE, generator=gen).to(dtype)
               for _ in range(4)]
        views = [t[..., :h * d].view(b, s, h, d).transpose(1, 2) for t in buf]
    return (*views[:3], segment_rows(b, s, rows), views[3])


def grads_rel(got, want, label, f32) -> float:
    """Check each of dq, dk, dv against ``want``'s (the f32 gate: 2e-5 of
    the largest; bf16: K2b's) and return the largest error over the largest
    gradient."""
    rel = 0.0
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        a, b = a.float(), b.float()
        top, e = b.abs().max().item(), (a - b).abs().max().item()
        check(e <= K2G_GRAD_REL * top if f32 else torch.allclose(
            a, b, rtol=K2B_RTOL, atol=K2B_ATOL_REL * top), f"{label} {name}: max abs err {e}")
        rel = max(rel, e / top)
    return rel


def rows_against_padded(q, k, v, seg, scale, lse_shape) -> dict:
    """A rows route's forward against the same kernel on copies of q, k and
    v zero-padded to D rounded up to 8 (bf16) or 4 (f32) by ``pad_heads``,
    at the real scale: the output's first D columns and (``lse_shape``) the
    logsumexp bit-equal at every head (checked), and CUDA-event times of the
    kernel on the copies (``pad_ms``) and of the copies and the kernel
    (``pad_copy_ms``)."""
    d, multiple = q.shape[-1], 16 // q.element_size()  # rows of 16-byte multiples
    width = -(-d // multiple) * multiple
    if lse_shape:
        fwd = lambda *qkv: flash_attention_fwd(*qkv, seg, scale)
    else:
        fwd = lambda *qkv: (flash_attention(*qkv, seg, scale), None)
    pq, pk, pv = (pad_heads(t, width) for t in (q, k, v))
    check(expected_route(pq) in ("wgmma", "wgmma_headdim", "tf32"),
          f"padded copies at D = {width}: route {expected_route(pq)}")
    (got, got_lse), (want, want_lse) = fwd(q, k, v), fwd(pq, pk, pv)
    torch.cuda.synchronize()
    check(torch.equal(got, want[..., :d]) and (not lse_shape or torch.equal(got_lse, want_lse)),
          f"K2 ({expected_route(q)}) at {list(q.shape)} {q.dtype}: not bit-equal to "
          f"{expected_route(pq)} on copies padded to D = {width} (output max abs diff "
          f"{(got.float() - want[..., :d].float()).abs().max().item()})")
    return dict(pad_route=expected_route(pq), pad_width=width, pad_bit_equal=True,
                pad_ms=time_cuda(lambda: fwd(pq, pk, pv), reps=11, inner=3),
                pad_copy_ms=time_cuda(lambda: fwd(*(pad_heads(t, width) for t in (q, k, v))),
                                      reps=11, inner=3))


def k2g_times(q, k, v, seg, dout=None, lse_shape=False) -> dict:
    """CUDA-event times of the forward on its route (with the logsumexp when
    ``lse_shape``), on the rows routes the same kernel on zero-padded copies
    (``rows_against_padded``: bit-equal), on the padding routes the kernel
    on the copies alone (``pad_kernel_ms``), the plain version and SDPA with
    the boolean segment mask (the library yardstick); with ``dout`` also dq,
    dkv and dq then dkv (``pair_ms``) on the backward's route (the pair on the padded copies on the
    padding routes, "wgmma_pad" and "tf32_pad", and then the whole backward,
    ``route_bwd_ms``: the copies, the pair; the gradients views), the plain
    backward and SDPA's backward; each beside its bound."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    slow = dict(reps=5, inner=2)
    if lse_shape:
        fwd = lambda *qkv: flash_attention_fwd(*qkv, seg, scale)
    else:
        fwd = lambda *qkv: flash_attention(*qkv, seg, scale)
    bound = k2_bound(q, seg, lse=lse_shape)
    r = dict(route=expected_route(q), ms=time_cuda(lambda: fwd(q, k, v), reps=11, inner=3),
             plain_ms=time_cuda(lambda: flash_attention_plain(q, k, v, seg, scale), **slow),
             library_ms=time_cuda(lambda: library_attention(q, k, v, seg, scale), **slow),
             bound_ms=bound[0], bound_by=bound[1])
    if r["route"] in ("wgmma_rows", "tf32_rows"):
        r.update(rows_against_padded(q, k, v, seg, scale, lse_shape))
    if r["route"] in PAD_MULTIPLE:
        copies = [pad_heads(t, padded_dim(r["route"], q.shape[-1])) for t in (q, k, v)]
        r["pad_kernel_ms"] = time_cuda(lambda: fwd(*copies), reps=11, inner=3)
        del copies
    if dout is not None:
        out, lse = flash_attention_fwd(q, k, v, seg, scale)
        bwd_route = expected_backward_route(q)
        dq_fn, dkv_fn = BWD_PAIRS[route_kernel(bwd_route, q.shape[-1])]
        ins = (q, k, v, out, dout)
        if bwd_route in PAD_MULTIPLE:
            ins = tuple(pad_heads(t, padded_dim(bwd_route, q.shape[-1])) for t in ins)
        pq, pk, pv, po, pdo = ins
        _, di = dq_fn(pq, pk, pv, seg, lse, po, pdo, scale)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        lib_out = library_attention(*leaves, seg, scale)
        r.update(
            bwd_route=bwd_route,
            dq_ms=time_cuda(lambda: dq_fn(pq, pk, pv, seg, lse, po, pdo, scale), reps=11,
                            inner=3),
            dkv_ms=time_cuda(lambda: dkv_fn(pq, pk, pv, seg, lse, di, pdo, scale), reps=11,
                             inner=3),
            pair_ms=time_cuda(lambda: (dq_fn(pq, pk, pv, seg, lse, po, pdo, scale),
                                       dkv_fn(pq, pk, pv, seg, lse, di, pdo, scale)),
                              reps=11, inner=3))
        if bwd_route in PAD_MULTIPLE:
            r["route_bwd_ms"] = time_cuda(
                lambda: flash_attention_bwd(q, k, v, seg, out, lse, dout, scale), reps=11, inner=3)
        del pq, pk, pv, po, pdo, ins
        r.update(
            plain_bwd_ms=time_cuda(lambda: flash_attention_bwd_plain(
                q, k, v, seg, out, lse, dout, scale), **slow),
            library_bwd_ms=time_cuda(lambda: torch.autograd.grad(
                lib_out, leaves, dout, retain_graph=True), **slow))
        for name, (ms, by) in k2b_bound(q, seg).items():
            r[f"{name}_bound_ms"], r[f"{name}_bound_by"] = ms, by
        del lib_out, leaves
    return r


def run_k2g(seed: int, build=(256, 12, 512), train=(96, 12, 512)) -> dict:
    """K2's forwards other than the wgmma one at D = 64 (the wgmma kernel at
    other head dims and on row maps, the 3xTF32 kernel, also on row maps,
    either over zero-padded copies) and K2b's pairs other than the wgmma
    one at D = 64 (the wgmma pair at other head dims, the 3xTF32 pair,
    either over zero-padded copies) against the plain versions on the card,
    each input on the routes the routing rule gives: the small cases at
    every head dim of K2G_DIMS in f32 and bf16, of K2G_ROWS_DIMS (the rows
    routes) and layouts no map reads (the padding routes), then the shapes
    of the main paths: f32 at
    the build's [256, 12, 512, 64] (forward) and the train step's [96, 12,
    512, 64] (with the logsumexp, and the backward), all-MiniLM-L6-v2's D =
    32 at [256, 12, 512, 32] in bf16 and f32 and its backward at [96, 12,
    512, 32] in bf16, TinyBERT_General_4L_312D's D = 26 at [256, 12, 512,
    26] and [96, 12, 512, 26] in bf16 (the forward on "wgmma_rows", beside
    the same kernel on zero-padded copies; the backward on the wgmma pair
    over zero-padded copies) and in f32 (the forward on "tf32_rows", beside
    the same; the backward on the 3xTF32 pair over copies padded to D =
    28), and EncoderConfig.tiny's [256, 4, 128, 16] in both; then the head
    dims no model of the repo has: the padding forwards at a contiguous
    [256, 12, 512, 26] in both dtypes, the forwards at [256, 12, 512, 128]
    and [256, 12, 512, 256] in both dtypes, the wide pairs at bf16 [96, 12,
    512, 256] and f32 [96, 12, 512, D] for D = 96, 128, 192 and 256;
    CUDA-event times of each route's forward and backward (dq, dkv, and dq
    then dkv), the plain versions and SDPA, beside the bound."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 11)
    keys = ("fwd", "lse", "dq", "dkv", "rel")
    by_route, f32_err = {}, dict.fromkeys(keys, 0.0)

    def hold(r, dtype):
        # the forward's errors under its kernel's route (and a padding
        # route's own), the backward's under its pair's (and its wide
        # instances', "<pair>_wide")
        held = [(r["fwd_kernel"], ("fwd", "lse")), (r["bwd_pair"], ("dq", "dkv", "rel"))]
        if r["route"] in PAD_MULTIPLE:
            held.append((r["route"], ("fwd", "lse")))
        if r["bwd_wide"]:
            held.append((f"{r['bwd_pair']}_wide", ("dq", "dkv", "rel")))
        for route, route_keys in held:
            route_err = by_route.setdefault(route, dict.fromkeys(keys, 0.0))
            for key in route_keys:
                route_err[key] = max(route_err[key], r[key])
        if dtype == torch.float32:
            for key in keys:
                f32_err[key] = max(f32_err[key], r[key])

    for dtype in K2G_DIMS:
        for d in K2G_DIMS[dtype]:
            for b, h, s, rows in K2G_CASES:
                label = f"{dtype} D={d} B={b} H={h} S={s}"
                hold(check_k2g(*k2g_inputs(gen, b, h, s, d, dtype, rows), label), dtype)
        for d in K2G_ROWS_DIMS[dtype] + K2G_WIDE_ROWS_DIMS[dtype]:
            for b, _, s, rows in K2G_CASES:
                h = K2G_ROWS_HEADS
                label = f"{dtype} D={d} B={b} H={h} S={s}"
                hold(check_k2g(*k2g_inputs(gen, b, h, s, d, dtype, rows), label), dtype)
        for d in K2G_CONTIGUOUS_DIMS[dtype]:
            for b, h, s, rows in K2G_CASES:
                label = f"{dtype} D={d} B={b} H={h} S={s} contiguous"
                hold(check_k2g(*k2g_inputs(gen, b, h, s, d, dtype, rows, contiguous=True),
                               label), dtype)
        rows = K2G_CASES[1][3]
        for layout in ("offset", "padded_rows"):
            hold(check_k2g(*misaligned_k2g_inputs(gen, dtype, rows, layout),
                           f"{dtype} D=64 {layout}, which TMA cannot read"), dtype)
    routes = "; ".join(f"{name}: forward {e['fwd']:.3g}, logsumexp {e['lse']:.3g}, dq "
                       f"{e['dq']:.3g}, dkv {e['dkv']:.3g} (of the largest gradient "
                       f"{e['rel']:.3g})" for name, e in sorted(by_route.items()))
    phase("k2g", f"small cases (S=128/256/384, B=1, H=1, several segments, interleaved ids, "
                 f"one-segment rows, ragged pads) at D={K2G_DIMS[torch.float32]} in f32 and "
                 f"D={K2G_DIMS[torch.bfloat16]} in bf16 (the backward's wide shapes past f32 D "
                 f"= 64 and bf16 D = 128), D={K2G_ROWS_DIMS[torch.float32]} in f32 and "
                 f"D={K2G_ROWS_DIMS[torch.bfloat16]} in bf16 at {K2G_ROWS_HEADS} heads on the "
                 f"row maps, D={K2G_WIDE_ROWS_DIMS[torch.float32]} in f32 and "
                 f"D={K2G_WIDE_ROWS_DIMS[torch.bfloat16]} in bf16 at {K2G_ROWS_HEADS} heads, "
                 f"D={K2G_CONTIGUOUS_DIMS[torch.float32]} in f32 and "
                 f"D={K2G_CONTIGUOUS_DIMS[torch.bfloat16]} in bf16 contiguous and D=64 in "
                 f"layouts TMA cannot read over zero-padded copies (the backward over such "
                 f"copies too: of bf16 on the wgmma pair, of f32 on the 3xTF32 pair), agree, "
                 f"each on the "
                 f"routing rule's routes: max abs err by "
                 f"kernel pair {routes}; f32 "
                 f"forward {f32_err['fwd']:.3g} (atol {K2G_ATOL}), logsumexp "
                 f"{f32_err['lse']:.3g} (atol {K2G_LSE_ATOL}), gradients {f32_err['rel']:.3g} "
                 f"of the largest (gate {K2G_GRAD_REL}); bf16 within the K2/K2b gates")

    def lengths(n, s, salt):
        out = np.random.default_rng(seed + salt).integers(2, s + 1, size=n)
        out[0], out[1] = s, 2  # a full row and a row of 2 valid tokens
        return out.tolist()

    r, lines = {}, []

    def timed(key, *inputs, **kw):
        r[key] = k2g_times(*inputs, **kw)
        lines.append(f"{key} {list(inputs[0].shape)}{' (with the logsumexp)' if kw else ''}: "
                     f"{r[key]}")

    b, h, s = build
    for dtype, d, key in ((torch.float32, 64, "f32"), (torch.bfloat16, 32, "bf16_d32"),
                          (torch.float32, 32, "f32_d32"), (torch.bfloat16, 26, "bf16_d26"),
                          (torch.float32, 26, "f32_d26")):
        q, k, v, seg, _ = k2g_inputs(gen, b, h, s, d, dtype, lengths(b, s, 0))
        hold(check_k2g(q, k, v, seg, None, f"at {list(q.shape)} {dtype}", grads=False), dtype)
        if key != "f32_d32":
            timed(key, q, k, v, seg)
        del q, k, v, seg
    b, h, s = train
    for dtype, d, key in ((torch.float32, 64, "f32_train"), (torch.bfloat16, 32, "bf16_d32_train"),
                          (torch.bfloat16, 26, "bf16_d26_train"),
                          (torch.float32, 26, "f32_d26_train")):
        q, k, v, seg, dout = k2g_inputs(gen, b, h, s, d, dtype, lengths(b, s, 5))
        hold(check_k2g(q, k, v, seg, dout, f"at {list(q.shape)} {dtype}"), dtype)
        timed(key, q, k, v, seg, dout, lse_shape=True)
        del q, k, v, seg, dout
    for dtype, key in ((torch.bfloat16, "bf16_d16"), (torch.float32, "f32_d16")):
        q, k, v, seg, dout = k2g_inputs(gen, 256, 4, 128, 16, dtype, lengths(256, 128, 9))
        hold(check_k2g(q, k, v, seg, dout, f"at {list(q.shape)} {dtype}"), dtype)
        timed(key, q, k, v, seg)
        del q, k, v, seg, dout
    # the head dims no model of the repo has: the forward's padding routes
    # at a contiguous [256, 12, 512, 26] (an index build's), the forwards at
    # D = 128 and 256 in both dtypes (an index build's), the wide pairs at
    # bf16 D = 256 and f32 D = 96, 128, 192 and 256 (a train step's)
    b, h, s = build
    for dtype, key in ((torch.bfloat16, "bf16_d26_contiguous"),
                       (torch.float32, "f32_d26_contiguous")):
        q, k, v, seg, _ = k2g_inputs(gen, b, h, s, 26, dtype, lengths(b, s, 0), contiguous=True)
        hold(check_k2g(q, k, v, seg, None, f"at {list(q.shape)} {dtype} contiguous",
                       grads=False), dtype)
        timed(key, q, k, v, seg)
        del q, k, v, seg
    for dtype, d in ((torch.float32, 128), (torch.float32, 256), (torch.bfloat16, 128),
                     (torch.bfloat16, 256)):
        q, k, v, seg, _ = k2g_inputs(gen, b, h, s, d, dtype, lengths(b, s, 0))
        hold(check_k2g(q, k, v, seg, None, f"at {list(q.shape)} {dtype}", grads=False), dtype)
        timed(f"{'f32' if dtype == torch.float32 else 'bf16'}_d{d}", q, k, v, seg)
        del q, k, v, seg
    b, h, s = train
    for dtype, d in ((torch.bfloat16, 256), (torch.float32, 96), (torch.float32, 128),
                     (torch.float32, 192), (torch.float32, 256)):
        q, k, v, seg, dout = k2g_inputs(gen, b, h, s, d, dtype, lengths(b, s, 5))
        hold(check_k2g(q, k, v, seg, dout, f"at {list(q.shape)} {dtype}"), dtype)
        timed(f"{'f32' if dtype == torch.float32 else 'bf16'}_d{d}_train", q, k, v, seg, dout,
              lse_shape=True)
        del q, k, v, seg, dout
    phase("k2g", f"main-path shapes agree (f32 max abs err forward {f32_err['fwd']:.3g}, "
                 f"logsumexp {f32_err['lse']:.3g}, gradients {f32_err['rel']:.3g} of the "
                 f"largest); times in ms ({CARD}): " + "; ".join(lines))
    r.update(by_route=by_route,
             dq_max_abs_err=max(e["dq"] for e in by_route.values()),
             dkv_max_abs_err=max(e["dkv"] for e in by_route.values()),
             f32_max_abs_err=f32_err["fwd"], f32_lse_max_abs_err=f32_err["lse"],
             f32_grad_rel_err=f32_err["rel"])
    return r


# ----------------------------------------------------------------------
# phase 6: a mag-shaped corpus, end to end


def synth_mag(n_docs: int, n_queries: int, rng: np.random.Generator):
    """Documents shaped like STaRK-MAG papers (the five dense fields of
    ``all_dense``), with text long enough to fill each field's token budget,
    and queries drawn from each target paper's title and abstract."""
    words = np.array([f"w{i}" for i in range(30000)])
    p = 1.0 / np.arange(1, len(words) + 1)  # Zipf-like word frequencies
    # one bulk draw (a weighted draw per field would redo the 30000-way
    # cumulative sum thousands of times)
    draws = iter(words[rng.choice(len(words), size=1800 * n_docs, p=p / p.sum())].tolist())

    def text(n):
        return " ".join(next(draws) for _ in range(n))

    docs, queries = [], []
    for i in range(n_docs):
        payload = {
            "type": "paper",
            "title": text(24),
            "abstract": text(600),
            "paper___cites___paper": [text(12) for _ in range(45)],
            "paper___has_topic___field_of_study": [text(2) for _ in range(40)],
            "author___affiliated_with___institution": {
                f"author {text(2)}": [text(4)] for _ in range(60)
            },
        }
        docs.append((f"paper{i}", payload))
    for j in range(n_queries):
        payload = docs[rng.integers(n_docs)][1]
        pool = (payload["title"] + " " + payload["abstract"]).split()
        queries.append(" ".join(rng.choice(pool, size=12, replace=False)))
    return Corpus.from_pairs(docs, dataset_name="mag"), queries


def timed_run(engine, queries, mode, batch_size):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = engine.retrieve_many(queries, top_k=100, mode=mode, batch_size=batch_size)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def check_results(results, n_queries, k):
    check(len(results) == n_queries, f"{len(results)} result lists for {n_queries} queries")
    for hits in results:
        check(len(hits) == k, f"{len(hits)} hits, want {k}")
        check(all(np.isfinite(s) for _, s in hits), "non-finite score")
        check(all(a[1] >= b[1] for a, b in zip(hits, hits[1:])), "scores not descending")


def brute_force_exact(engine, queries, mixer, k):
    """Reference for exact mode, written out here and not through the port's
    scoring helpers: field weights softmax(q @ W) from the mixer's [E, F]
    weight, each field's weighted query rounded to the corpus dtype (the
    engine scores in the corpus dtype), a per-field f32 score against the
    whole corpus, the fields summed, and a full top-k."""
    out = []
    fd, e = len(engine.dense_keys), engine.emb_dim
    docs = engine.docs_flat.float().view(engine.n_docs, fd, e)
    w_mix = torch.as_tensor(mixer["weight"], dtype=torch.float32, device=DEVICE)
    for s in range(0, len(queries), 64):
        with torch.inference_mode():
            q = engine.encode_queries(queries[s : s + 64])
            w = torch.softmax(q @ w_mix, dim=-1)  # [B, F]
            qf = (w[:, :, None] * q[:, None, :]).to(engine.docs_flat.dtype).float()
            scores = torch.einsum("bfe,nfe->bn", qf, docs)
            top_s, top_i = torch.topk(scores, k, dim=-1)
        out.extend(engine._to_keyed(top_s.cpu().numpy(), top_i.cpu().numpy()))
    return out


def index_agreement(matrix, want, label) -> str:
    """Check two [N, F, E] corpus matrices against INDEX_MIN_COSINE per row
    and INDEX_MAX_REL_ERR; returns the numbers as text."""
    a = torch.from_numpy(np.asarray(matrix)).reshape(-1, matrix.shape[-1]).double()
    b = torch.from_numpy(np.asarray(want)).reshape(-1, want.shape[-1]).double()
    cos = ((a * b).sum(1) / (a.norm(dim=1) * b.norm(dim=1))).min().item()
    err = (a - b).abs().max().item()
    rel = err / b.abs().max().item()
    check(cos >= INDEX_MIN_COSINE and rel <= INDEX_MAX_REL_ERR,
          f"{label}: min cosine {cos:.6f}, max rel err {rel:.3g}")
    return f"min row cosine {cos:.6f}, max abs err {err:.3g} ({rel:.3g} of max |x|)"


def timed_build(encode, tok, corpus, field_info):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    matrix = build_dense_corpus_matrix(encode, tok, corpus, field_info, batch_size=256)
    torch.cuda.synchronize()
    return matrix, time.perf_counter() - t0


def run_e2e(seed: int, n_docs: int = 2048, n_queries: int = 256, batch_size: int = 64):
    rng = np.random.default_rng(seed)
    clock = [time.perf_counter()]

    def lap() -> float:
        clock.append(time.perf_counter())
        return clock[-1] - clock[-2]

    corpus, queries = synth_mag(n_docs, n_queries, rng)
    data_s = lap()
    field_info = resolve_fields("all_dense", "mag")
    texts = [t for _, p in corpus.pairs() for t in (p["title"], p["abstract"])]
    tok = SimpleVocabTokenizer.build(texts + queries, max_length=512)
    tok_s = lap()
    cfg = EncoderConfig.contriever_base(vocab_size=tok.vocab_size, attention_impl="auto")
    encoder = init_encoder(cfg, seed=seed)
    # the same weights with plain attention: the reference for K2's build
    plain_encoder = Encoder(dataclasses.replace(cfg, attention_impl="xla"))
    plain_encoder.load_state_dict(encoder.state_dict())
    init_s = lap()
    encode = make_encode_fn(encoder, device=DEVICE)
    encode_plain = make_encode_fn(plain_encoder, device=DEVICE)
    torch.cuda.synchronize()
    to_dev_s = lap()
    phase("e2e", f"corpus {n_docs} docs x {len(field_info)} dense fields "
                 f"(token budgets {[f.max_seq_length for f in field_info.values()]}), "
                 f"{n_queries} queries, vocab {tok.vocab_size}; encoder hidden "
                 f"{cfg.hidden_size} x {cfg.num_layers} layers, {cfg.dtype}, attention "
                 f"{cfg.attention_impl}; setup: data {data_s:.1f}s, tokenizer {tok_s:.1f}s, "
                 f"encoders init {init_s:.1f}s, to device {to_dev_s:.1f}s")

    # warm-up of both encoders at the build's shape (cuBLAS, allocator)
    warm = tok.encode_batch(["w1 w2"] * 256, 512, bucket=False)
    for fn in (encode, encode_plain):
        fn(warm["input_ids"], warm["attention_mask"])
    torch.cuda.synchronize()

    # builds in turns: plain, K2, K2, plain; the first K2 build is the main
    # path, with every count set to 0 just before it and read just after
    plain_s, k2_s = [], []
    matrix_plain, secs = timed_build(encode_plain, tok, corpus, field_info)
    plain_s.append(secs)
    flash_attention.launches = gather_per_field_scores.launches = 0
    matrix, secs = timed_build(encode, tok, corpus, field_info)
    k2_launches = flash_attention.launches
    check(gather_per_field_scores.launches == 0, "the index build launched K1")
    k2_s.append(secs)
    k2_s.append(timed_build(encode, tok, corpus, field_info)[1])
    flash_attention.launches = 0
    plain_s.append(timed_build(encode_plain, tok, corpus, field_info)[1])
    check(flash_attention.launches == 0, "the plain-attention build launched K2")

    check(matrix.shape == (n_docs, len(field_info), cfg.hidden_size), f"matrix {matrix.shape}")
    check(bool(np.isfinite(matrix).all()), "non-finite corpus embedding")
    long_fields = [f for f in field_info.values()
                   if f.max_seq_length >= 128 and f.max_seq_length % 128 == 0]
    want_launches = cfg.num_layers * len(long_fields) * math.ceil(n_docs / 256)
    check(k2_launches == want_launches,
          f"K2 launched {k2_launches} times in the build, want {want_launches}")
    agree = index_agreement(matrix, matrix_plain, "K2 build vs plain-attention build")
    n_seq = n_docs * len(field_info)
    phase("e2e", f"index build through K2 {k2_s[0]:.2f}s / {k2_s[1]:.2f}s "
                 f"({n_seq / k2_s[0]:.0f} / {n_seq / k2_s[1]:.0f} field-docs/s), "
                 f"K2 launches {k2_launches} ({len(long_fields)} fields of "
                 f"{[f.max_seq_length for f in long_fields]} tokens x "
                 f"{math.ceil(n_docs / 256)} batches x {cfg.num_layers} layers); "
                 f"plain attention {plain_s[0]:.2f}s / {plain_s[1]:.2f}s "
                 f"({n_seq / plain_s[0]:.0f} / {n_seq / plain_s[1]:.0f} field-docs/s), "
                 f"order plain, K2, K2, plain; matrix {matrix.shape} {matrix.dtype}, "
                 f"against the plain build: {agree}")

    # one build batch of the first 512-token field under torch.profiler
    field = long_fields[0]
    texts = [t for _, t in format_documents(list(corpus.pairs())[:256], field.name, field.dataset)]
    toks = tok.encode_batch(texts, field.max_seq_length, bucket=False)
    profiles = {}
    for label, fn in (("K2", encode), ("plain", encode_plain)):
        prof = device_profile(lambda: fn(toks["input_ids"], toks["attention_mask"]), top=6)
        profiles[label] = prof["device_ms"]
        phase("e2e", f"one build batch [256, {field.max_seq_length}] ({field.name}) through the "
                     f"encoder, {label} attention: wall {prof['wall_ms']:.2f} ms, device busy "
                     f"{prof['device_ms']:.2f} ms; device ms by kernel: {prof['top']}")

    mixer ={"weight": rng.normal(scale=0.05, size=(cfg.hidden_size, len(field_info)))
             .astype(np.float32)}
    kw = dict(field_info=field_info, doc_keys=list(corpus.keys()), encode_fn=encode,
              tokenizer=tok, mixer_params=mixer, dense_matrix=matrix, recall_k=100,
              dense_dtype=torch.bfloat16, device=DEVICE)
    engine = RetrievalEngine(mode="rerank", **kw)
    check(engine.use_gather_kernel, "auto gate left K1 off for a rerank engine on the card")
    engine.retrieve(queries[:batch_size], top_k=100)  # warm-up (cuBLAS, allocator)

    flash_attention.launches = gather_per_field_scores.launches = 0
    rerank, rerank_s = timed_run(engine, queries, "rerank", batch_size)
    launches = gather_per_field_scores.launches
    check(launches > 0, "the rerank path launched K1 no time")
    check(flash_attention.launches == 0, "12-word queries launched K2")
    check(engine.last_serve_path == "singlechip-rerank-k1", f"path {engine.last_serve_path}")
    check_results(rerank, n_queries, min(100, n_docs))
    phase("e2e", f"rerank: {n_queries / rerank_s:.1f} QPS ({rerank_s:.3f}s, batch {batch_size}), "
                 f"K1 launches {launches}, path {engine.last_serve_path}")

    # the same engine with --pallas-cross-row: stage 2 through K1x
    cross = RetrievalEngine(mode="rerank", pallas_cross_row=True, **kw)
    cross.retrieve(queries[:batch_size], top_k=100)  # warm-up
    gather_per_field_scores.launches = gather_per_field_scores.cross_row_launches = 0
    rerank_x, rerank_x_s = timed_run(cross, queries, "rerank", batch_size)
    k1x_launches = gather_per_field_scores.cross_row_launches
    check(k1x_launches > 0, "the cross-row rerank path launched K1x no time")
    check(gather_per_field_scores.launches == 0, "the cross-row rerank path launched K1")
    check(cross.last_serve_path == "singlechip-rerank-k1x", f"path {cross.last_serve_path}")
    msg = rankings_agree(rerank_x, rerank, E2E_RTOL, E2E_ATOL)
    check(msg is None, f"rerank through K1x vs through K1: {msg}")
    same = rerank_x == rerank
    phase("e2e", f"rerank --pallas-cross-row: {n_queries / rerank_x_s:.1f} QPS "
                 f"({rerank_x_s:.3f}s), K1x launches {k1x_launches}, path "
                 f"{cross.last_serve_path}; == rerank through K1 (identical lists: {same})")
    del cross

    exact, exact_s = timed_run(engine, queries, "exact", batch_size)
    check(engine.last_serve_path == "singlechip-dense", f"path {engine.last_serve_path}")
    check_results(exact, n_queries, min(100, n_docs))
    phase("e2e", f"exact: {n_queries / exact_s:.1f} QPS ({exact_s:.3f}s), path "
                 f"{engine.last_serve_path}")

    plain = RetrievalEngine(mode="rerank", use_pallas_gather=False, **kw)
    want = plain.retrieve_many(queries, top_k=100, batch_size=batch_size)
    check(plain.last_serve_path == "singlechip-rerank-plain", f"path {plain.last_serve_path}")
    msg = rankings_agree(rerank, want, E2E_RTOL, E2E_ATOL)
    check(msg is None, f"rerank K1 vs plain gather: {msg}")
    phase("e2e", f"rerank through K1 == rerank through the plain gather "
                 f"(rtol {E2E_RTOL}, atol {E2E_ATOL}; "
                 f"{len(mismatched_queries(rerank, want))} queries reorder within ties)")

    ref = brute_force_exact(engine, queries, mixer, min(100, n_docs))
    msg = rankings_agree(exact, ref, E2E_RTOL, E2E_ATOL)
    check(msg is None, f"exact vs brute-force f32 scan: {msg}")
    phase("e2e", "exact == brute-force f32 scan of the whole corpus")
    del plain
    plain_engine = RetrievalEngine(mode="rerank", **{**kw, "encode_fn": encode_plain})
    return engine, plain_engine, corpus, queries, dict(
        k1_launches=launches, k2_launches=k2_launches, build_k2_s=k2_s, build_plain_s=plain_s,
        k1x_launches=k1x_launches, rerank_k1x_qps=n_queries / rerank_x_s,
        batch_device_ms=profiles, rerank_qps=n_queries / rerank_s,
        exact_qps=n_queries / exact_s,
    )


# ----------------------------------------------------------------------
# phase 7: long queries through K2


def run_long(seed, engine, plain_engine, corpus, n_layers, n=64, words=150,
             batch_size=64) -> dict:
    """Queries of ``words`` corpus words land in the 256-token bucket, where
    the "auto" encoder runs K2; a plain-attention engine on the same matrix
    is the reference."""
    rng = np.random.default_rng(seed + 2)
    pairs = list(corpus.pairs())
    queries = []
    for _ in range(n):
        payload = pairs[rng.integers(len(pairs))][1]
        pool = (payload["title"] + " " + payload["abstract"]).split()
        queries.append(" ".join(rng.choice(pool, size=words, replace=False)))
    width = engine.tokenizer.encode_batch(queries, engine.query_max_length)["input_ids"].shape[1]
    for e in (engine, plain_engine):
        e.retrieve(queries[:batch_size], top_k=100)  # warm-up at this bucket

    # in turns: plain, K2, K2, plain; the first K2 run is counted
    want, secs = timed_run(plain_engine, queries, "rerank", batch_size)
    plain_qps = [n / secs]
    flash_attention.launches = gather_per_field_scores.launches = 0
    got, secs = timed_run(engine, queries, "rerank", batch_size)
    launches = flash_attention.launches
    k2_qps = [n / secs, n / timed_run(engine, queries, "rerank", batch_size)[1]]
    # the engine encodes a batch in calls of query_call_rows(width) rows
    rows = query_call_rows(width)
    calls = sum(math.ceil(min(batch_size, n - i) / rows) for i in range(0, n, batch_size))
    check(launches == n_layers * calls,
          f"long queries launched K2 {launches} times, want {n_layers * calls} ({calls} "
          f"encoder calls of {rows} rows)")
    flash_attention.launches = 0
    plain_qps.append(n / timed_run(plain_engine, queries, "rerank", batch_size)[1])
    check(flash_attention.launches == 0, "the plain-attention engine launched K2")

    check_results(got, n, 100)
    msg = rankings_agree(got, want, LONG_RTOL, LONG_ATOL)
    check(msg is None, f"long queries, K2 engine vs plain-attention engine: {msg}")
    diffs = [abs(a[1] - b[1]) / max(abs(b[1]), 1e-6)
             for g, w in zip(got, want) for a, b in zip(g, w)]
    phase("long", f"{n} queries of {words} words (bucket {width}), order plain, K2, K2, "
                  f"plain: {k2_qps[0]:.1f} / {k2_qps[1]:.1f} QPS through K2 ({launches} "
                  f"launches), {plain_qps[0]:.1f} / {plain_qps[1]:.1f} QPS plain; rankings "
                  f"agree (rtol {LONG_RTOL}, atol {LONG_ATOL}; max rel score diff at a rank "
                  f"{max(diffs):.3g}; {len(mismatched_queries(got, want))} queries reorder "
                  f"within ties)")
    return dict(long_qps=k2_qps, long_plain_qps=plain_qps, long_k2_launches=launches)


# ----------------------------------------------------------------------
# phase 8: the encode_corpus command


def write_data_dir(path, pairs, splits=None):
    """A dataset directory in the reference's layout: ``corpus`` (key, tab,
    JSON payload) and, for each split, ``<split>.queries`` (id, tab, text)
    and ``<split>.qrels``; ``splits`` maps a split to (queries, qrels)."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "corpus"), "w", encoding="utf-8") as f:
        for key, payload in pairs:
            f.write(f"{key}\t{json.dumps(payload)}\n")
    for split, (queries, qrels) in (splits or {}).items():
        with open(os.path.join(path, f"{split}.queries"), "w", encoding="utf-8") as f:
            for qid, text in queries.items():
                f.write(f"{qid}\t{text}\n")
        trec.write_qrels(os.path.join(path, f"{split}.qrels"), qrels)


def write_bert_dir(path, corpus, seed, **overrides):
    """A local BERT directory at Contriever-base width (``overrides`` of its
    config, such as fewer layers): seeded weights and a WordPiece vocab of
    the corpus's most common words.  Returns the config and the number of
    tokenizer entries."""
    counts = collections.Counter(
        w for t in corpus_texts_for_vocab(corpus, resolve_fields("all_dense", "mag"))
        for w in t.lower().split())
    cfg = EncoderConfig.contriever_base(**overrides)
    words = [w for w, _ in counts.most_common(cfg.vocab_size - 5)]  # after 5 specials
    save_bert_dir(path, cfg, init_encoder(cfg, seed=seed).state_dict(), words)
    return cfg, len(words) + 5


def script_output(main, argv) -> tuple:
    """A script's ``main(argv)``: its stdout and its seconds."""
    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue(), time.perf_counter() - t


def ranked_run(path) -> dict:
    """A run file's doc ids for each query, by sim, ties by doc id."""
    rows = {}
    for r in trec.QRes.from_file(path):
        rows.setdefault(r.query_id, []).append((-r.sim, r.doc_id))
    return {q: [doc for _, doc in sorted(v)] for q, v in rows.items()}


def run_scripts(data, bert, runs, n_docs, k=10) -> dict:
    """The analysis scripts as a user runs them on the card's run files
    (``runs``: the --pallas-cross-row run, then the K1 run) and on the
    dataset directory; each output held to a count made here from the same
    files: the queries whose hit@k differs, the queries with gold outside
    the top k but inside the list, and one row a field (the whitespace
    percentiles, and the BERT tokenizer's untruncated counts) plus the
    document count."""
    gold = {}
    for r in trec.QRels.from_file(os.path.join(data, "test.qrels")):
        gold.setdefault(r.query_id, set()).add(r.doc_id)
    ranked = [ranked_run(p) for p in runs]
    hit = [{q: bool(g & set(rk.get(q, [])[:k])) for q, g in gold.items()} for rk in ranked]
    want_differ = sum(hit[0][q] != hit[1][q] for q in gold)
    want_fail = sum(q in ranked[1] and not hit[1][q] and bool(g & set(ranked[1][q][k:]))
                    for q, g in gold.items())
    secs = {}
    out, secs["compare_results"] = script_output(compare_results.main, [
        "--data-path", data, "--partition", "test", "--res1", runs[0], "--res2", runs[1],
        "--k", str(k)])
    differ = out.count(" has different results\n")
    check(differ == want_differ and out.count("\n") == 4 * differ,
          f"compare_results: {differ} queries differ, counted {want_differ}")
    out, secs["find_failures"] = script_output(find_failures.main, [
        "--data-path", data, "--partition", "test", "--qres-path", runs[1], "--k", str(k)])
    fail = out.count("QUERY: ")
    check(fail == want_fail and "not found in predictions" not in out
          and out.count("\n") == 4 * fail,
          f"find_failures: {fail} queries with gold past the top {k}, counted {want_fail}")

    from tokenizers import Tokenizer

    tok = Tokenizer.from_file(os.path.join(bert, "tokenizer.json"))
    tok.no_truncation()
    tok.no_padding()
    pairs = list(trec.read_corpus(os.path.join(data, "corpus")))
    fields = list(resolve_fields("all_dense", "mag").values())  # one field a name
    argv = ["--corpus", data, "--dataset-name", "mag", "--field-names", "all_dense"]
    for label, count in (("bert", lambda ts: [len(e.ids) for e in tok.encode_batch(ts)]),
                         ("whitespace", lambda ts: [len(t.split()) for t in ts])):
        out, secs[f"corpus_stats_{label}"] = script_output(
            corpus_stats.main, argv + ["--tokenizer", bert if label == "bert" else label])
        want = ["field," + ",".join(f"p{p}" for p in corpus_stats.PERCENTILES)]
        for f in fields:
            lengths = count([t for _, t in format_documents(pairs, f.name, f.dataset)])
            want.append(f"{f.name}," + ",".join(str(int(np.ceil(np.percentile(lengths, p))))
                                              for p in corpus_stats.PERCENTILES))
        want.append(f"{n_docs} documents")
        check(out.splitlines() == want, f"corpus_stats --tokenizer {label}: {out!r}")
    return dict(secs=secs, differ=differ, failures=fail, fields=len(fields))


def run_cli(seed, corpus, n_docs=512):
    """The command as a user runs it on a model directory: a dataset
    directory of the first ``n_docs`` documents (the reference's ``corpus``
    file: key, tab, JSON payload) and a local BERT directory at
    Contriever-base width (seeded weights, a WordPiece vocab of the corpus's
    words), encoded into .npz and .npy and read back.  The command builds
    the encoder as ``prepare_model`` configures it (attention "xla"), so it
    launches no K2; its matrix is held against the same directory's weights
    built through K2 ("auto").  Then ``retrieve --mode rerank`` over the .npz
    on 64 test queries (fewer on a smaller dataset), with ``--pallas-cross-row`` (stage 2 through K1x)
    and without (K1): the two runs agree."""
    pairs = list(corpus.pairs())[:n_docs]
    sub = Corpus.from_pairs(pairs, dataset_name="mag")
    field_info = resolve_fields("all_dense", "mag")
    n_queries, k = min(64, n_docs), min(100, n_docs)
    with tempfile.TemporaryDirectory() as d:
        data, bert = os.path.join(d, "data"), os.path.join(d, "bert")
        write_data_dir(data, pairs, {
            "test": mag_splits(pairs, (n_queries,), np.random.default_rng(seed + 5))[0]})
        cfg, n_vocab = write_bert_dir(bert, sub, seed + 4)

        mats, cli_s = [], []
        flash_attention.launches = 0
        for ext in (".npz", ".npy"):
            out = os.path.join(d, f"index{ext}")
            t = time.perf_counter()
            encode_corpus.main(["--dataset-name", "mag", "--data", data, "--out", out,
                                "--model-name", bert, "--batch-size", "256",
                                "--device", "cuda"])
            cli_s.append(time.perf_counter() - t)
            matrix, keys = load_dense_matrix(out)
            check(keys == [k for k, _ in pairs], f"{ext}: keys differ from the corpus")
            check(matrix.shape == (n_docs, len(field_info), cfg.hidden_size)
                  and bool(np.isfinite(matrix).all()), f"{ext}: matrix {matrix.shape}")
            mats.append(np.asarray(matrix))
        check(flash_attention.launches == 0, "encode_corpus (attention 'xla') launched K2")
        check(np.array_equal(mats[0], mats[1]), ".npz and .npy matrices differ")

        config, state, tok = prepare_model(bert)
        check(config.hidden_size == cfg.hidden_size and config.dtype == torch.bfloat16
              and tok.vocab_size == n_vocab, f"prepare_model gave {config}")
        encoder = Encoder(dataclasses.replace(config, attention_impl="auto"))
        encoder.load_state_dict(state)
        flash_attention.launches = 0
        want, k2_s = timed_build(make_encode_fn(encoder, device=DEVICE), tok, sub, field_info)
        launches = flash_attention.launches
        n_long = sum(f.max_seq_length >= 128 and f.max_seq_length % 128 == 0
                     for f in field_info.values())
        want_launches = config.num_layers * n_long * math.ceil(n_docs / 256)
        check(launches == want_launches, f"K2 launched {launches} times, want {want_launches}")
        agree = index_agreement(mats[0], want, "encode_corpus vs the K2 build")

        runs, retrieve_s, k1x_launches = {}, {}, 0
        for flag in ("--pallas-cross-row", None):
            run = os.path.join(d, f"run{'_k1x' if flag else ''}.qres")
            gather_per_field_scores.launches = gather_per_field_scores.cross_row_launches = 0
            t = time.perf_counter()
            retrieve_cmd.main(["--dataset-name", "mag", "--data", data, "--out", run,
                               "--dense-index", os.path.join(d, "index.npz"), "--model-name",
                               bert, "--mode", "rerank", "--device", "cuda"]
                              + ([flag] if flag else []))
            retrieve_s[flag or "k1"] = time.perf_counter() - t
            launched = (gather_per_field_scores.cross_row_launches,
                        gather_per_field_scores.launches)
            if flag:
                k1x_launches = launched[0]
                check(launched[0] > 0 and launched[1] == 0,
                      f"retrieve --pallas-cross-row launched K1x / K1 {launched}")
            else:
                check(launched[0] == 0 and launched[1] > 0,
                      f"retrieve without the flag launched K1x / K1 {launched}")
            by_query = {}
            for r in trec.QRes.from_file(run):
                by_query.setdefault(r.query_id, []).append((r.doc_id, r.sim))
            check(len(by_query) == n_queries and all(len(h) == k for h in by_query.values()),
                  f"retrieve wrote {len(by_query)} queries")
            runs[flag or "k1"] = [by_query[q] for q in sorted(by_query)]
        msg = rankings_agree(runs["--pallas-cross-row"], runs["k1"], E2E_RTOL, E2E_ATOL)
        check(msg is None, f"retrieve --pallas-cross-row vs without: {msg}")
        scripts = run_scripts(data, bert, [os.path.join(d, "run_k1x.qres"),
                                           os.path.join(d, "run.qres")], len(pairs), k=10)
    n_seq = n_docs * len(field_info)
    phase("cli", f"encode_corpus on the card with a local BERT directory (hidden "
                 f"{config.hidden_size} x {config.num_layers} layers, {config.dtype}, WordPiece "
                 f"vocab {tok.vocab_size}): {n_docs} docs x {len(field_info)} fields -> .npz in "
                 f"{cli_s[0]:.2f}s, .npy in {cli_s[1]:.2f}s (model load and tokenization "
                 f"included), the same matrix {mats[0].shape}, keys read back; the same "
                 f"weights built through K2 in {k2_s:.2f}s ({n_seq / k2_s:.0f} field-docs/s, "
                 f"{launches} launches); the command's matrix against it: {agree}")
    phase("cli", f"retrieve --mode rerank over the .npz, {n_queries} queries: --pallas-cross-row "
                 f"{retrieve_s['--pallas-cross-row']:.2f}s (K1x launches {k1x_launches}), "
                 f"without {retrieve_s['k1']:.2f}s (K1); the runs agree (identical: "
                 f"{runs['--pallas-cross-row'] == runs['k1']})")
    secs = scripts["secs"]
    phase("cli", f"scripts on those run files and the dataset: compare_results (run_k1x vs "
                 f"run, k 10) {secs['compare_results']:.3f}s, {scripts['differ']} queries "
                 f"differ; find_failures (run, k 10) {secs['find_failures']:.3f}s, "
                 f"{scripts['failures']} queries with gold past the top 10; corpus_stats "
                 f"(all_dense, {scripts['fields']} field rows + {n_docs} documents) with the "
                 f"BERT directory {secs['corpus_stats_bert']:.3f}s, whitespace "
                 f"{secs['corpus_stats_whitespace']:.3f}s; each equal to the counts made here")
    return dict(cli_s=cli_s, cli_k2_build_s=k2_s, cli_k1x_launches=k1x_launches,
                cli_retrieve_s=retrieve_s, cli_scripts=scripts)


# ----------------------------------------------------------------------
# phase 9: training at Contriever-base width


def mag_splits(pairs, sizes, rng):
    """Queries of 12 words drawn from the title and abstract of distinct
    documents, each document the positive (qrel) of its query: one
    (queries, qrels) pair per split size, in order."""
    order = rng.permutation(len(pairs))
    out, start = [], 0
    for n in sizes:
        queries, qrels = {}, []
        for i in order[start : start + n]:
            key, payload = pairs[int(i)]
            pool = (payload["title"] + " " + payload["abstract"]).split()
            qid = f"q{start + len(queries)}"
            queries[qid] = " ".join(rng.choice(pool, size=12, replace=False))
            qrels.append(trec.QRels(qid, key, 1.0))
        out.append((queries, qrels))
        start += n
    return out


def grad_groups(model) -> dict:
    """The gradients of one backward, flattened by optimizer group."""
    labels = param_labels(model)
    groups = {"encoder": [], "head": []}
    for name, p in model.named_parameters():
        groups[labels[name]].append(p.grad.detach().float().flatten())
    return {k: torch.cat(v) for k, v in groups.items()}


def loss_and_grads(model, batch, seed):
    """Loss and gradients of one batch in training mode (dropout masks from
    a generator seeded with ``seed``), without an optimizer step."""
    model.train().zero_grad(set_to_none=True)
    loss = model.compute_loss(batch["query"], batch["pos"], batch["neg"],
                              generator=torch.Generator().manual_seed(seed))
    loss.backward()
    grads = grad_groups(model)
    norm = torch.linalg.vector_norm(torch.cat(list(grads.values()))).item()
    model.zero_grad(set_to_none=True)
    return loss.item(), norm, grads


def flash_groups(batch) -> int:
    """Encoder calls of one train step that take K2: the distinct padded
    widths of at least 128 tokens (compute_loss groups its calls by width)."""
    widths = {batch["query"]["input_ids"].shape[-1]}
    for side in ("pos", "neg"):
        widths |= {t["input_ids"].shape[-1] for t in batch[side].values()}
    return sum(w >= 128 and w % 128 == 0 for w in widths)


def counts() -> tuple:
    return (flash_attention.launches, flash_attention_bwd_dkv.launches,
            flash_attention_bwd_dq.launches)


def reset_counts() -> None:
    flash_attention.launches = 0
    flash_attention_bwd_dkv.launches = flash_attention_bwd_dq.launches = 0


def optimizer_states_equal(a, b) -> bool:
    """Two optimizer state_dicts (nested dicts, lists, tensors) equal."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(optimizer_states_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(optimizer_states_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, torch.as_tensor(b))
    return a == b


def train_model(cfg, state_dict=None):
    model = MFARModel(cfg, num_fields=5, temperature=0.05)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    return model


def timed_epoch(trainer, state, epoch):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    state, loss, _ = trainer.train_epoch(state, epoch)
    torch.cuda.synchronize()
    return time.perf_counter() - t, loss, torch.cuda.max_memory_allocated() / 1e9


def run_train(seed, corpus, tok, epochs=2, steps=12, batch=16):
    """MFARModel at Contriever-base width (bf16, remat on at 12 layers, the
    JAX "full" policy) over mag ``all_dense`` (F = 5), batch 16 with one
    BM25-mined negative, temperature 0.05, through ``attention_impl="auto"``
    with attention dropout 0 (K2 and K2b on the 512-token fields)."""
    rng = np.random.default_rng(seed + 6)
    pairs = list(corpus.pairs())
    field_info = resolve_fields("all_dense", "mag")
    (train_q, train_r), (val_q, val_r) = mag_splits(pairs, (steps * batch, 2 * batch), rng)
    t = time.perf_counter()
    sampler = IndexNegativeSampler(load_negative_sampler_index(corpus, None, "mag"), 100, 50, 1)
    index_s = time.perf_counter() - t
    train_ds, val_ds = (ContrastiveDataset(q, corpus, r, sampler, field_info, tok)
                        for q, r in ((train_q, train_r), (val_q, val_r)))
    cfg = EncoderConfig.contriever_base(vocab_size=tok.vocab_size, attention_impl="auto",
                                        attention_dropout=0.0, remat=True)
    plain_cfg = dataclasses.replace(cfg, attention_impl="xla")
    opt = make_optimizer(encoder_lr=1e-4, weights_lr=0.1)
    state = init_state(train_model(cfg), opt, seed=seed, device=DEVICE)
    phase("train", f"MFARModel hidden {cfg.hidden_size} x {cfg.num_layers} layers, {cfg.dtype}, "
                   f"attention {cfg.attention_impl}, hidden dropout {cfg.hidden_dropout}, "
                   f"attention dropout {cfg.attention_dropout}, remat {cfg.remat_policy}; "
                   f"{len(train_q)} train / {len(val_q)} val queries over {len(pairs)} docs; "
                   f"BM25 negative-sampler index built in {index_s:.1f}s")

    # (a) one batch: K2 and K2b against the plain path, on the same weights
    one = to_device(strip_meta(next(train_ds.epoch_batches(batch, seed=seed))),
                    torch.device(DEVICE))
    n_flash = flash_groups(one)
    check(n_flash >= 1, "the batch has no field that K2 takes")
    reset_counts()
    loss_k2, norm_k2, g_k2 = loss_and_grads(state.model, one, seed)
    got = counts()
    want = (2 * cfg.num_layers * n_flash, cfg.num_layers * n_flash, cfg.num_layers * n_flash)
    check(got == want, f"one step launched K2/dkv/dq {got}, want {want} (remat recomputes "
                       f"the forward)")
    plain = train_model(plain_cfg, state.model.state_dict()).to(DEVICE)
    reset_counts()
    loss_pl, norm_pl, g_pl = loss_and_grads(plain, one, seed)
    check(counts() == (0, 0, 0), "the plain path launched a kernel")
    del plain
    cos = {k: torch.nn.functional.cosine_similarity(g_k2[k], g_pl[k], dim=0).item()
           for k in g_k2}
    check(abs(loss_k2 - loss_pl) <= TRAIN_LOSS_RTOL * abs(loss_pl),
          f"loss through K2 {loss_k2} vs plain {loss_pl}")
    check(abs(norm_k2 - norm_pl) <= TRAIN_NORM_RTOL * norm_pl,
          f"grad_norm through K2 {norm_k2} vs plain {norm_pl}")
    check(min(cos.values()) >= TRAIN_MIN_COSINE, f"gradient cosines {cos}")
    phase("train", f"(a) one batch through K2/K2b vs plain attention: loss {loss_k2:.6f} vs "
                   f"{loss_pl:.6f}, grad_norm {norm_k2:.6f} vs {norm_pl:.6f}, gradient cosine "
                   f"encoder {cos['encoder']:.6f} head {cos['head']:.6f} (tolerances: loss "
                   f"rtol {TRAIN_LOSS_RTOL}, grad_norm rtol {TRAIN_NORM_RTOL}, cosine >= "
                   f"{TRAIN_MIN_COSINE}); launches K2/dkv/dq {got} ({n_flash} encoder call "
                   f"of 512 tokens x {cfg.num_layers} layers, the forward twice under remat)")
    del g_k2, g_pl

    with tempfile.TemporaryDirectory() as d:
        tcfg = TrainerConfig(out_dir=d, max_epochs=epochs, train_batch_size=batch,
                             seed=seed, query_max_length=512)
        trainer = Trainer(tok, field_info, corpus, train_ds, val_ds, val_q,
                          os.path.join(d, "val.qrels"), tcfg)
        trec.write_qrels(os.path.join(d, "val.qrels"), val_r)

        # (b) Trainer.fit: the main path of this slice, counted
        torch.cuda.synchronize()
        reset_counts()
        t = time.perf_counter()
        state = trainer.fit(state)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t
        fit_launches = counts()
        n_steps = state.step
        check(n_steps == epochs * steps, f"fit ran {n_steps} steps")
        check(fit_launches[1] == fit_launches[2] >= cfg.num_layers * n_steps
              and fit_launches[0] >= 2 * fit_launches[1], f"fit launched {fit_launches}")
        with open(os.path.join(d, "metrics.jsonl")) as f:
            epochs_log = [json.loads(ln) for ln in f if '"train_loss"' in ln]
        losses = [r["train_loss"] for r in epochs_log]
        valid = [r["valid_loss"] for r in epochs_log]
        check(all(math.isfinite(x) for x in losses + valid), f"losses {losses} {valid}")
        check(losses[-1] < losses[0], f"the train loss did not fall: {losses}")

        # (c) checkpoint round trip: restore the last epoch into a fresh state
        restored = init_state(train_model(cfg), opt, seed=seed + 1, device=DEVICE)
        trainer.ckpt.restore(trainer.ckpt.latest_step(), restored)
        for (name, a), (_, b) in zip(state.model.state_dict().items(),
                                     restored.model.state_dict().items()):
            check(torch.equal(a, b), f"restored {name} differs")
        check(optimizer_states_equal(state.optimizer.state_dict(),
                                     restored.optimizer.state_dict()),
              "the restored optimizer state differs")
        check(restored.step == state.step
              and torch.equal(restored.generator.get_state(), state.generator.get_state()),
              "restored step or generator differs")
        _, m_a = train_step(state, one)
        _, m_b = train_step(restored, one)
        step_diff = max((a - b).abs().max().item() for a, b in
                        zip(state.model.parameters(), restored.model.parameters()))
        loss_diff = abs(m_a["loss"].item() - m_b["loss"].item())
        check(loss_diff <= CKPT_ATOL and step_diff <= CKPT_ATOL,
              f"a step after restore differs: loss by {loss_diff}, parameters by {step_diff}")
        del restored

        # steps/s and tokens/s through K2/K2b and through plain attention, in
        # turns (plain, K2, K2, plain) over the same epoch of batches
        t = time.perf_counter()
        real = sum(token_stats(strip_meta(b))["tokens_real"]
                   for b in train_ds.epoch_batches(batch, seed=seed))
        host_batch_ms = (time.perf_counter() - t) / steps * 1e3  # the host's batch assembly
        plain_state = init_state(train_model(plain_cfg), opt, seed=seed, device=DEVICE)
        plain_state.model.load_state_dict(state.model.state_dict())
        rates = {"plain": [], "K2": []}
        resident = {"plain": [], "K2": []}  # steps/s on one device-resident batch
        peak = {}
        for label in ("plain", "K2", "K2", "plain"):
            st = plain_state if label == "plain" else state
            secs, _, peak[label] = timed_epoch(trainer, st, 0)
            rates[label].append((steps / secs, real / secs))
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(5):
                train_step(st, one)
            torch.cuda.synchronize()
            resident[label].append(5 / (time.perf_counter() - t))
        del plain_state
        prof = device_profile(lambda: train_step(state, one), top=8, host_top=8)

        # proxy validation and one trec eval over an index rebuilt by the
        # trained encoder (exact mode)
        reset_counts()
        t = time.perf_counter()
        dev = trainer.trec_eval(state, val_q, os.path.join(d, "val.qrels"), "chip-dev")
        eval_s = time.perf_counter() - t
        eval_launches = counts()
        check(all(0.0 <= dev[k] <= 1.0 for k in ("ndcg_cut_10", "recall_100", "recip_rank")),
              f"trec metrics {dev}")
        check(eval_launches[0] > 0 and eval_launches[1:] == (0, 0),
              f"the eval index build launched {eval_launches}")
    phase("train", f"(b) Trainer.fit: {n_steps} steps in {epochs} epochs, {fit_s:.1f}s with "
                   f"validation and checkpoints; train loss by epoch {losses}, valid loss "
                   f"{valid}; launches K2/dkv/dq {fit_launches}")
    phase("train", f"(b) epochs of {steps} steps, order plain, K2, K2, plain: through K2 "
                   f"{rates['K2'][0][0]:.3f} / {rates['K2'][1][0]:.3f} steps/s "
                   f"({rates['K2'][0][1]:.0f} / {rates['K2'][1][1]:.0f} real tokens/s), plain "
                   f"{rates['plain'][0][0]:.3f} / {rates['plain'][1][0]:.3f} steps/s "
                   f"({rates['plain'][0][1]:.0f} / {rates['plain'][1][1]:.0f} real tokens/s); "
                   f"peak memory K2 {peak['K2']:.2f} GB, plain {peak['plain']:.2f} GB; host "
                   f"batch assembly alone {host_batch_ms:.1f} ms a batch; 5 steps on one "
                   f"device-resident batch after each epoch: K2 {resident['K2'][0]:.3f} / "
                   f"{resident['K2'][1]:.3f} steps/s, plain {resident['plain'][0]:.3f} / "
                   f"{resident['plain'][1]:.3f} steps/s")
    phase("train", f"(b) one profiled step through K2: wall {prof['wall_ms']:.2f} ms, device "
                   f"busy {prof['device_ms']:.2f} ms (share {prof['busy_share']}); device ms by "
                   f"kernel: {prof['top']}; host ms by operator (self CPU time, profiler "
                   f"included): {prof['host_top']}")
    phase("train", f"(b) trec eval of {len(val_q)} queries over a {len(pairs)}-doc index rebuilt "
                   f"by the trained encoder (exact mode) in {eval_s:.1f}s: ndcg@10 "
                   f"{dev['ndcg_cut_10']:.4f}, recall@100 {dev['recall_100']:.4f}, mrr "
                   f"{dev['recip_rank']:.4f}; K2 launches {eval_launches[0]}")
    phase("train", f"(c) checkpoint round trip: restored state equal; one step after the "
                   f"restore vs without: loss differs by {loss_diff:.3g}, parameters by "
                   f"{step_diff:.3g} (tolerance {CKPT_ATOL})")
    return dict(train_launches=fit_launches, train_steps=n_steps, train_losses=losses,
                valid_losses=valid, train_steps_per_s=rates, train_resident_steps_per_s=resident,
                train_host_batch_ms=host_batch_ms, train_peak_gb=peak,
                train_busy_share=prof["busy_share"], train_ndcg10=dev["ndcg_cut_10"])


# ----------------------------------------------------------------------
# phase 10: data-parallel training over several ranks


def param_digest(model) -> str:
    """A hash of every parameter's bytes: equal digests are equal weights."""
    h = hashlib.sha256()
    for p in model.parameters():
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def update_cosines(model, start, other) -> dict:
    """Per optimizer group, the cosine of ``model``'s move from ``start``
    (a {name: tensor} copy) against ``other``'s."""
    labels = param_labels(model)
    moves = {"encoder": ([], []), "head": ([], [])}
    theirs = dict(other.named_parameters())
    for name, p in model.named_parameters():
        a, b = moves[labels[name]]
        a.append((p.detach().float() - start[name]).flatten())
        b.append((theirs[name].detach().float() - start[name]).flatten())
    return {k: F.cosine_similarity(torch.cat(a), torch.cat(b), dim=0).item()
            for k, (a, b) in moves.items()}


def train_rank(spec, mesh, out) -> None:
    """One rank of the train_mesh phase: (1) one batch's loss and gradients
    on this rank's rows, summed over the ranks, against one device's on the
    whole batch (rank 0), with the K2/K2b launches of the rank's step; (2)
    one optimizer step: every rank's weights (a digest), and a validation
    batch's loss after it against one device's after its step; (3) ``Trainer.fit`` over the ranks (each rank's
    K2/K2b launches counted), rank 0's checkpoint and ``restore_broadcast``
    on every rank; (4) with ``spec["rates"]``, steps/s at the global
    batches of ``spec["rate_batches"]`` on one card (rank 0 alone) and over
    the ranks, and the gradient all-reduce's time."""
    from mfar_tpu_torch.parallel import multihost
    from mfar_tpu_torch.parallel.data_parallel import all_reduce_gradients, shard_batch
    from mfar_tpu_torch.train.train_step import compute_gradients

    corpus = Corpus.from_pairs(spec["pairs"], dataset_name="mag")
    field_info = resolve_fields("all_dense", "mag")
    sampler = IndexNegativeSampler(load_negative_sampler_index(corpus, None, "mag"), 100, 50, 1)
    train_ds, val_ds, rate_ds = (ContrastiveDataset(q, corpus, r, sampler, field_info, spec["tok"])
                                 for q, r in spec["splits"])
    cfg = spec["cfg"]
    nodrop = dataclasses.replace(cfg, hidden_dropout=0.0)  # masks are each rank's own
    opt = make_optimizer(encoder_lr=1e-4, weights_lr=0.1)
    dev = torch.device(DEVICE)
    batch = strip_meta(next(train_ds.epoch_batches(spec["batch"], seed=spec["seed"])))
    local, shard = shard_batch(batch, mesh)
    check(shard is not None and shard.rows * mesh.size("data") == spec["batch"],
          f"rank {mesh.rank}: batch of {spec['batch']} not split: {shard}")
    local, whole = to_device(local, dev), to_device(batch, dev)

    # (1) one batch: this rank's share against one device's whole batch
    state = init_state(train_model(nodrop), opt, seed=spec["seed"], device=DEVICE)
    start = {n: p.detach().float().clone() for n, p in state.model.named_parameters()}
    if mesh.rank == 0:
        one = init_state(train_model(nodrop), opt, seed=spec["seed"], device=DEVICE)
        one_loss = compute_gradients(one, whole).item()
        one_grads = grad_groups(one.model)
        one.model.zero_grad(set_to_none=True)
    multihost.sync("train-one-device")  # ranks that share the card wait for rank 0
    reset_counts()
    loss = compute_gradients(state, local, shard).item()
    out["step_launches"] = counts()
    grads = grad_groups(state.model)
    norm = torch.linalg.vector_norm(torch.cat(list(grads.values()))).item()
    state.model.zero_grad(set_to_none=True)
    out.update(loss=loss, norm=norm, n_flash=flash_groups(local))
    if mesh.rank == 0:
        out.update(one_loss=one_loss,
                   one_norm=torch.linalg.vector_norm(torch.cat(list(one_grads.values()))).item(),
                   grad_cos={k: F.cosine_similarity(grads[k], one_grads[k], dim=0).item()
                             for k in grads})
        del one_grads
    del grads

    # (2) one optimizer step on every rank, and on one device; the two
    # models' validation loss after it
    train_step(state, local, shard)
    out["digest"] = param_digest(state.model)
    if mesh.rank == 0:
        train_step(one, whole)
        out["update_cos"] = update_cosines(state.model, start, one.model)
        vb = to_device(strip_meta(next(val_ds.epoch_batches(spec["batch"], seed=0))), dev)
        out["after_loss"] = (eval_loss_step(state, vb).item(), eval_loss_step(one, vb).item())
        del one
    del state, start
    torch.cuda.empty_cache()

    # (3) Trainer.fit over the ranks (dropout on), a checkpoint on rank 0,
    # restore_broadcast on every rank
    multihost.sync("train-fit")
    run_dir = os.path.join(spec["work"], f"run{mesh.rank}")
    tcfg = TrainerConfig(out_dir=run_dir, max_epochs=spec["epochs"],
                         train_batch_size=spec["batch"], seed=spec["seed"],
                         query_max_length=512)
    val_q = spec["splits"][1][0]
    trainer = Trainer(spec["tok"], field_info, corpus, train_ds, val_ds, val_q,
                      os.path.join(spec["work"], "val.qrels"), tcfg, mesh=mesh)
    state = init_state(train_model(cfg), opt, seed=spec["seed"], device=DEVICE)
    torch.cuda.synchronize()
    reset_counts()
    t = time.perf_counter()
    state = trainer.fit(state)
    torch.cuda.synchronize()
    out.update(fit_s=time.perf_counter() - t, fit_launches=counts(), fit_steps=state.step)
    if mesh.rank == 0:
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            rows = [json.loads(ln) for ln in f if '"train_loss"' in ln]
        out.update(losses=[r["train_loss"] for r in rows], valid=[r["valid_loss"] for r in rows])
    out["run_dir"] = sorted(os.listdir(run_dir)) if os.path.isdir(run_dir) else None
    out["fit_digest"] = param_digest(state.model)
    latest = trainer.ckpt_step_broadcast("latest")
    t = time.perf_counter()
    restored = trainer.restore_broadcast(
        latest, init_state(train_model(cfg), opt, seed=spec["seed"] + 1, device=DEVICE))
    out["restore_s"] = time.perf_counter() - t
    out["restored"] = (
        latest, restored.step == state.step,
        all(torch.equal(a, b) for a, b in zip(state.model.state_dict().values(),
                                               restored.model.state_dict().values())),
        optimizer_states_equal(state.optimizer.state_dict(), restored.optimizer.state_dict()),
        torch.equal(restored.generator.get_state(), state.generator.get_state()))
    del state, restored, trainer
    torch.cuda.empty_cache()
    if not spec.get("rates"):
        return

    # (4) steps/s at each global batch: one card (rank 0 alone), then the ranks
    out["rates"] = {}
    state = init_state(train_model(cfg), opt, seed=spec["seed"], device=DEVICE)

    def rate(b, sh, reps=5):
        train_step(state, b, sh)  # warm-up: cuBLAS, the allocator
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            train_step(state, b, sh)
        torch.cuda.synchronize()
        return reps / (time.perf_counter() - t)

    for b in spec["rate_batches"]:
        rb = strip_meta(next(rate_ds.epoch_batches(b, seed=spec["seed"])))
        rlocal, rshard = shard_batch(rb, mesh)
        one_rate = rate(to_device(rb, dev), None) if mesh.rank == 0 else None
        multihost.sync("one-card-rate")  # the other ranks wait for rank 0 alone
        many = rate(to_device(rlocal, dev), rshard)
        # the gradient all-reduce alone, on this step's gradients
        compute_gradients(state, to_device(rlocal, dev), rshard)
        params = list(state.model.parameters())
        torch.cuda.synchronize()
        multihost.sync("reduce")
        t = time.perf_counter()
        for _ in range(5):
            all_reduce_gradients(params, rshard)
        torch.cuda.synchronize()
        reduce_ms = (time.perf_counter() - t) / 5 * 1e3
        state.model.zero_grad(set_to_none=True)
        out["rates"][b] = dict(one=one_rate, ranks=many, reduce_ms=reduce_ms,
                               grad_mb=sum(p.numel() for p in params) * 4 / 1e6)


def run_ranks(job, spec, world, label, timeout=None) -> list:
    """Start ``world`` ranks of chip_smoke's ``mesh_rank`` on ``job``, wait
    until each exits 0 (a rank that fails fails the phase), and return
    what they measured."""
    with tempfile.TemporaryDirectory() as work:
        spec = dict(spec, job=job, work=work)
        if "splits" in spec:
            trec.write_qrels(os.path.join(work, "val.qrels"), spec["splits"][1][1])
        path = os.path.join(work, "spec.pt")
        torch.save(spec, path)
        coord = f"file://{os.path.join(work, 'init')}"
        me = os.path.abspath(__file__)
        extra = {"CUDA_VISIBLE_DEVICES": "0"} if job in ("train_shared", "tp_shared") else {}
        procs = start_ranks([[sys.executable, me, "--mesh-rank", path]] * world,
                            [rank_env(coord, world, r, **extra) for r in range(world)], work,
                            label)
        try:
            watch_ranks(procs, label, timeout=timeout or MESH_RANK_TIMEOUT_S)
        finally:
            stop_ranks(procs)
        return [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]


def hold_train_ranks(ranks, spec, label) -> dict:
    """The checks of ``train_rank``'s outputs, rank 0's against one device
    and every rank's against rank 0's; returns the phase's numbers."""
    r0, L = ranks[0], spec["cfg"].num_layers
    n = len(ranks)
    for r in ranks:
        want = (2 * L * r["n_flash"], L * r["n_flash"], L * r["n_flash"])
        check(r["n_flash"] >= 1 and r["step_launches"] == want,
              f"{label}: rank {r['rank']}'s step launched K2/dkv/dq {r['step_launches']}, want "
              f"{want}")
        check(r["loss"] == r0["loss"] and r["norm"] == r0["norm"],
              f"{label}: rank {r['rank']}'s loss or grad norm differs from rank 0's")
        check(r["digest"] == r0["digest"] and r["fit_digest"] == r0["fit_digest"],
              f"{label}: rank {r['rank']}'s weights differ from rank 0's after a step or fit")
        fl = r["fit_launches"]
        check(r["fit_steps"] == spec["epochs"] * spec["steps"]
              and fl[1] == fl[2] >= L * r["fit_steps"] and fl[0] >= 2 * fl[1],
              f"{label}: rank {r['rank']} fit {r['fit_steps']} steps, launched {fl}")
        check(r["restored"][1:] == (True, True, True, True),
              f"{label}: rank {r['rank']}'s restore_broadcast: {r['restored']}")
        check(r["rank"] == 0 or r["run_dir"] is None, f"{label}: rank {r['rank']} wrote files")
    check(abs(r0["loss"] - r0["one_loss"]) <= TRAIN_LOSS_RTOL * abs(r0["one_loss"]),
          f"{label}: loss over {n} ranks {r0['loss']} vs one device {r0['one_loss']}")
    check(abs(r0["norm"] - r0["one_norm"]) <= TRAIN_NORM_RTOL * r0["one_norm"],
          f"{label}: grad_norm over {n} ranks {r0['norm']} vs one device {r0['one_norm']}")
    check(min(r0["grad_cos"].values()) >= TRAIN_MIN_COSINE,
          f"{label}: gradient cosines {r0['grad_cos']}")
    after, after_one = r0["after_loss"]
    check(abs(after - after_one) <= TRAIN_LOSS_RTOL * abs(after_one),
          f"{label}: validation loss after one step over the ranks {after} vs one device "
          f"{after_one}")
    check({"metrics.jsonl", "checkpoints", "best.txt"} <= set(r0["run_dir"] or ()),
          f"{label}: rank 0 wrote {r0['run_dir']}")
    check(all(math.isfinite(x) for x in r0["losses"] + r0["valid"]),
          f"{label}: losses {r0['losses']} {r0['valid']}")
    launches = tuple(sum(r["fit_launches"][i] for r in ranks) for i in range(3))
    phase("train_mesh", f"{label}: {n} ranks ({r0['backend']}), global batch {spec['batch']} "
                        f"({spec['batch'] // n} rows a rank): one batch's loss {r0['loss']:.6f} "
                        f"vs one device {r0['one_loss']:.6f}, grad_norm {r0['norm']:.6f} vs "
                        f"{r0['one_norm']:.6f}, gradient cosines {r0['grad_cos']} (tolerances: "
                        f"loss rtol {TRAIN_LOSS_RTOL}, grad_norm rtol {TRAIN_NORM_RTOL}, cosine >= "
                        f"{TRAIN_MIN_COSINE}); each rank's step launched K2/dkv/dq "
                        f"{r0['step_launches']}; after one AdamW step every rank's weights "
                        f"bit-equal, a validation batch's loss {after:.6f} vs one device's "
                        f"{after_one:.6f} (rtol {TRAIN_LOSS_RTOL}); update cosines against one "
                        f"device {r0['update_cos']} (not held: Adam's first step moves an entry "
                        f"by ~lr in its gradient's sign, so entries whose gradient is at the "
                        f"bf16 noise level move either way)")
    phase("train_mesh", f"{label}: Trainer.fit {r0['fit_steps']} steps in {spec['epochs']} "
                        f"epochs in {[round(r['fit_s'], 2) for r in ranks]} s a rank (validation "
                        f"and rank 0's checkpoints included); train loss by epoch {r0['losses']}, "
                        f"valid {r0['valid']}; K2/dkv/dq launches by rank "
                        f"{[r['fit_launches'] for r in ranks]}; rank 1 wrote nothing; "
                        f"restore_broadcast of checkpoint {r0['restored'][0]} equal on every "
                        f"rank in {[round(r['restore_s'], 2) for r in ranks]} s")
    return dict(launches=launches, loss=r0["loss"], one_loss=r0["one_loss"],
                grad_cos=r0["grad_cos"], update_cos=r0["update_cos"], after_loss=r0["after_loss"],
                fit_s=[r["fit_s"] for r in ranks], restore_s=[r["restore_s"] for r in ranks])


def run_train_mesh(seed, corpus, tok, batch=16, steps=2, epochs=2,
                   rate_batches=(16, 64)) -> dict:
    """Data-parallel training at Contriever-base width (bf16, remat, K2/K2b
    through ``attention_impl="auto"``, attention dropout 0) over mag
    ``all_dense`` with one BM25 negative: (a) two gloo ranks sharing the
    card, (b) one NCCL rank per card where there are several, with steps/s
    at global batches 16 and 64 against one card."""
    rng = np.random.default_rng(seed + 61)
    pairs = list(corpus.pairs())
    splits = mag_splits(pairs, (steps * batch, 2 * batch, max(rate_batches)), rng)
    cfg = EncoderConfig.contriever_base(vocab_size=tok.vocab_size, attention_impl="auto",
                                        attention_dropout=0.0, remat=True)
    spec = dict(seed=seed, device=DEVICE, pairs=pairs, tok=tok, cfg=cfg, splits=splits,
                batch=batch, steps=steps, epochs=epochs, rate_batches=rate_batches)
    t = time.perf_counter()
    ranks = run_ranks("train_shared", spec, 2, "train_mesh_a")
    check([(r["backend"], r["card"]) for r in ranks] == [("gloo", 0)] * 2,
          f"(a) ranks' backends and cards {[(r['backend'], r['card']) for r in ranks]}")
    out = {"a": hold_train_ranks(ranks, spec, "(a) two gloo ranks on card 0")}
    out["a"]["s"] = time.perf_counter() - t
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        phase("train_mesh", f"(b) needs several cards; {n_cards} visible: skipped")
    else:
        t = time.perf_counter()
        ranks = run_ranks("train_cards", dict(spec, rates=True), n_cards, "train_mesh_b")
        check(sorted(r["card"] for r in ranks) == list(range(n_cards))
              and {r["backend"] for r in ranks} == {"nccl"}, "(b) ranks share a card or "
              "do not run NCCL")
        out["b"] = hold_train_ranks(ranks, spec, f"(b) {n_cards} NCCL ranks, one a card")
        out["b"]["rates"] = ranks[0]["rates"]
        out["b"]["s"] = time.perf_counter() - t
        phase("train_mesh", f"(b) steps/s on one device-resident batch (5 steps after a "
                            f"warm-up), one card vs {n_cards} cards, and the gradient "
                            f"all-reduce alone (NCCL, f32, in buckets of 128 MiB): "
                            + "; ".join(f"global batch {b}: {v['one']:.3f} vs {v['ranks']:.3f} "
                                        f"steps/s, all-reduce of {v['grad_mb']:.0f} MB "
                                        f"{v['reduce_ms']:.2f} ms"
                                        for b, v in out["b"]["rates"].items()) + f" ({CARD})")
    out["launches"] = tuple(sum(v["launches"][i] for k, v in out.items() if k in ("a", "b"))
                            for i in range(3))
    return {"train_mesh": out, "train_mesh_launches": out["launches"]}


# ----------------------------------------------------------------------
# phase 10b: tensor-parallel training (--n-model) over several ranks

TP_VOCAB = 30522  # BERT-base's vocabulary (Contriever's): 2 divides it, 4 does not
# Two ranks that share a card send every model-group all-reduce through the
# host (gloo): ~10 s a gradient pass at 12 layers and batch 4 on the card.
# Their phases run 4 of the 12 layers, at full width; the four-card phase
# runs all 12.
TP_SHARED_LAYERS = 4
# The step's grad_norm (a sharded leaf's squares summed over the model group,
# then the replicated ones) against the norm of the joined gradients: the
# same f32 squares summed in another order.
TP_NORM_RTOL = 1e-5
# The joined weights after the optimizer stepped on the shards against one
# card's optimizer stepped on the joined gradients: AdamW is elementwise;
# Adafactor's factored statistics and block RMS are sums over the model
# group, in f32 in another order, scaling updates of ~lr (1e-3).
TP_UPDATE_ATOL = 1e-6


def tp_whole(model, grads=False) -> dict:
    """{name: whole parameter (or its gradient)}, each sharded one joined
    over its model group: a collective every rank of the group calls."""
    out = {}
    for name, p in model.named_parameters():
        t = (p.grad if grads else p).detach()
        shard = tensor_parallel.shard_of(p)
        if shard is not None:
            t = torch.cat(shard.mesh.all_gather("model", t), dim=shard.axis)
        out[name] = t
    return out


def tp_digests(model) -> tuple:
    """Hashes of the replicated parameters as this rank holds them and of
    every parameter joined over its model group (a collective)."""
    mine, whole = hashlib.sha256(), hashlib.sha256()
    for p in model.parameters():
        if tensor_parallel.shard_of(p) is None:
            mine.update(p.detach().cpu().numpy().tobytes())
    for t in tp_whole(model).values():
        whole.update(t.cpu().numpy().tobytes())
    return mine.hexdigest(), whole.hexdigest()


def replicated_grad_spread(model, batch, shard) -> dict:
    """The replicated leaves' gradients of one backward without the model
    group's average, twice on this rank: the largest difference between the
    two passes and between this rank's first and model rank 0's (each over
    the leaf's largest entry), and the leaf where it is (a collective)."""
    def grads():
        model.train().zero_grad(set_to_none=True)
        model.compute_loss(batch["query"], batch["pos"], batch["neg"], shard=shard).backward()
        out = {n: p.grad.detach().float().clone() for n, p in model.named_parameters()
               if tensor_parallel.shard_of(p) is None}
        model.zero_grad(set_to_none=True)
        return out

    first, second = grads(), grads()
    mesh = model.model_mesh
    peers = {n: mesh.all_gather("model", g)[0] for n, g in first.items()}
    out = {}
    for label, other in (("passes", second), ("peers", peers)):
        rel = {n: ((g - other[n]).abs().max() / g.abs().max().clamp(min=1e-30)).item()
               for n, g in first.items()}
        worst = max(rel, key=rel.get)
        out[label] = (rel[worst], worst, sum(v > 0 for v in rel.values()), len(rel))
    return out


def l2_norm(groups) -> float:
    """The L2 norm of the gradient groups, summed in f64."""
    return torch.linalg.vector_norm(torch.cat(list(groups.values())).double()).item()


def by_group(model, tensors) -> dict:
    """``tensors`` ({name: tensor}) flattened by optimizer group."""
    labels = param_labels(model)
    groups = {"encoder": [], "head": []}
    for name, t in tensors.items():
        groups[labels[name]].append(t.float().flatten())
    return {k: torch.cat(v) for k, v in groups.items()}


def tp_step(spec, mesh, cfg, opt, batch, vb) -> dict:
    """One batch of ``cfg``'s MFARModel over ``mesh`` (the encoder sharded
    over ``model``, the rows over ``data``) against one card's on the whole
    batch (rank 0): the loss, the joined gradients (cosines by group, the
    norm), ``grad_norm`` as the train step computes it, each rank's K2/K2b
    launches and model-group collectives; then one optimizer step on the
    shards: the replicated leaves (a digest a rank), the joined weights (a
    digest) against one card's optimizer stepped on the joined gradients,
    and a validation batch's loss after it against that card's."""
    from mfar_tpu_torch.parallel import multihost
    from mfar_tpu_torch.parallel.data_parallel import shard_batch
    from mfar_tpu_torch.train.train_step import compute_gradients

    dev = torch.device(DEVICE)
    local, shard = shard_batch(batch, mesh)
    vlocal, vshard = shard_batch(vb, mesh)
    out = {"model": mesh.size("model")}
    if mesh.rank == 0:
        # one card in f32 (plain attention, which "auto" no longer gives an
        # f32 BERT): where bf16 rounding takes both
        f32_cfg = dataclasses.replace(cfg, dtype=torch.float32)
        if isinstance(cfg, EncoderConfig):
            f32_cfg = dataclasses.replace(f32_cfg, attention_impl="xla")
        f32 = init_state(train_model(f32_cfg), opt, seed=spec["seed"], device=DEVICE)
        f32_loss = compute_gradients(f32, to_device(batch, dev)).item()
        f32_grads = by_group(f32.model, {n: p.grad for n, p in f32.model.named_parameters()})
        del f32
        one = init_state(train_model(cfg), opt, seed=spec["seed"], device=DEVICE)
        one_loss = compute_gradients(one, to_device(batch, dev)).item()
        one_grads = by_group(one.model, {n: p.grad for n, p in one.model.named_parameters()})
        one.model.zero_grad(set_to_none=True)
    multihost.sync("tp-one-device")  # ranks that share the card wait for rank 0
    state = init_state(train_model(cfg), opt, seed=spec["seed"], device=DEVICE)
    tensor_parallel.shard_module(state.model, mesh)
    out["sharded"] = sorted(n for n, p in state.model.named_parameters()
                            if tensor_parallel.shard_of(p))
    if isinstance(cfg, EncoderConfig) and not mesh.host_collectives:
        out["spread"] = replicated_grad_spread(state.model, to_device(local, dev), shard)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    tensor_parallel.collectives.clear()
    loss = compute_gradients(state, to_device(local, dev), shard).item()
    out["step_launches"] = counts()
    out["collectives"] = dict(tensor_parallel.collectives)
    tp_grads = tp_whole(state.model, grads=True)
    grads = by_group(state.model, tp_grads)
    out.update(loss=loss, norm=l2_norm(grads), step_norm=tensor_parallel.grad_norm(list(state.model.parameters())).item(),
               n_flash=flash_groups(local))
    if mesh.rank == 0:
        out.update(one_loss=one_loss,
                   one_norm=l2_norm(one_grads),
                   grad_cos={k: F.cosine_similarity(grads[k], one_grads[k], dim=0).item()
                             for k in grads},
                   f32_loss=f32_loss,
                   f32_cos={k: (F.cosine_similarity(one_grads[k], f32_grads[k], dim=0).item(),
                                F.cosine_similarity(grads[k], f32_grads[k], dim=0).item())
                            for k in grads})
        del one_grads, f32_grads
    del grads

    # the step's update on the shards (train_step's optimizer step)
    state.optimizer.step()
    state.model.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["replicated_digest"], out["whole_digest"] = tp_digests(state.model)
    after = tp_whole(state.model)
    out["after_loss"] = eval_loss_step(state, to_device(vlocal, dev), vshard).item()
    if mesh.rank == 0:
        for name, p in one.model.named_parameters():
            p.grad = tp_grads[name].to(p.dtype)
        one.optimizer.step()
        out["update_err"] = max((after[n] - p.detach()).abs().max().item()
                                for n, p in one.model.named_parameters())
        out["one_after_loss"] = eval_loss_step(one, to_device(vb, dev)).item()
        del one
    del after, tp_grads, state
    torch.cuda.empty_cache()
    return out


def tp_world(spec) -> tuple:
    """The train_mesh cell's corpus and its train, validation and rate
    datasets (one BM25 negative from an index built here)."""
    corpus = Corpus.from_pairs(spec["pairs"], dataset_name="mag")
    field_info = resolve_fields("all_dense", "mag")
    sampler = IndexNegativeSampler(load_negative_sampler_index(corpus, None, "mag"), 100, 50, 1)
    return (corpus, field_info, *(ContrastiveDataset(q, corpus, r, sampler, field_info,
                                                     spec["tok"]) for q, r in spec["splits"]))


def tp_fit(spec, mesh, world, out) -> None:
    """``Trainer.fit`` of the train_mesh cell over ``mesh`` (launches counted
    a rank), rank 0's checkpoint against one card's layout, and
    ``restore_broadcast``: every rank's shards and moments as it fitted them."""
    corpus, field_info, train_ds, val_ds, _ = world
    cfg, opt = spec["cfg"], make_optimizer(encoder_lr=1e-4, weights_lr=0.1)
    run_dir = os.path.join(spec["work"], f"tp_run{mesh.rank}")
    tcfg = TrainerConfig(out_dir=run_dir, max_epochs=spec["epochs"],
                         train_batch_size=spec["batch"], seed=spec["seed"], query_max_length=512)
    trainer = Trainer(spec["tok"], field_info, corpus, train_ds, val_ds, spec["splits"][1][0],
                      os.path.join(spec["work"], "val.qrels"), tcfg, mesh=mesh)
    state = init_state(train_model(cfg), opt, seed=spec["seed"], device=DEVICE)
    torch.cuda.synchronize()
    reset_counts()
    t = time.perf_counter()
    state = trainer.fit(state)
    torch.cuda.synchronize()
    out.update(fit_s=time.perf_counter() - t, fit_launches=counts(), fit_steps=state.step)
    # dropout on: the replicated activations' masks must agree over the group
    out["fit_digests"] = tp_digests(state.model)
    latest = trainer.ckpt_step_broadcast("latest")
    if mesh.rank == 0:
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            rows = [json.loads(ln) for ln in f if '"train_loss"' in ln]
        out.update(losses=[r["train_loss"] for r in rows], valid=[r["valid_loss"] for r in rows])
        saved = trainer.ckpt.read(latest)
        whole = train_model(cfg)
        params = list(whole.parameters())
        moments = saved["optimizer"]["state"]
        out["ckpt_layout"] = (
            {k: tuple(v.shape) for k, v in saved["model"].items()}
            == {k: tuple(v.shape) for k, v in whole.state_dict().items()}
            and all(tuple(moments[i][k].shape) == tuple(params[i].shape)
                    for i in moments for k in ("exp_avg", "exp_avg_sq")))
        del saved, whole
    out["wrote"] = sorted(os.listdir(run_dir)) if os.path.isdir(run_dir) else None
    restored = trainer.restore_broadcast(
        latest, init_state(train_model(cfg), opt, seed=spec["seed"] + 1, device=DEVICE))
    out["restored"] = (
        latest, restored.step == state.step,
        all(torch.equal(a, b) for a, b in zip(state.model.state_dict().values(),
                                               restored.model.state_dict().values())),
        optimizer_states_equal(state.optimizer.state_dict(), restored.optimizer.state_dict()))
    del state, restored, trainer
    torch.cuda.empty_cache()


def tp_rates(spec, meshes, rate_ds, out) -> None:
    """Resident steps/s (5 steps after a warm-up) at each global batch: one
    card (rank 0 alone), then each mesh; peak memory a card; the
    model-group all-reduces of one step, counted, then replayed alone over
    NCCL for their time."""
    from mfar_tpu_torch.parallel import multihost
    from mfar_tpu_torch.parallel.data_parallel import shard_batch

    cfg, opt = spec["cfg"], make_optimizer(encoder_lr=1e-4, weights_lr=0.1)
    dev = torch.device(DEVICE)
    out["rates"] = {}
    for b in spec["rate_batches"]:
        rb = strip_meta(next(rate_ds.epoch_batches(b, seed=spec["seed"])))
        row = {}
        for label, mesh in [("one", None)] + list(meshes.items()):
            if label == "one" and multihost.process_index() != 0:
                multihost.sync("tp-one-card-rate")
                continue
            state = init_state(train_model(cfg), opt, seed=spec["seed"], device=DEVICE)
            if mesh is not None:
                tensor_parallel.shard_module(state.model, mesh)
            local, shard = shard_batch(rb, mesh)
            local = to_device(local, dev)
            train_step(state, local, shard)  # warm-up: cuBLAS, the allocator
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            tensor_parallel.collectives.clear()
            t = time.perf_counter()
            for _ in range(5):
                train_step(state, local, shard)
            torch.cuda.synchronize()
            entry = dict(steps_per_s=5 / (time.perf_counter() - t),
                         peak_gb=torch.cuda.max_memory_allocated() / 1e9)
            sizes = {n: c // 5 for n, c in tensor_parallel.collectives.items()}
            del state
            torch.cuda.empty_cache()
            if sizes:
                bufs = [torch.ones(n, device=DEVICE) for n, c in sizes.items() for _ in range(c)]
                group = mesh.group("model")
                torch.cuda.synchronize()
                multihost.sync("tp-replay")
                t = time.perf_counter()
                for buf in bufs:
                    torch.distributed.all_reduce(buf, group=group)
                torch.cuda.synchronize()
                entry.update(collectives=sum(sizes.values()),
                             collective_mb=sum(n * c for n, c in sizes.items()) * 4 / 1e6,
                             collective_ms=(time.perf_counter() - t) * 1e3)
                del bufs
            row[label] = entry
            if label == "one":
                multihost.sync("tp-one-card-rate")
        out["rates"][b] = row


def tp_rank(spec, mesh, out) -> None:
    """One rank of the train_tp phase: on each ``(n_data, n_model)`` of
    ``spec["tp_shapes"]`` the BERT step against one card's; on the ranks
    sharing card 0 also GTR-T5-base with Adafactor and ``Trainer.fit``; on
    cards, steps/s beside one card and the data-parallel mesh."""
    from mfar_tpu_torch.parallel.mesh import make_mesh

    world = tp_world(spec)
    train_ds, val_ds, rate_ds = world[2:]
    batch = strip_meta(next(train_ds.epoch_batches(spec["batch"], seed=spec["seed"])))
    vb = strip_meta(next(val_ds.epoch_batches(spec["batch"], seed=0)))
    nodrop = dataclasses.replace(spec["cfg"], hidden_dropout=0.0)
    adamw = make_optimizer(encoder_lr=1e-4, weights_lr=0.1)
    meshes = {f"{nd}x{nm}": make_mesh(n_data=nd, n_model=nm, backend=mesh.backend)
              for nd, nm in spec["tp_shapes"]}
    for label, tp_mesh in meshes.items():
        t = time.perf_counter()
        out[f"bert/{label}"] = tp_step(spec, tp_mesh, nodrop, adamw, batch, vb)
        out[f"bert/{label}"]["s"] = time.perf_counter() - t
        out[f"bert/{label}"]["whole_embeddings"] = (
            "encoder.embeddings.word_embeddings.weight" not in out[f"bert/{label}"]["sharded"])
    if spec["job"] == "tp_shared":
        tp_mesh = meshes["1x2"]
        t5 = T5Config.gtr_base(remat=True, dropout=0.0, num_layers=spec["cfg"].num_layers)
        t = time.perf_counter()
        out["t5/1x2"] = tp_step(spec, tp_mesh, t5, make_optimizer(
            encoder_lr=1e-3, weights_lr=0.1, use_adafactor=True), batch, vb)
        out["t5/1x2"]["s"] = time.perf_counter() - t
        tp_fit(spec, tp_mesh, world, out)
    else:
        tp_rates(spec, dict(meshes, **{f"{mesh.size('data')}x1": mesh}), rate_ds, out)


def hold_tp_step(ranks, key, label, cfg, adafactor=False) -> str:
    """The checks of one ``tp_step`` over the ranks; returns its line."""
    r0 = ranks[0][key]
    L = cfg.num_layers
    for r in ranks:
        got = r[key]
        want = (2 * L * got["n_flash"], L * got["n_flash"], L * got["n_flash"])
        if adafactor:
            want = (0, 0, 0)  # T5 attention is the plain product, as in JAX
        check(got["step_launches"] == want, f"{label}: rank {r['rank']} launched K2/dkv/dq "
                                            f"{got['step_launches']}, want {want}")
        check(got["loss"] == r0["loss"] and got["norm"] == r0["norm"],
              f"{label}: rank {r['rank']}'s loss or grad norm differs from rank 0's")
        check(got["replicated_digest"] == r0["replicated_digest"]
              and got["whole_digest"] == r0["whole_digest"],
              f"{label}: rank {r['rank']}'s replicated leaves or joined weights differ")
        check(got["after_loss"] == r0["after_loss"], f"{label}: validation losses differ")
    check(abs(r0["loss"] - r0["one_loss"]) <= TRAIN_LOSS_RTOL * abs(r0["one_loss"]),
          f"{label}: loss {r0['loss']} vs one card {r0['one_loss']}")
    check(abs(r0["norm"] - r0["one_norm"]) <= TRAIN_NORM_RTOL * r0["one_norm"],
          f"{label}: grad_norm {r0['norm']} vs one card {r0['one_norm']}")
    check(min(r0["grad_cos"].values()) >= TRAIN_MIN_COSINE, f"{label}: gradient cosines "
                                                            f"{r0['grad_cos']}")
    check(abs(r0["step_norm"] - r0["norm"]) <= TP_NORM_RTOL * r0["norm"],
          f"{label}: the step's grad_norm {r0['step_norm']} vs the joined gradients' "
          f"{r0['norm']}")
    check(r0["update_err"] <= TP_UPDATE_ATOL,
          f"{label}: the joined weights after the step differ from one card's optimizer "
          f"stepped on the joined gradients by {r0['update_err']}")
    check(abs(r0["after_loss"] - r0["one_after_loss"])
          <= TRAIN_LOSS_RTOL * abs(r0["one_after_loss"]),
          f"{label}: validation loss after the step {r0['after_loss']} vs one card "
          f"{r0['one_after_loss']}")
    n_coll = sum(r0["collectives"].values())
    spread = ""
    if "spread" in r0:
        (p_rel, p_leaf, p_n, n), (q_rel, q_leaf, q_n, _) = (
            max((r[key]["spread"][k] for r in ranks), key=lambda x: x[0])
            for k in ("passes", "peers"))
        spread = (f"; the replicated leaves' gradients of one backward without the group's "
                  f"average: two passes on a rank differ in {p_n} of {n} leaves, by up to "
                  f"{p_rel:.3g} of the leaf's largest entry ({p_leaf}), a rank and model rank "
                  f"0 in {q_n}, by up to {q_rel:.3g} ({q_leaf})")
    f32 = (f"; against one card in f32 (not held): loss {r0['f32_loss']:.6f}, off by "
           f"{abs(r0['one_loss'] - r0['f32_loss']) / abs(r0['f32_loss']):.3g} on one card in "
           f"bf16 and {abs(r0['loss'] - r0['f32_loss']) / abs(r0['f32_loss']):.3g} here, "
           f"gradient cosines (one card bf16, here) "
           f"{({k: tuple(round(c, 6) for c in v) for k, v in r0['f32_cos'].items()})}")
    return (f"{label}: loss {r0['loss']:.6f} vs one card {r0['one_loss']:.6f}, grad_norm "
            f"{r0['norm']:.6f} vs {r0['one_norm']:.6f} (the step's {r0['step_norm']:.6f}), "
            f"gradient cosines {({k: round(v, 6) for k, v in r0['grad_cos'].items()})}; after "
            f"one {'Adafactor' if adafactor else 'AdamW'} step on the shards the replicated "
            f"leaves and the joined weights bit-equal on every rank, the joined weights within "
            f"{r0['update_err']:.3g} of one card's optimizer stepped on the joined gradients, "
            f"a validation loss {r0['after_loss']:.6f} vs that card's "
            f"{r0['one_after_loss']:.6f}; a rank launched K2/dkv/dq {r0['step_launches']} "
            f"({cfg.num_heads // r0['model'] if cfg.num_heads % r0['model'] == 0 else cfg.num_heads}"
            f" heads a rank"
            f"{'; T5 attention is the plain product' if adafactor else ''}), issued {n_coll} model-group all-reduces "
            f"({sum(n * c for n, c in r0['collectives'].items()) * 4 / 1e6:.0f} MB of f32) in "
            f"the gradients' pass, peak {max(r[key]['peak_gb'] for r in ranks):.2f} GB; "
            f"{max(r[key]['s'] for r in ranks):.1f} s{spread}{f32}")


def run_train_tp(seed, corpus, tok, batch=4, steps=2, epochs=2, rate_batches=(16, 64)) -> dict:
    """Tensor-parallel training at Contriever-base width (vocabulary 30522,
    bf16, remat, K2/K2b through ``attention_impl="auto"``, attention dropout
    0; ``TP_SHARED_LAYERS`` layers) on train_mesh's data: (a) two gloo ranks sharing card 0 as (data 1 x
    model 2): one step against one card's, ``Trainer.fit``, its checkpoint
    and ``restore_broadcast``; (b) GTR-T5-base with Adafactor on that pair;
    (d) K2 and K2b at the local head counts; (e) ``train --n-model 2`` over
    two gloo ranks sharing card 0, then a one-card ``retrieve
    --checkpoint-dir``.  (c), over four cards, is :func:`run_train_tp_cards`."""
    check(tok.vocab_size <= TP_VOCAB, f"vocabulary {tok.vocab_size} > {TP_VOCAB}")
    rng = np.random.default_rng(seed + 71)
    pairs = list(corpus.pairs())
    splits = mag_splits(pairs, (steps * batch, 2 * batch, max(rate_batches)), rng)
    cfg = EncoderConfig.contriever_base(vocab_size=TP_VOCAB, attention_impl="auto",
                                        attention_dropout=0.0, remat=True,
                                        num_layers=TP_SHARED_LAYERS)
    spec = dict(seed=seed, device=DEVICE, pairs=pairs, tok=tok, cfg=cfg, splits=splits,
                batch=batch, steps=steps, epochs=epochs, rate_batches=rate_batches)
    out = {}
    t = time.perf_counter()
    ranks = run_ranks("tp_shared", dict(spec, tp_shapes=[(1, 2)]), 2, "train_tp_a")
    check([(r["backend"], r["card"]) for r in ranks] == [("gloo", 0)] * 2,
          f"(a) ranks' backends and cards {[(r['backend'], r['card']) for r in ranks]}")
    phase("train_tp", "(a) two gloo ranks on card 0, (data 1 x model 2), global batch "
                      f"{batch}: " + hold_tp_step(ranks, "bert/1x2", "BERT", cfg))
    check(not ranks[0]["bert/1x2"]["whole_embeddings"], "(a) word_embeddings not sharded at 2")
    phase("train_tp", "(b) GTR-T5-base with Adafactor on (a)'s pair: "
                      + hold_tp_step(ranks, "t5/1x2", "T5",
                                     T5Config.gtr_base(num_layers=TP_SHARED_LAYERS),
                                     adafactor=True))
    r0, L = ranks[0], cfg.num_layers
    for r in ranks:
        fl = r["fit_launches"]
        check(r["fit_steps"] == epochs * steps and fl[1] == fl[2] >= L * r["fit_steps"]
              and fl[0] >= 2 * fl[1], f"(a) rank {r['rank']} fit {r['fit_steps']} steps, "
                                      f"launched {fl}")
        check(r["restored"][1:] == (True, True, True),
              f"(a) rank {r['rank']}'s restore_broadcast: {r['restored']}")
        check(r["rank"] == 0 or r["wrote"] is None, f"(a) rank {r['rank']} wrote files")
        check(r["fit_digests"] == r0["fit_digests"],
              f"(a) rank {r['rank']}'s weights differ from rank 0's after fit")
    check(r0["ckpt_layout"], "(a) rank 0's checkpoint is not in one card's layout")
    check(all(math.isfinite(x) for x in r0["losses"] + r0["valid"]),
          f"(a) losses {r0['losses']} {r0['valid']}")
    launches = tuple(sum(r["fit_launches"][i] for r in ranks) for i in range(3))
    phase("train_tp", f"(a) Trainer.fit {r0['fit_steps']} steps in {epochs} epochs in "
                      f"{[round(r['fit_s'], 2) for r in ranks]} s a rank (validation and rank "
                      f"0's checkpoints included); train loss by epoch {r0['losses']}, valid "
                      f"{r0['valid']}; K2/dkv/dq launches by rank "
                      f"{[r['fit_launches'] for r in ranks]}; hidden dropout 0.1, the replicated "
                      f"leaves and joined weights bit-equal on both ranks after it; rank 0's "
                      f"checkpoint holds one "
                      f"card's keys and shapes (model and AdamW moments); restore_broadcast of "
                      f"checkpoint {r0['restored'][0]} gives each rank its shards and moments")
    out["a"] = dict(loss=r0["bert/1x2"]["loss"], one_loss=r0["bert/1x2"]["one_loss"],
                    grad_cos=r0["bert/1x2"]["grad_cos"], launches=launches,
                    t5_loss=r0["t5/1x2"]["loss"], t5_one_loss=r0["t5/1x2"]["one_loss"],
                    t5_grad_cos=r0["t5/1x2"]["grad_cos"], t5_update_err=r0["t5/1x2"]["update_err"],
                    fit_s=[r["fit_s"] for r in ranks], s=time.perf_counter() - t)

    out["d"] = run_k2_local_heads(seed)
    out["e"] = run_train_tp_cli(seed, corpus, 2, shared=True, n_docs=128)
    out["launches"] = launches
    return {"train_tp": out, "train_tp_launches": launches}


def run_train_tp_cards(seed, corpus, tok, batch=16, rate_batches=(16, 64)) -> dict:
    """train_tp over four cards, one NCCL rank a card (skipped on fewer):
    (c) the BERT step of (a) on (data 2 x model 2) and (data 1 x model 4),
    the vocabulary guard at 4, steps/s at global batches 16 and 64 beside
    one card and the data-parallel four, peak memory, the model-group
    all-reduces of a step; then the train command with ``--n-model 2`` over
    the four ranks and a one-card ``retrieve --checkpoint-dir``."""
    n_cards = torch.cuda.device_count()
    if n_cards < 4:
        phase("train_tp_cards", f"needs four cards; {n_cards} visible: skipped")
        return {}
    rng = np.random.default_rng(seed + 71)
    pairs = list(corpus.pairs())
    splits = mag_splits(pairs, (2 * batch, 2 * batch, max(rate_batches)), rng)
    cfg = EncoderConfig.contriever_base(vocab_size=TP_VOCAB, attention_impl="auto",
                                        attention_dropout=0.0, remat=True)
    spec = dict(seed=seed, device=DEVICE, pairs=pairs, tok=tok, cfg=cfg, splits=splits,
                batch=batch, steps=2, epochs=2, rate_batches=rate_batches)
    t = time.perf_counter()
    ranks = run_ranks("tp_cards", dict(spec, tp_shapes=[(2, 2), (1, 4)]), 4, "train_tp_c")
    check(sorted(r["card"] for r in ranks) == [0, 1, 2, 3]
          and {r["backend"] for r in ranks} == {"nccl"},
          "(c) ranks share a card or do not run NCCL")
    for label in ("2x2", "1x4"):
        phase("train_tp_cards", f"(c) four NCCL ranks, (data {label[0]} x model {label[-1]}), "
                                f"global batch {batch}: "
                                + hold_tp_step(ranks, f"bert/{label}", "BERT", cfg))
    check(ranks[0]["bert/1x4"]["whole_embeddings"]
          and not ranks[0]["bert/2x2"]["whole_embeddings"],
          "(c) the guard: word_embeddings should shard at 2 and stay whole at 4")
    phase("train_tp_cards", f"(c) the guard: BERT's word_embeddings ({TP_VOCAB} rows) sharded "
                            f"at model 2, whole on every rank at model 4 ({TP_VOCAB} % 4 = "
                            f"{TP_VOCAB % 4})")
    rates = ranks[0]["rates"]
    for b, row in rates.items():
        parts = []
        for k, v in row.items():
            peak = max(r["rates"][b][k]["peak_gb"] for r in ranks if k in r["rates"][b])
            part = f"{k} {v['steps_per_s']:.3f} steps/s, {peak:.2f} GB"
            if "collectives" in v:
                part += (f", {v['collectives']} all-reduces of {v['collective_mb']:.0f} MB in "
                         f"{v['collective_ms']:.2f} ms")
            parts.append(part)
        phase("train_tp_cards", f"(c) global batch {b}, resident steps/s (5 steps after a "
                                f"warm-up), peak GB a card, the model-group all-reduces of a "
                                f"step replayed alone: {'; '.join(parts)} ({CARD})")
    out = {"c": dict(rates=rates, s=time.perf_counter() - t,
                     loss={k: ranks[0][f"bert/{k}"]["loss"] for k in ("2x2", "1x4")},
                     one_loss=ranks[0]["bert/2x2"]["one_loss"])}
    out["e"] = run_train_tp_cli(seed, corpus, 4, shared=False)
    return {"train_tp_cards": out}


def run_k2_local_heads(seed, shapes=((96, 6, 512), (96, 3, 512))) -> dict:
    """(d) K2 with the logsumexp and K2b against their plain versions at a
    model rank's heads of Contriever-base at n_model 2 and 4, with their
    times and bounds."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 72)
    out = {}
    for b, h, s in shapes:
        lengths = np.random.default_rng(seed + h).integers(2, s + 1, size=b)
        lengths[0], lengths[1] = s, 2
        q, k, v, seg, dout = k2b_inputs(gen, b, h, s, lengths.tolist())
        rel, abs_err = check_k2b(q, k, v, seg, dout, f"at {list(q.shape)}")
        scale = 1.0 / math.sqrt(q.shape[-1])
        o, lse = flash_attention_fwd(q, k, v, seg, scale)
        _, di = flash_attention_bwd_dq(q, k, v, seg, lse, o, dout, scale)
        bounds = k2b_bound(q, seg)
        r = dict(
            fwd_ms=time_cuda(lambda: flash_attention_fwd(q, k, v, seg, scale)),
            fwd_bound_ms=k2_bound(q, seg, lse=True)[0],
            fwd_plain_ms=time_cuda(lambda: flash_attention_plain(q, k, v, seg, scale),
                                   reps=5, inner=2),
            fwd_library_ms=time_cuda(lambda: library_attention(q, k, v, seg, scale),
                                     reps=11, inner=5),
            dq_ms=time_cuda(lambda: flash_attention_bwd_dq(q, k, v, seg, lse, o, dout, scale)),
            dkv_ms=time_cuda(lambda: flash_attention_bwd_dkv(q, k, v, seg, lse, di, dout,
                                                             scale)),
            plain_bwd_ms=time_cuda(lambda: flash_attention_bwd_plain(
                q, k, v, seg, o, lse, dout, scale), reps=5, inner=2),
            dq_bound_ms=bounds["dq"][0], dkv_bound_ms=bounds["dkv"][0],
            max_rel_err=rel, dq_max_abs_err=abs_err["dq"], dkv_max_abs_err=abs_err["dkv"])
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        lib_out = library_attention(*leaves, seg, scale)
        r["library_bwd_ms"] = time_cuda(
            lambda: torch.autograd.grad(lib_out, leaves, dout, retain_graph=True),
            reps=11, inner=5)
        out[h] = r
        phase("train_tp", f"(d) K2/K2b at a rank's heads, bf16 {list(q.shape)}: max err "
                          f"{rel:.3g} of the largest gradient (tolerance rtol {K2B_RTOL}, atol "
                          f"{K2B_ATOL_REL} x max |grad|; K2 rtol=atol {K2_ATOL}); K2 with the "
                          f"logsumexp {r['fwd_ms']:.4f} ms (bound {r['fwd_bound_ms']:.4f}), "
                          f"plain {r['fwd_plain_ms']:.4f}, SDPA {r['fwd_library_ms']:.4f}; dq "
                          f"{r['dq_ms']:.4f} (bound {r['dq_bound_ms']:.4f}), dkv "
                          f"{r['dkv_ms']:.4f} (bound {r['dkv_bound_ms']:.4f}), plain backward "
                          f"{r['plain_bwd_ms']:.4f}, SDPA backward {r['library_bwd_ms']:.4f} "
                          f"({CARD})")
        del q, k, v, seg, dout, o, lse, di, leaves, lib_out
    return out


def run_train_tp_cli(seed, corpus, world, shared, n_docs=512) -> dict:
    """(e) ``commands/train.main`` with ``--n-model 2`` as a user starts it
    over ``world`` processes (the ``MFAR_*`` triple): gloo ranks sharing card
    0 (``MFAR_BACKEND=gloo``; a BERT directory of ``TP_SHARED_LAYERS``
    layers) when ``shared``, else one NCCL rank a card (all 12 layers);
    then a one-card ``retrieve --checkpoint-dir`` on its output."""
    pairs = list(corpus.pairs())[:n_docs]
    sub = Corpus.from_pairs(pairs, dataset_name="mag")
    rng = np.random.default_rng(seed + 73)
    splits = dict(zip(("train", "val", "test"), mag_splits(pairs, (32, 16, 16), rng)))
    with tempfile.TemporaryDirectory() as d:
        data, bert, out = (os.path.join(d, x) for x in ("data", "bert", "out"))
        write_data_dir(data, pairs, splits)
        write_bert_dir(bert, sub, seed + 74,
                       **({"num_layers": TP_SHARED_LAYERS} if shared else {}))
        coord = f"file://{os.path.join(d, 'init')}"
        extra = {"CUDA_VISIBLE_DEVICES": "0", "MFAR_BACKEND": "gloo"} if shared else {}
        argv = [sys.executable, "-m", "mfar_tpu_torch.commands.train", "--dataset-name", "mag",
                "--data", data, "--out", out, "--lexical-index", os.path.join(d, "idx"),
                "--weights-lr", "0.1", "--model-name", bert, "--run-one-iteration",
                "--max-epochs", "1", "--n-model", "2", "--multihost", "force",
                "--device", "cuda"]
        t = time.perf_counter()
        procs = start_ranks([argv] * world, [rank_env(coord, world, r, **extra)
                                             for r in range(world)], d, "train_tp_cli")
        try:
            watch_ranks(procs, "train_tp (e)")
        finally:
            stop_ranks(procs)
        train_s = time.perf_counter() - t
        with open(os.path.join(d, "train_tp_cli0.log")) as f:
            mesh_line = next((ln.strip() for ln in f if ln.startswith("[train] mesh")), None)
        check(mesh_line is not None and "'model': 2" in mesh_line,
              f"the train command's mesh line: {mesh_line}")
        for rel in ("metrics.jsonl", "best.txt", "results_dicts.jsonl", "final-dev.qres",
                    "checkpoints/0/state.pt", "checkpoints/0/meta.json"):
            check(os.path.exists(os.path.join(out, rel)), f"the train command wrote no {rel}")
        run = os.path.join(d, "test.qres")
        t = time.perf_counter()
        retrieve_cmd.main(["--dataset-name", "mag", "--data", data, "--out", run,
                           "--partition", "test", "--model-name", bert,
                           "--checkpoint-dir", out, "--device", "cuda"])
        retrieve_s = time.perf_counter() - t
        by_query = collections.Counter(r.query_id for r in trec.QRes.from_file(run))
        check(set(by_query) == set(splits["test"][0])
              and set(by_query.values()) == {min(100, len(pairs))},
              f"retrieve --checkpoint-dir wrote {dict(by_query)}")
    phase("train_tp", f"(e) train --n-model 2 over {world} "
                      f"{'gloo ranks sharing card 0' if shared else 'NCCL ranks, one a card'}"
                      f" ({len(pairs)} docs, a local BERT directory at Contriever-base width, "
                      f"{TP_SHARED_LAYERS if shared else 12} layers, "
                      f"--run-one-iteration): {mesh_line}; {train_s:.1f}s (process start, model "
                      f"load, one step, validation, the test index build and eval included); a "
                      f"one-card retrieve --checkpoint-dir on its output: {retrieve_s:.1f}s, "
                      f"{min(100, len(pairs))} hits for each of {len(by_query)} queries")
    return dict(train_s=train_s, retrieve_s=retrieve_s, world=world)


# ----------------------------------------------------------------------
# phase 11: the train command, then retrieve from its checkpoint


def run_train_cli(seed, corpus, n_docs=512):
    """``commands/train.main`` as a user runs it: a dataset directory (corpus,
    train/val/test queries and qrels) and a local BERT directory at
    Contriever-base width, one iteration on the card with the JAX command's
    defaults (plain attention, dropout 0.1, so no K2); then ``retrieve
    --checkpoint-dir`` on its output."""
    pairs = list(corpus.pairs())[:n_docs]
    sub = Corpus.from_pairs(pairs, dataset_name="mag")
    rng = np.random.default_rng(seed + 7)
    splits = dict(zip(("train", "val", "test"), mag_splits(pairs, (32, 16, 16), rng)))
    with tempfile.TemporaryDirectory() as d:
        data, bert, out = (os.path.join(d, x) for x in ("data", "bert", "out"))
        write_data_dir(data, pairs, splits)
        write_bert_dir(bert, sub, seed + 8)
        reset_counts()
        t = time.perf_counter()
        train_cmd.main(["--dataset-name", "mag", "--data", data, "--out", out,
                        "--lexical-index", os.path.join(d, "idx"), "--weights-lr", "0.1",
                        "--model-name", bert, "--run-one-iteration", "--max-epochs", "1",
                        "--device", "cuda"])
        train_s = time.perf_counter() - t
        check(counts() == (0, 0, 0), f"the train command (attention 'xla') launched {counts()}")
        for rel in ("metrics.jsonl", "best.txt", "results_dicts.jsonl", "final-dev.qres",
                    "checkpoints/0/state.pt", "checkpoints/0/meta.json"):
            check(os.path.exists(os.path.join(out, rel)), f"the train command wrote no {rel}")
        run = os.path.join(d, "test.qres")
        t = time.perf_counter()
        retrieve_cmd.main(["--dataset-name", "mag", "--data", data, "--out", run,
                           "--partition", "test", "--model-name", bert,
                           "--checkpoint-dir", out, "--device", "cuda"])
        retrieve_s = time.perf_counter() - t
        by_query = collections.Counter(r.query_id for r in trec.QRes.from_file(run))
        check(set(by_query) == set(splits["test"][0])
              and set(by_query.values()) == {min(100, len(pairs))},
              f"retrieve --checkpoint-dir wrote {dict(by_query)}")
    phase("train_cli", f"train command on the card ({len(pairs)} docs, 32/16/16 queries, a local "
                       f"BERT directory at Contriever-base width, --run-one-iteration): "
                       f"{train_s:.1f}s (model load, BM25 index, one step, validation, the "
                       f"test index build and eval included), no K2 launched; retrieve "
                       f"--checkpoint-dir on its output: {retrieve_s:.1f}s, "
                       f"{min(100, len(pairs))} hits for each of {len(by_query)} queries")
    return dict(train_cli_s=train_s, retrieve_ckpt_s=retrieve_s)


# ----------------------------------------------------------------------
# phase 11b: K2/K2b's other routes on the main paths (f32, D = 32, D = 26)

# all-MiniLM-L6-v2's published config.json (sentence-transformers): hidden
# 384, 6 layers, 12 heads (D = 32), intermediate 1536, BERT's 30522-word
# vocabulary, 512 positions
MINILM_WIDTH = dict(hidden_size=384, num_layers=6, num_heads=12, intermediate_size=1536,
                    vocab_size=30522, max_position_embeddings=512)
# huawei-noah/TinyBERT_General_4L_312D's published config: hidden 312, 4
# layers, 12 heads (D = 26, whose 52-byte rows a head no tensor map reads in
# bf16: the wgmma forward on row maps over the [B, S, 312] projections and
# the wgmma backward over copies padded to D = 32; in f32 the 3xTF32
# forward on row maps and the 3xTF32 backward over copies padded to D =
# 28), intermediate 1200, BERT's vocabulary
TINYBERT_WIDTH = dict(hidden_size=312, num_layers=4, num_heads=12, intermediate_size=1200,
                      vocab_size=30522, max_position_embeddings=512)


def one_batch_against_plain(model, plain, batch, seed, label):
    """One train batch through ``model`` ("auto": K2 and K2b on the routes
    the routing rule gives) and ``plain`` (the same weights, "xla"): loss, gradient norm
    and each optimizer group's gradient cosine.  Returns them and the K2/K2b
    launches of the first (``k2_counts``)."""
    reset_k2_counts()
    loss, norm, grads = loss_and_grads(model, batch, seed)
    n_launched = k2_counts()
    check(counts() == (0, 0, 0), f"{label}: the wgmma D = 64 kernels launched {counts()}")
    reset_k2_counts()
    loss_pl, norm_pl, grads_pl = loss_and_grads(plain, batch, seed)
    check(k2_counts() == launched(), f"{label}: the plain path launched {k2_counts()}")
    cos = {k: F.cosine_similarity(grads[k], grads_pl[k], dim=0).item() for k in grads}
    return loss, loss_pl, norm, norm_pl, cos, n_launched


def run_f32(seed, corpus, tok, queries, n_docs=512, steps=6, batch=16, n_queries=64):
    """K2's forwards and K2b's pairs other than the wgmma ones at D = 64,
    through the entry points a user calls.

    (a) Contriever-base width in f32 (``--precision 32``: hidden 768, 12
    layers, 12 heads, D = 64; seeded weights) with ``attention_impl="auto"``:
    the index build of the cli phase's ``n_docs`` documents (the 512-token
    fields through the f32 forward) against the same weights built with
    plain attention; rerank (K1 on the f32 index) and exact serving with the
    f32 "auto" query encoder against the plain-attention engine; one train
    batch against the plain path; ``Trainer.fit`` for ``steps`` steps at
    ``batch`` (attention dropout 0; the f32 forward and both f32 backward
    kernels).  (b) A BERT at all-MiniLM-L6-v2's width in bf16 (D = 32),
    written as a local directory with seeded weights and loaded through
    ``prepare_model``, set to "auto": the same documents' build against
    "xla", and one train batch against the plain path; (c) the same at
    TinyBERT_General_4L_312D's width (D = 26); (d) one train batch at that
    width in f32 against the plain path.  Every count is set to 0 just
    before each main-path run and read just after, and each run's launches
    are held to the routes the routing rule gives: (a) the 3xTF32 forward
    and pair, (b) the wgmma forward and pair at D = 32, (c) the wgmma
    forward on row maps ("wgmma_rows") and the wgmma pair at D = 32 over
    zero-padded copies, (d) the 3xTF32 forward on row maps ("tf32_rows")
    and the 3xTF32 pair over copies padded to D = 28."""
    pairs = list(corpus.pairs())[:n_docs]
    sub = Corpus.from_pairs(pairs, dataset_name="mag")
    field_info = resolve_fields("all_dense", "mag")
    n_long = sum(f.max_seq_length >= 128 and f.max_seq_length % 128 == 0
                 for f in field_info.values())
    batches = math.ceil(n_docs / 256)
    rng = np.random.default_rng(seed + 7)

    # (a) the index build in f32, through the 3xTF32 forward and plain
    cfg = EncoderConfig.contriever_base(vocab_size=tok.vocab_size, dtype=torch.float32,
                                        attention_impl="auto")
    encoder = init_encoder(cfg, seed=seed + 7)
    plain = Encoder(dataclasses.replace(cfg, attention_impl="xla"))
    plain.load_state_dict(encoder.state_dict())
    encode, encode_plain = make_encode_fn(encoder, device=DEVICE), make_encode_fn(plain,
                                                                                 device=DEVICE)
    warm = tok.encode_batch(["w1 w2"] * 256, 512, bucket=False)
    for fn in (encode, encode_plain):
        fn(warm["input_ids"], warm["attention_mask"])
    torch.cuda.synchronize()
    reset_k2_counts()
    matrix, build_s = timed_build(encode, tok, sub, field_info)
    build_launches = k2_counts()["tf32"]
    want_launches = cfg.num_layers * n_long * batches
    check(k2_counts() == launched(tf32=want_launches),
          f"the f32 build launched {k2_counts()} (want the 3xTF32 K2 {want_launches} times, "
          f"nothing else)")
    want, plain_s = timed_build(encode_plain, tok, sub, field_info)
    check(k2_counts() == launched(tf32=want_launches), "the plain-attention build launched K2")
    check(matrix.dtype == np.float32 and bool(np.isfinite(matrix).all()),
          f"f32 matrix {matrix.dtype}")
    index_err = float(np.abs(np.asarray(matrix) - np.asarray(want)).max())
    check(index_err <= F32_INDEX_ATOL, f"f32 build vs xla build: max abs err {index_err}")
    n_seq = n_docs * len(field_info)
    phase("f32", f"(a) Contriever-base width in f32 (hidden {cfg.hidden_size} x "
                 f"{cfg.num_layers} layers, {cfg.num_heads} heads, D = "
                 f"{cfg.hidden_size // cfg.num_heads}), attention auto: index build of "
                 f"{n_docs} docs x {len(field_info)} fields through the 3xTF32 K2 "
                 f"{build_s:.2f}s ({n_seq / build_s:.0f} field-docs/s, {build_launches} "
                 f"launches), plain attention {plain_s:.2f}s; max abs err against the xla "
                 f"build {index_err:.3g} (atol {F32_INDEX_ATOL})")

    # (a) rerank (K1 on the f32 index) and exact, against the plain-attention engine
    mixer = {"weight": rng.normal(scale=0.05, size=(cfg.hidden_size, len(field_info)))
             .astype(np.float32)}
    # recall_k = n_docs: stage 1 keeps every document, so the two engines'
    # rerank lists differ only by their scores (two indexes within 1e-4), not
    # by which documents a stage-1 boundary let through
    kw = dict(field_info=field_info, doc_keys=[k for k, _ in pairs], tokenizer=tok,
              mixer_params=mixer, recall_k=n_docs, dense_dtype=torch.float32, device=DEVICE)
    engine = RetrievalEngine(mode="rerank", encode_fn=encode, dense_matrix=matrix, **kw)
    reference = RetrievalEngine(mode="rerank", encode_fn=encode_plain, dense_matrix=want,
                                use_pallas_gather=False, **kw)
    qs, served = queries[:n_queries], []
    for mode, path in (("rerank", "singlechip-rerank-k1"), ("exact", "singlechip-dense")):
        gather_per_field_scores.launches = 0
        got, secs = timed_run(engine, qs, mode, 64)
        check(engine.last_serve_path == path, f"f32 {mode}: path {engine.last_serve_path}")
        check((gather_per_field_scores.launches > 0) == (mode == "rerank"),
              f"f32 {mode}: K1 launches {gather_per_field_scores.launches}")
        check_results(got, len(qs), min(100, n_docs))
        msg = rankings_agree(got, reference.retrieve_many(qs, top_k=100, mode=mode,
                                                          batch_size=64), E2E_RTOL, E2E_ATOL)
        check(msg is None, f"f32 {mode} vs the plain-attention engine: {msg}")
        served.append(f"{mode} {len(qs) / secs:.1f} QPS (path {path})")
    del engine, reference, plain, encode_plain
    phase("f32", f"(a) serving over the f32 index, {len(qs)} queries of 12 words: "
                 f"{', '.join(served)}; each == the plain-attention engine (rtol {E2E_RTOL}, "
                 f"atol {E2E_ATOL}, ties allowed)")

    # (a) training in f32: one batch against the plain path, then Trainer.fit
    (train_q, train_r), (val_q, val_r) = mag_splits(pairs, (steps * batch, 2 * batch), rng)
    sampler = IndexNegativeSampler(load_negative_sampler_index(sub, None, "mag"), 100, 50, 1)
    train_ds, val_ds = (ContrastiveDataset(q, sub, r, sampler, field_info, tok)
                        for q, r in ((train_q, train_r), (val_q, val_r)))
    tcfg = dataclasses.replace(cfg, attention_dropout=0.0, remat=True)
    opt = make_optimizer(encoder_lr=1e-4, weights_lr=0.1)
    state = init_state(train_model(tcfg), opt, seed=seed, device=DEVICE)
    state.model.encoder.load_state_dict(encoder.state_dict())
    del encoder, encode
    one = to_device(strip_meta(next(train_ds.epoch_batches(batch, seed=seed))),
                    torch.device(DEVICE))
    n_flash = flash_groups(one)
    plain_model = train_model(dataclasses.replace(tcfg, attention_impl="xla"),
                              state.model.state_dict()).to(DEVICE)
    loss, loss_pl, norm, norm_pl, cos, one_launched = one_batch_against_plain(
        state.model, plain_model, one, seed, "f32 train batch")
    del plain_model
    layers = tcfg.num_layers
    # remat: the forward twice a layer and group
    check(one_launched == launched(tf32=2 * layers * n_flash, tf32_dkv=layers * n_flash,
                                   tf32_dq=layers * n_flash),
          f"one f32 batch launched {one_launched} ({n_flash} groups)")
    check(abs(loss - loss_pl) <= F32_LOSS_RTOL * abs(loss_pl), f"f32 loss {loss} vs {loss_pl}")
    check(abs(norm - norm_pl) <= F32_NORM_RTOL * norm_pl, f"f32 grad norm {norm} vs {norm_pl}")
    check(min(cos.values()) >= F32_MIN_COSINE, f"f32 gradient cosines {cos}")
    with tempfile.TemporaryDirectory() as d:
        trec.write_qrels(os.path.join(d, "val.qrels"), val_r)
        trainer = Trainer(tok, field_info, sub, train_ds, val_ds, val_q,
                          os.path.join(d, "val.qrels"),
                          TrainerConfig(out_dir=d, max_epochs=1, train_batch_size=batch,
                                        seed=seed, query_max_length=512))
        torch.cuda.synchronize()
        reset_k2_counts()
        t = time.perf_counter()
        state = trainer.fit(state)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t
        fit_launches = k2_counts()
        check(state.step == steps, f"f32 fit ran {state.step} steps")
        check(fit_launches == launched(tf32=fit_launches["tf32"],
                                       tf32_dkv=fit_launches["tf32_dkv"],
                                       tf32_dq=fit_launches["tf32_dkv"])
              and fit_launches["tf32_dkv"] >= layers * steps
              and fit_launches["tf32"] >= 2 * fit_launches["tf32_dkv"],
              f"f32 fit launched {fit_launches}")
        with open(os.path.join(d, "metrics.jsonl")) as f:
            logged = [json.loads(ln) for ln in f if '"train_loss"' in ln]
        fit_loss = [(r["train_loss"], r["valid_loss"]) for r in logged]
        check(bool(fit_loss) and all(math.isfinite(x) for pair in fit_loss for x in pair),
              f"f32 fit losses {fit_loss}")
    del state, trainer
    torch.cuda.empty_cache()
    phase("f32", f"(a) one f32 train batch (batch {batch}, attention dropout 0, remat) "
                 f"through the 3xTF32 K2 and K2b vs plain attention: loss "
                 f"{loss:.8f} vs "
                 f"{loss_pl:.8f}, grad_norm {norm:.6f} vs {norm_pl:.6f}, gradient cosine "
                 f"encoder {cos['encoder']:.7f} head {cos['head']:.7f} (gates: loss rtol "
                 f"{F32_LOSS_RTOL}, norm rtol {F32_NORM_RTOL}, cosine >= {F32_MIN_COSINE}); "
                 f"launches {one_launched}; Trainer.fit {steps} steps in {fit_s:.1f}s "
                 f"with validation and a checkpoint, (train, valid) loss {fit_loss}, "
                 f"launches {fit_launches}")

    # (b) a BERT directory at all-MiniLM-L6-v2's width in bf16 (D = 32),
    # (c) one at TinyBERT-4L-312D's (D = 26), (d) a batch at that width in f32
    train = (train_q, train_r, sampler)
    mini = bert_width_cell("(b)", "all-MiniLM-L6-v2", MINILM_WIDTH, "wgmma_headdim",
                           "the wgmma K2 and K2b at D = 32", seed + 9, sub, field_info, train,
                           batch, seed, warm, n_long * batches)
    tiny = bert_width_cell("(c)", "TinyBERT_General_4L_312D", TINYBERT_WIDTH, "wgmma_rows",
                           "the wgmma K2 on row maps (D = 26: no map reads its heads one by "
                           "one) and the wgmma K2b over copies padded to D = 32", seed + 13, sub,
                           field_info, train, batch, seed, warm, n_long * batches,
                           bwd_route="wgmma_headdim")
    tiny_f32 = f32_width_batch("(d)", "TinyBERT_General_4L_312D", TINYBERT_WIDTH, seed + 13, sub,
                               field_info, train, batch, seed)
    torch.cuda.empty_cache()
    # the main paths' launches: the three builds, Trainer.fit and the three
    # BERT-width batches (the Contriever-width f32 batch is a check beside fit)
    f32_launches = {key: fit_launches[key] + mini[key] + tiny[key] + tiny_f32[key]
                    for key in fit_launches}
    f32_launches["tf32"] += build_launches
    return dict(f32_build_s=build_s, f32_plain_build_s=plain_s, f32_index_err=index_err,
                f32_fit_s=fit_s, f32_batch=dict(loss=loss, loss_plain=loss_pl, norm=norm,
                                                norm_plain=norm_pl, cos=cos),
                minilm_build_s=mini["build_s"], minilm_xla_build_s=mini["xla_build_s"],
                tinybert_build_s=tiny["build_s"], tinybert_xla_build_s=tiny["xla_build_s"],
                f32_launches=f32_launches)


def bert_width_cell(tag, name, width, route, what, dir_seed, sub, field_info, train, batch,
                    seed, warm, encoder_calls, bwd_route=None):
    """Phase f32's bf16 BERT directory at a published width (seeded weights,
    loaded through ``prepare_model``, set to "auto"): the index build
    against "xla" (each layer's ``encoder_calls`` 512-token calls on the
    forward ``route``, nothing else), and one train batch against the plain
    path (the forward on ``route`` twice a layer and group under remat, the
    backward pair of ``bwd_route``, by default the forward's, once).
    Returns the K2/K2b launches of both runs, summed, and the two builds'
    seconds."""
    bwd_route = bwd_route or route
    with tempfile.TemporaryDirectory() as d:
        write_bert_dir(d, sub, dir_seed, **width)
        config, state_dict, mtok = prepare_model(d)
        layers = config.num_layers
        head_dim = width["hidden_size"] // width["num_heads"]
        check(config.hidden_size // config.num_heads == head_dim
              and config.dtype == torch.bfloat16 and layers == width["num_layers"],
              f"prepare_model gave {config}")
        auto = Encoder(dataclasses.replace(config, attention_impl="auto"))
        auto.load_state_dict(state_dict)
        xla = Encoder(dataclasses.replace(config, attention_impl="xla"))
        xla.load_state_dict(state_dict)
        encode, encode_xla = make_encode_fn(auto, device=DEVICE), make_encode_fn(xla, device=DEVICE)
        encode_xla(warm["input_ids"][:, :128], warm["attention_mask"][:, :128])
        reset_k2_counts()
        matrix, build_s = timed_build(encode, mtok, sub, field_info)
        build_launches = k2_counts()
        check(build_launches == launched(**{route: layers * encoder_calls}),
              f"the {name}-width build launched {build_launches} (want {route} only)")
        want, xla_s = timed_build(encode_xla, mtok, sub, field_info)
        agree = index_agreement(matrix, want, f"{name}-width bf16 build vs xla")
        del auto, xla, encode, encode_xla
        loss, loss_pl, norm, norm_pl, cos, batch_launches = width_batch(
            name, config, state_dict, mtok, route, bwd_route, sub, field_info, train, batch, seed)
        phase("f32", f"{tag} a BERT directory at {name}'s width (hidden {config.hidden_size} "
                     f"x {layers} layers, {config.num_heads} heads, D = {head_dim}, "
                     f"intermediate {config.intermediate_size}, {config.dtype}; WordPiece vocab "
                     f"{mtok.vocab_size}), attention auto: build of {len(sub)} docs through "
                     f"{what} {build_s:.2f}s ({build_launches[route]} launches), xla "
                     f"{xla_s:.2f}s; against the xla build: {agree}; one train batch vs plain: "
                     f"loss {loss:.6f} vs {loss_pl:.6f}, grad_norm {norm:.5f} vs {norm_pl:.5f}, "
                     f"cosine encoder {cos['encoder']:.6f} head {cos['head']:.6f} (the bf16 "
                     f"train gates); launches {batch_launches}")
    out = {key: build_launches[key] + batch_launches[key] for key in build_launches}
    out.update(build_s=build_s, xla_build_s=xla_s)
    return out


def width_batch(name, config, state_dict, mtok, route, bwd_route, sub, field_info, train, batch,
                seed):
    """One train batch of a BERT at a published width (``config`` and
    ``state_dict`` from ``prepare_model``; "auto", attention dropout 0,
    remat) against the plain path on the same weights: its launches held to
    the forward on ``route`` twice a layer and group, the pair of
    ``bwd_route`` once, nothing else; loss, norm and cosines to the f32
    gates for f32 activations, the bf16 train gates otherwise.  Returns
    (loss, plain loss, norm, plain norm, cosines, launches)."""
    train_q, train_r, sampler = train
    layers = config.num_layers
    ds = ContrastiveDataset(train_q, sub, train_r, sampler, field_info, mtok)
    mb = to_device(strip_meta(next(ds.epoch_batches(batch, seed=seed))), torch.device(DEVICE))
    mcfg = dataclasses.replace(config, attention_impl="auto", attention_dropout=0.0, remat=True)
    model = train_model(mcfg)
    model.encoder.load_state_dict(state_dict)
    model = model.to(DEVICE)
    plain_model = train_model(dataclasses.replace(mcfg, attention_impl="xla"),
                              model.state_dict()).to(DEVICE)
    label = f"{name}-width {'f32 ' if config.dtype == torch.float32 else ''}train batch"
    loss, loss_pl, norm, norm_pl, cos, batch_launches = one_batch_against_plain(
        model, plain_model, mb, seed, label)
    del model, plain_model
    n_flash = flash_groups(mb)
    check(batch_launches == launched(**{route: 2 * layers * n_flash,
                                        f"{bwd_route}_dkv": layers * n_flash,
                                        f"{bwd_route}_dq": layers * n_flash}),
          f"one {label} launched {batch_launches}")
    gates = ((F32_LOSS_RTOL, F32_NORM_RTOL, F32_MIN_COSINE) if config.dtype == torch.float32
             else (TRAIN_LOSS_RTOL, TRAIN_NORM_RTOL, TRAIN_MIN_COSINE))
    check(abs(loss - loss_pl) <= gates[0] * abs(loss_pl)
          and abs(norm - norm_pl) <= gates[1] * norm_pl and min(cos.values()) >= gates[2],
          f"{label}: loss {loss} vs {loss_pl}, norm {norm} vs {norm_pl}, cosines {cos}")
    return loss, loss_pl, norm, norm_pl, cos, batch_launches


def f32_width_batch(tag, name, width, dir_seed, sub, field_info, train, batch, seed):
    """Phase f32's f32 batch at a published width: the BERT directory of
    bert_width_cell (seeded weights) loaded through ``prepare_model`` with
    f32 activations, and one train batch against the plain path
    (width_batch).  At TinyBERT's D = 26 (104-byte rows a head, not a
    multiple of 16 bytes, and D not a multiple of the 3xTF32 kernels' 4
    columns) the 3xTF32 forward on row maps takes it ("tf32_rows": the
    heads' 1248-byte rows), and the 3xTF32 pair over copies padded to D =
    28 the backward.  Returns the batch's K2/K2b launches."""
    with tempfile.TemporaryDirectory() as d:
        write_bert_dir(d, sub, dir_seed, **width)
        config, state_dict, mtok = prepare_model(d, dtype=torch.float32)
    check(config.dtype == torch.float32, f"prepare_model gave {config}")
    loss, loss_pl, norm, norm_pl, cos, batch_launches = width_batch(
        name, config, state_dict, mtok, "tf32_rows", "tf32", sub, field_info, train, batch,
        seed)
    phase("f32", f"{tag} one train batch at {name}'s width in f32 (hidden "
                 f"{config.hidden_size} x {config.num_layers} layers, {config.num_heads} heads, "
                 f"D = {config.hidden_size // config.num_heads}; attention auto, dropout 0, "
                 f"remat) through the 3xTF32 K2 on row maps and the 3xTF32 K2b over copies "
                 f"padded to D = 28 vs plain attention: loss "
                 f"{loss:.8f} vs {loss_pl:.8f}, grad_norm {norm:.6f} vs {norm_pl:.6f}, cosine "
                 f"encoder {cos['encoder']:.7f} head {cos['head']:.7f} (the f32 gates); "
                 f"launches {batch_launches}")
    return batch_launches


# ----------------------------------------------------------------------
# phase 12: serving scale


def run_serving(seed, engine, queries, n=131072, batch_size=64):
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 1)
    fd, e = len(engine.dense_keys), engine.emb_dim
    matrix = torch.randn(n, fd, e, device=DEVICE, generator=gen, dtype=torch.bfloat16)
    big = RetrievalEngine(
        field_info=engine.field_info, doc_keys=[f"doc{i}" for i in range(n)],
        encode_fn=engine.encode_fn, tokenizer=engine.tokenizer,
        mixer_params=engine.mixer_params, dense_matrix=matrix, recall_k=100,
        mode="rerank", device=DEVICE,
    )
    del matrix
    qs = (queries * 2)[:512]
    big.retrieve(qs[:batch_size], top_k=100)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    gather_per_field_scores.launches = 0
    out, secs = timed_run(big, qs, "rerank", batch_size)
    launches = gather_per_field_scores.launches
    check(launches > 0, "serving-scale rerank launched K1 no time")
    check_results(out, len(qs), 100)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # one batch's stages, host clock around synchronised device work
    def stage_ms(fn, reps=5):
        ts = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t) * 1e3)
        return statistics.median(ts), r

    batch = qs[:batch_size]
    enc_ms, _ = stage_ms(lambda: big.encode_queries(batch))
    disp_ms, st = stage_ms(lambda: big._rerank_dispatch(batch))
    fin_ms, _ = stage_ms(lambda: big._rerank_finish(st, 100))
    phase("serving", f"N={n} bf16 [{n}, {fd}, {e}] corpus, rerank: "
                     f"{len(qs) / secs:.1f} QPS ({secs:.3f}s for {len(qs)} queries, "
                     f"batch {batch_size}), K1 launches {launches}, peak memory "
                     f"{peak_gb:.2f} GB; one batch: encode {enc_ms:.2f} ms, encode+recall "
                     f"{disp_ms:.2f} ms, candidate union+K1+rerank+fetch {fin_ms:.2f} ms")
    prof = device_profile(lambda: big.retrieve_many(qs[:256], top_k=100, batch_size=batch_size))
    phase("serving", f"profile of 256 queries: wall {prof['wall_ms']:.2f} ms, device busy "
                     f"{prof['device_ms']:.2f} ms (share {prof['busy_share']}); device ms by "
                     f"kernel: {prof['top']}")
    return dict(serving_qps=len(qs) / secs, serving_launches=launches,
                serving_busy_share=prof["busy_share"])


# ----------------------------------------------------------------------
# phases 13-15: hybrid (dense + BM25) retrieval


def rare_word_queries(pairs, n, rng, min_rank, words=8):
    """Queries of ``words`` distinct content words from the title and
    abstract of random documents: words of Zipf rank >= ``min_rank`` (of
    the ``w<rank>`` vocabularies here), as a user's query keeps a text's
    rarer terms."""
    queries = []
    while len(queries) < n:
        payload = pairs[rng.integers(len(pairs))][1]
        pool = sorted({w for w in (payload["title"] + " " + payload["abstract"]).split()
                       if w[:1] == "w" and w[1:].isdigit() and int(w[1:]) >= min_rank})
        if len(pool) >= words:
            queries.append(" ".join(rng.choice(pool, size=words, replace=False)))
    return queries


def hybrid_reference(engine, queries, mixer, bm25, mask=None, k=100, round_query=True):
    """Reference for hybrid exact mode, written out here and not through the
    port's scoring helpers: field weights softmax(q @ W) (times the mask),
    the dense fields' weighted query rounded to the corpus dtype (exact mode
    scores in the corpus dtype; rerank's stage 2 does not round, so
    ``round_query=False`` for it) and scored in f32 against the whole
    corpus, plus each sparse field's weight times its full-corpus BM25
    scores from ``bm25`` (field key -> index), summed, and a full top-k.
    Returns the keyed top-k and the [Q, N] totals."""
    fd, n = len(engine.dense_keys), engine.n_docs
    w_mix = torch.as_tensor(mixer["weight"], dtype=torch.float32, device=DEVICE)
    keyed, totals = [], []
    for s in range(0, len(queries), 64):
        batch = queries[s : s + 64]
        with torch.inference_mode():
            q = engine.encode_queries(batch)
            w = torch.softmax(q @ w_mix, dim=-1)
            if mask is not None:
                w = w * torch.as_tensor(mask, dtype=torch.float32, device=DEVICE)
            total = torch.zeros(len(batch), n, device=DEVICE)
            if engine.has_dense:
                docs = engine.docs_flat.view(n, fd, engine.emb_dim).float()
                qf = w[:, :fd, None] * q[:, None, :]
                if round_query:
                    qf = qf.to(engine.docs_flat.dtype).float()
                total += torch.einsum("bfe,nfe->bn", qf, docs)
            cleaned = [clean_query(t) for t in batch]
            for s_i, fk in enumerate(engine.sparse_keys):
                scores = torch.from_numpy(bm25[fk].get_scores_batch(cleaned)).to(DEVICE)
                total += w[:, fd + s_i, None] * scores
            top_s, top_i = torch.topk(total, min(k, n), dim=-1)
        keyed.extend(engine._to_keyed(top_s.cpu().numpy(), top_i.cpu().numpy()))
        totals.append(total.cpu().numpy())
    return keyed, np.concatenate(totals)


def scores_are_totals(results, totals, doc_row, label) -> None:
    """Each returned hit's score is its document's reference total (the
    rerank modes return a subset, each hit scored in full)."""
    for qi, hits in enumerate(results):
        for key, score in hits:
            want = float(totals[qi, doc_row[key]])
            check(abs(score - want) <= E2E_ATOL + E2E_RTOL * abs(want),
                  f"{label}: query {qi} doc {key} scored {score}, reference {want}")


def run_hybrid(seed, engine, corpus, queries, batch_size=64) -> dict:
    """``all_dense,all_sparse`` on the e2e corpus: the K2-built dense matrix
    and a native BM25 index per sparse field (10 mixer fields).  Exact mode
    on both routes and rerank (K1 for stage 2's dense part) against
    references; a sparse-only engine; every sparse field masked against a
    dense-only engine."""
    rng = np.random.default_rng(seed + 11)
    pairs = list(corpus.pairs())
    doc_row = {k: i for i, k in enumerate(corpus.keys())}
    field_info = resolve_fields("all_dense,all_sparse", "mag")
    sparse_fields = {k: f for k, f in field_info.items() if f.is_sparse}
    t = time.perf_counter()
    native = build_sparse_indices(corpus, sparse_fields)
    native_s = time.perf_counter() - t
    check(all(ix.native is not None for ix in native.values()),
          "BM25Index's auto backend took scipy on the card's machine")
    t = time.perf_counter()
    scipy_ix = {k: BM25Index.create(format_documents(pairs, f.name, f.dataset), name=f.name,
                                    backend="scipy") for k, f in sparse_fields.items()}
    scipy_s = time.perf_counter() - t
    mixer = {"weight": rng.normal(scale=0.05, size=(engine.emb_dim, len(field_info)))
             .astype(np.float32)}
    kw = dict(doc_keys=list(corpus.keys()), encode_fn=engine.encode_fn,
              tokenizer=engine.tokenizer, recall_k=100, device=DEVICE)
    hyb = RetrievalEngine(field_info=field_info, mixer_params=mixer,
                          dense_matrix=engine.docs_flat, sparse_indices=native, **kw)
    hq = rare_word_queries(pairs, len(queries), rng, min_rank=5000)
    for mode in ("exact", "rerank"):
        hyb.retrieve(hq[:batch_size], top_k=100, mode=mode)  # warm-up
    k = min(100, engine.n_docs)

    # exact, postings route: counts to 0 just before, read just after
    flash_attention.launches = gather_per_field_scores.launches = 0
    exact, exact_s = timed_run(hyb, hq, "exact", batch_size)
    check(gather_per_field_scores.launches == 0 and flash_attention.launches == 0,
          "exact hybrid launched K1 or K2")
    check(hyb.last_serve_path == "singlechip-hybrid-postings", f"path {hyb.last_serve_path}")
    check_results(exact, len(hq), k)
    ref, ref_totals = hybrid_reference(hyb, hq, mixer, scipy_ix)
    msg = rankings_agree(exact, ref, E2E_RTOL, E2E_ATOL)
    check(msg is None, f"exact hybrid (postings) vs brute force: {msg}")
    widths = [hyb._sparse_postings_raw([clean_query(x) for x in hq[s : s + batch_size]])
              for s in range(0, len(hq), batch_size)]
    nnz = np.mean([float((v != 0).sum()) / v.shape[0] for _, v, _ in widths])

    # exact, combined route: the 12-word e2e queries hold the corpus's
    # commonest words, so their postings are denser than half the corpus
    dense_q = queries[:batch_size]
    combined = hyb.retrieve(dense_q, top_k=100, mode="exact")
    check(hyb.last_serve_path == "singlechip-hybrid-combined", f"path {hyb.last_serve_path}")
    msg = rankings_agree(combined, hybrid_reference(hyb, dense_q, mixer, scipy_ix)[0],
                         E2E_RTOL, E2E_ATOL)
    check(msg is None, f"exact hybrid (combined) vs brute force: {msg}")

    # rerank through K1 with sparse stages 1b and 2, against the plain gather
    flash_attention.launches = gather_per_field_scores.launches = 0
    rerank, rerank_s = timed_run(hyb, hq, "rerank", batch_size)
    launches = gather_per_field_scores.launches
    check(launches > 0, "hybrid rerank launched K1 no time")
    check(hyb.last_serve_path == "singlechip-rerank-hybrid-k1", f"path {hyb.last_serve_path}")
    check_results(rerank, len(hq), k)
    plain = RetrievalEngine(field_info=field_info, mixer_params=mixer, use_pallas_gather=False,
                            dense_matrix=engine.docs_flat, sparse_indices=native, **kw)
    want = plain.retrieve_many(hq, top_k=100, mode="rerank", batch_size=batch_size)
    check(plain.last_serve_path == "singlechip-rerank-hybrid-plain", f"path {plain.last_serve_path}")
    msg = rankings_agree(rerank, want, E2E_RTOL, E2E_ATOL)
    check(msg is None, f"hybrid rerank K1 vs plain gather: {msg}")
    scores_are_totals(rerank, hybrid_reference(hyb, hq, mixer, scipy_ix, round_query=False)[1],
                      doc_row, "hybrid rerank")
    del plain

    # a sparse-only engine, both modes
    mixer_s = {"weight": mixer["weight"][:, len(field_info) - len(sparse_fields):]}
    sparse_only = RetrievalEngine(field_info=sparse_fields, mixer_params=mixer_s,
                                  sparse_indices=native, **kw)
    got_exact = sparse_only.retrieve(hq, top_k=100, mode="exact")
    check(sparse_only.last_serve_path == "host-sparse-only", f"path {sparse_only.last_serve_path}")
    want, totals = hybrid_reference(sparse_only, hq, mixer_s, scipy_ix)
    msg = rankings_agree(got_exact, want, E2E_RTOL, E2E_ATOL)
    check(msg is None, f"sparse-only exact vs reference: {msg}")
    got_rerank = sparse_only.retrieve(hq, top_k=100, mode="rerank")
    check(sparse_only.last_serve_path == "singlechip-rerank-sparse-only",
          f"path {sparse_only.last_serve_path}")
    scores_are_totals(got_rerank, totals, doc_row, "sparse-only rerank")

    # every sparse field masked == a dense-only engine (up to the softmax's
    # normalisation over 10 fields against 5: one positive factor a query),
    # on an f32 copy of the corpus so that neither rounds its folded query
    fd = len(hyb.dense_keys)
    docs32 = engine.docs_flat.float()
    mask = np.array([1.0] * fd + [0.0] * len(sparse_fields), np.float32)
    masked_eng = RetrievalEngine(field_info=field_info, mixer_params=mixer, dense_matrix=docs32,
                                 sparse_indices=native, mask=mask, **kw)
    masked = masked_eng.retrieve(hq, top_k=100, mode="exact")
    check(masked_eng.last_serve_path == "singlechip-hybrid-postings",
          f"path {masked_eng.last_serve_path}")
    dense_fields = {k: f for k, f in field_info.items() if f.is_dense}
    dense_only = RetrievalEngine(field_info=dense_fields,
                                 mixer_params={"weight": mixer["weight"][:, :fd]},
                                 dense_matrix=docs32, **kw)
    dense_hits = dense_only.retrieve(hq, top_k=100, mode="exact")
    with torch.inference_mode():
        w = torch.softmax(hyb.encode_queries(hq) @ torch.as_tensor(
            mixer["weight"], device=DEVICE), dim=-1)[:, :fd].sum(-1).cpu().tolist()
    scaled = [[(key, score * f) for key, score in hits] for hits, f in zip(dense_hits, w)]
    msg = rankings_agree(masked, scaled, E2E_RTOL, E2E_ATOL)
    check(msg is None, f"all sparse fields masked vs dense-only engine: {msg}")
    del masked_eng, dense_only, docs32

    phase("hybrid", f"all_dense,all_sparse over the e2e corpus ({engine.n_docs} docs, "
                    f"{len(field_info)} mixer fields, the K2-built bf16 matrix), BM25 build "
                    f"{native_s:.2f}s native / {scipy_s:.2f}s scipy (5 fields); exact "
                    f"(postings): {len(hq) / exact_s:.1f} QPS, {nnz:.0f} postings a query, "
                    f"widths {sorted({w[0].shape[1] for w in widths})} == brute force; "
                    f"combined route on dense postings == brute force; rerank through K1: "
                    f"{len(hq) / rerank_s:.1f} QPS, K1 launches {launches} == plain gather, "
                    f"each hit its full score; sparse-only exact == reference, rerank hits "
                    f"scored in full; every sparse field masked == dense-only engine "
                    f"(rtol {E2E_RTOL}, atol {E2E_ATOL}, ties allowed)")
    return dict(hybrid_k1_launches=launches, hybrid_exact_qps=len(hq) / exact_s,
                hybrid_rerank_qps=len(hq) / rerank_s, hybrid_bm25_native_s=native_s,
                hybrid_bm25_scipy_s=scipy_s, hybrid_postings_per_query=nnz)


def synth_mag_serving(n_docs, n_queries, rng, vocab_size=200000):
    """Mag-shaped documents at serving scale, text drawn from a Zipf
    vocabulary headed by the tokenizer's stopwords: a 12-word title, a
    160-word abstract, 10 cited titles of 10 words, 8 two-word topics and 6
    authors with an institution each (~320 words a document); and queries
    of 8 content words of a random document's title and abstract."""
    vocab = sorted(STOPWORDS_EN) + [f"w{i}" for i in range(vocab_size)]
    p = 1.0 / np.arange(1, len(vocab) + 1)
    per_doc = 12 + 160 + 10 * 10 + 8 * 2 + 6 * 6
    ids = rng.choice(len(vocab), size=per_doc * n_docs, p=p / p.sum())
    words = [vocab[i] for i in ids.tolist()]
    pairs = []
    for d in range(n_docs):
        it = iter(words[d * per_doc : (d + 1) * per_doc])

        def take(n):
            return " ".join(next(it) for _ in range(n))

        pairs.append((f"doc{d}", {
            "type": "paper",
            "title": take(12),
            "abstract": take(160),
            "paper___cites___paper": [take(10) for _ in range(10)],
            "paper___has_topic___field_of_study": [take(2) for _ in range(8)],
            "author___affiliated_with___institution": {
                f"author {take(2)}": [take(4)] for _ in range(6)},
        }))
    return pairs, rare_word_queries(pairs, n_queries, rng, min_rank=300)


def run_hybrid_serving(seed, engine, n=131072, n_queries=512, n_text_queries=128,
                       batch_size=64) -> dict:
    """Hybrid serving at STaRK-Prime's scale: 131072 mag-shaped documents
    with a native BM25 index over each of the 5 sparse fields and the
    serving phase's random bf16 [131072, 5, 768] dense matrix; exact and
    rerank QPS, one batch's stages, a torch.profiler window, one batch held
    against the brute-force reference.  Two synthetic query mixes, neither
    from a published query log: 8 rarer content words (the postings route)
    and 12 words of a document's title and abstract, common words kept, as
    the e2e queries are drawn (the combined route)."""
    rng = np.random.default_rng(seed + 13)
    t = time.perf_counter()
    pairs, qs = synth_mag_serving(n, n_queries, rng)
    text_qs = []
    for _ in range(n_text_queries):
        payload = pairs[rng.integers(n)][1]
        pool = (payload["title"] + " " + payload["abstract"]).split()
        text_qs.append(" ".join(rng.choice(pool, size=12, replace=False)))
    data_s = time.perf_counter() - t
    field_info = resolve_fields("all_dense,all_sparse", "mag")
    sparse_fields = {k: f for k, f in field_info.items() if f.is_sparse}
    t = time.perf_counter()
    texts = {k: format_documents(pairs, f.name, f.dataset) for k, f in sparse_fields.items()}
    format_s = time.perf_counter() - t
    t = time.perf_counter()
    bm25 = {k: BM25Index.create(texts[k], name=f.name) for k, f in sparse_fields.items()}
    build_s = time.perf_counter() - t
    del texts
    check(all(ix.native is not None for ix in bm25.values()), "BM25 took the scipy backend")
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 1)
    fd, e = len(engine.dense_keys), engine.emb_dim
    matrix = torch.randn(n, fd, e, device=DEVICE, generator=gen, dtype=torch.bfloat16)
    mixer = {"weight": rng.normal(scale=0.05, size=(e, len(field_info))).astype(np.float32)}
    big = RetrievalEngine(
        field_info=field_info, doc_keys=[k for k, _ in pairs], encode_fn=engine.encode_fn,
        tokenizer=engine.tokenizer, mixer_params=mixer, dense_matrix=matrix,
        sparse_indices=bm25, recall_k=100, device=DEVICE,
    )
    del matrix
    for mode in ("exact", "rerank"):
        big.retrieve(qs[:batch_size], top_k=100, mode=mode)  # warm-up

    raws = [big._sparse_postings_raw([clean_query(x) for x in qs[s : s + batch_size]])
            for s in range(0, len(qs), batch_size)]
    check(all(r is not None for r in raws), "a serving batch's postings are dense")
    width = np.mean([r[0].shape[1] for r in raws])
    nnz = np.mean([float((r[1] != 0).sum()) / r[1].shape[0] for r in raws])

    flash_attention.launches = gather_per_field_scores.launches = 0
    exact, exact_s = timed_run(big, qs, "exact", batch_size)
    check(gather_per_field_scores.launches == 0, "exact hybrid launched K1")
    check(big.last_serve_path == "singlechip-hybrid-postings", f"path {big.last_serve_path}")
    check_results(exact, len(qs), 100)
    flash_attention.launches = gather_per_field_scores.launches = 0
    rerank, rerank_s = timed_run(big, qs, "rerank", batch_size)
    launches = gather_per_field_scores.launches
    check(launches > 0, "hybrid rerank at serving scale launched K1 no time")
    check(big.last_serve_path == "singlechip-rerank-hybrid-k1", f"path {big.last_serve_path}")
    check_results(rerank, len(qs), 100)
    big.retrieve(text_qs[:batch_size], top_k=100, mode="exact")  # warm-up
    text, text_s = timed_run(big, text_qs, "exact", batch_size)
    check(big.last_serve_path == "singlechip-hybrid-combined", f"path {big.last_serve_path}")
    check_results(text, len(text_qs), 100)
    msg = rankings_agree(text[:batch_size],
                         hybrid_reference(big, text_qs[:batch_size], mixer, bm25)[0],
                         E2E_RTOL, E2E_ATOL)
    check(msg is None, f"hybrid serving combined batch vs brute force: {msg}")

    batch = qs[:batch_size]
    cleaned = [clean_query(x) for x in batch]

    def stage_ms(fn, reps=5):
        ts = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ts)

    enc_ms = stage_ms(lambda: big.encode_queries(batch))
    post_ms = stage_ms(lambda: big._sparse_postings_raw(cleaned))
    native_ms = stage_ms(lambda: [ix.get_postings_batch(cleaned, pad_multiple=None)
                                  for ix in bm25.values()])
    disp_ms = stage_ms(lambda: big._dispatch_exact(batch, 100))
    exact_ms = stage_ms(lambda: big.retrieve(batch, top_k=100, mode="exact"))
    rerank_ms = stage_ms(lambda: big.retrieve(batch, top_k=100, mode="rerank"))
    prof = device_profile(lambda: big.retrieve_many(qs[:256], top_k=100, mode="exact",
                                                    batch_size=batch_size))
    ref, _ = hybrid_reference(big, batch, mixer, bm25)
    msg = rankings_agree(exact[:batch_size], ref, E2E_RTOL, E2E_ATOL)
    check(msg is None, f"hybrid serving batch vs brute force: {msg}")
    a16 = bucketed_beside_scatter(big, batch, raws[0])
    dq = sample_queries(big, qs, 256, seed + SERVE_DRIFT_OFFSETS[0])
    drifts = {route: route_drift("hybrid_serving", route, big, mode, dq, sizes)
              for route, mode, sizes in (("singlechip-hybrid-postings", "exact", None),
                                         ("singlechip-rerank-hybrid-k1", "rerank",
                                          FEW_DRIFT_SIZES))}
    route = "fused_hybrid_topk_buckets_from_query"  # no engine route
    drifts[route] = answer_drift(lambda texts: bucketed_answers(big, texts), dq)
    phase("hybrid_serving", f"drift of 8 queries alone vs first in batches of 16-{len(dq)} "
                            f"and last in one of {len(dq)}, and of {len(dq)} queries run "
                            f"twice: {hold_drift('hybrid_serving', route, drifts[route])} "
                            f"({CARD})")
    phase("hybrid_serving", f"N={n} mag-shaped docs ({data_s:.1f}s to make), BM25 over "
                            f"{len(bm25)} fields: format {format_s:.1f}s, native build "
                            f"{build_s:.1f}s; {len(qs)} queries of 8 content words, batch "
                            f"{batch_size}: postings width {width:.0f} a batch (mean), "
                            f"{nnz:.0f} postings a query; exact (postings) "
                            f"{len(qs) / exact_s:.1f} QPS; rerank (K1, {launches} launches) "
                            f"{len(qs) / rerank_s:.1f} QPS; {len(text_qs)} queries of 12 "
                            f"words, common ones kept: exact (combined) "
                            f"{len(text_qs) / text_s:.1f} QPS, one batch == brute force")
    phase("hybrid_serving", f"one batch: encode {enc_ms:.2f} ms, host postings (5 fields) "
                            f"{post_ms:.2f} ms (the native calls {native_ms:.2f} ms, their "
                            f"concatenation and copies the rest), exact dispatch (encode + postings + H2D + "
                            f"scatter + scan) {disp_ms:.2f} ms, exact retrieve {exact_ms:.2f} "
                            f"ms, rerank retrieve {rerank_ms:.2f} ms; profile of 256 exact "
                            f"queries: wall {prof['wall_ms']:.2f} ms, device busy "
                            f"{prof['device_ms']:.2f} ms (share {prof['busy_share']}); device ms "
                            f"by kernel: {prof['top']}; one batch == brute force (rtol "
                            f"{E2E_RTOL}, atol {E2E_ATOL}); the scatter-free bucketed op "
                            f"{a16['bucketed_ms']:.3f} ms against the scatter route's op "
                            f"{a16['scatter_ms']:.3f} ms on that batch (CUDA events; "
                            f"{a16['chunks']} chunk(s), buckets of {a16['width']}, the host's "
                            f"bucketing {a16['bucket_host_ms']:.2f} ms apart), its top-100 == "
                            f"the scatter's ({CARD})")
    # the int8 corpus's hybrid routes and the host stream's postings route
    # over the same corpus and BM25 indices
    kw = dict(field_info=field_info, doc_keys=[k for k, _ in pairs], encode_fn=engine.encode_fn,
              tokenizer=engine.tokenizer, mixer_params=mixer, sparse_indices=bm25,
              recall_k=100, device=DEVICE)
    i8 = RetrievalEngine(dense_matrix=big.docs_flat, quantize="int8", **kw)
    i8_qps = {}
    for label, batch_qs, route in (("postings", qs, "singlechip-int8-hybrid-postings"),
                                   ("combined", text_qs, "singlechip-int8-hybrid-combined")):
        i8.retrieve(batch_qs[:batch_size], top_k=100)  # warm-up
        res, secs = timed_run(i8, batch_qs, "exact", batch_size)
        check(i8.last_serve_path == route, f"path {i8.last_serve_path}, want {route}")
        check_results(res, len(batch_qs), 100)
        i8_qps[label] = (len(batch_qs) / secs, overlap(res, exact if label == "postings"
                                                        else text))
    route = "singlechip-int8-hybrid-postings"
    drifts[route] = route_drift("int8", route, i8, "exact", dq, FEW_DRIFT_SIZES)
    del i8
    hs = RetrievalEngine(dense_matrix=big.docs_flat.cpu(), corpus_on_host=True, **kw)
    hs.retrieve(qs[:batch_size], top_k=100)  # warm-up
    hs_res, hs_s = timed_run(hs, qs, "exact", batch_size)
    check(hs.last_serve_path == "host-stream-hybrid-postings", f"path {hs.last_serve_path}")
    check_results(hs_res, len(qs), 100)
    f32 = RetrievalEngine(dense_matrix=big.docs_flat, dense_dtype=torch.float32, **kw)
    msg = rankings_agree(hs_res, f32.retrieve_many(qs, top_k=100, batch_size=batch_size),
                         E2E_RTOL, E2E_ATOL)
    check(msg is None, f"host-stream hybrid vs the device-resident engine: {msg}")
    route = "host-stream-hybrid-postings"
    drifts[route] = route_drift("host_stream", route, hs, "exact", dq, FEW_DRIFT_SIZES)
    del hs, f32
    phase("int8", f"hybrid_serving's corpus as int8: exact {len(qs)} queries on "
                  f"singlechip-int8-hybrid-postings {i8_qps['postings'][0]:.1f} QPS, "
                  f"{len(text_qs)} on singlechip-int8-hybrid-combined "
                  f"{i8_qps['combined'][0]:.1f} QPS; top-100 shared with bf16 "
                  f"{i8_qps['postings'][1]:.4f} / {i8_qps['combined'][1]:.4f} ({CARD})")
    phase("host_stream", f"hybrid_serving's corpus in host memory: {len(qs)} queries on "
                         f"host-stream-hybrid-postings {len(qs) / hs_s:.1f} QPS; every batch "
                         f"== the device-resident engine (rtol {E2E_RTOL}, atol {E2E_ATOL}) "
                         f"({CARD})")
    return dict(hybrid_serving_exact_qps=len(qs) / exact_s,
                hybrid_int8_qps={k: v[0] for k, v in i8_qps.items()},
                hybrid_host_stream_qps=len(qs) / hs_s,
                hybrid_serving_rerank_qps=len(qs) / rerank_s,
                hybrid_serving_combined_qps=len(text_qs) / text_s,
                hybrid_serving_k1_launches=launches, hybrid_serving_bm25_build_s=build_s,
                hybrid_serving_postings_width=width, hybrid_serving_postings_per_query=nnz,
                hybrid_serving_busy_share=prof["busy_share"], hybrid_serving_a16=a16,
                hybrid_serving_drift=drifts,
                hybrid_serving_stage_ms=dict(encode=enc_ms, postings=post_ms,
                                             native_postings=native_ms, dispatch=disp_ms,
                                             exact=exact_ms, rerank=rerank_ms))


def bucketed_answers(engine, texts, k=100):
    """The engine's answers to ``texts`` through the scatter-free bucketed
    op (``fused_hybrid_topk_buckets_from_query``, no engine route): the
    engine's encoded queries and host postings, bucketed on the host at the
    engine's chunk."""
    n, fd = engine.n_docs, len(engine.dense_keys)
    chunk = topk_chunk(n, len(texts))
    raw = engine._sparse_postings_raw([clean_query(x) for x in texts])
    buckets = bucket_postings_np(*raw, n, chunk)
    with torch.inference_mode():
        q = engine.encode_queries(texts)
        bk = [torch.from_numpy(a).to(DEVICE) for a in buckets]
        s, i = fused_hybrid_topk_buckets_from_query(q, engine._W, engine._mask_tensor(),
                                                    engine.docs_flat, *bk, n, fd, k,
                                                    chunk_size=chunk)
        return engine._to_keyed(s.cpu().numpy(), i.cpu().numpy())


def bucketed_beside_scatter(engine, batch, raw, k=100) -> dict:
    """The scatter-free bucketed op (``fused_hybrid_topk_buckets_from_query``,
    no engine route) beside the scatter route's op
    (``fused_hybrid_topk_postings_from_query``) on one batch's postings
    ``raw``, over the engine's corpus at its chunk: CUDA-event ms of each,
    the host's bucketing timed apart, and the bucketed top-k held to the
    scatter's."""
    n, fd = engine.n_docs, len(engine.dense_keys)
    chunk = topk_chunk(n, len(batch))
    t = time.perf_counter()
    buckets = bucket_postings_np(*raw, n, chunk)
    host_ms = (time.perf_counter() - t) * 1e3
    with torch.inference_mode():
        q = engine.encode_queries(batch)
        flat = [torch.from_numpy(a).to(DEVICE) for a in raw]
        bk = [torch.from_numpy(a).to(DEVICE) for a in buckets]
        args = (q, engine._W, engine._mask_tensor(), engine.docs_flat)

        def scatter():
            return fused_hybrid_topk_postings_from_query(*args, *flat, n, fd, k, chunk_size=chunk)

        def bucketed():
            return fused_hybrid_topk_buckets_from_query(*args, *bk, n, fd, k, chunk_size=chunk)

        want, got = scatter(), bucketed()
        msg = rankings_agree(*(engine._to_keyed(s.cpu().numpy(), i.cpu().numpy())
                               for s, i in (got, want)), E2E_RTOL, E2E_ATOL)
        check(msg is None, f"the bucketed hybrid op vs the scatter route's: {msg}")
        scatter_ms = time_cuda(scatter, reps=7, inner=3, warmup=1)
        bucketed_ms = time_cuda(bucketed, reps=7, inner=3, warmup=1)
    return dict(scatter_ms=scatter_ms, bucketed_ms=bucketed_ms, bucket_host_ms=host_ms,
                chunks=buckets[0].shape[1], width=buckets[0].shape[2])


def run_hybrid_cli(seed, n_docs=200) -> dict:
    """The port's hybrid command chain at Contriever-base width, from inputs
    it makes itself: make_synth_data (mag), create_sparse_index,
    precompute_sparse_scores, train --field-names all_dense,all_sparse
    --sparse-scores-path --run-one-iteration, mask_fields on its output,
    then retrieve --lexical-index --checkpoint-dir in rerank mode (K1)."""
    fields = "all_dense,all_sparse"
    n_fields = len(resolve_fields(fields, "mag"))
    with tempfile.TemporaryDirectory() as d:
        data, idx, scores, bert, out, abl = (os.path.join(d, x) for x in (
            "data", "idx", "scores", "bert", "out", "abl"))
        secs = {}
        t = time.perf_counter()
        make_synth_data.main(["--out", data, "--dataset-name", "mag", "--n-docs", str(n_docs),
                              "--seed", str(seed)])
        write_bert_dir(bert, load_corpus(data, "mag"), seed + 9)
        create_sparse_index.main(["--data-path", data, "--dataset-name", "mag",
                                  "--output-path", idx])
        precompute_sparse_scores.main(["--data-path", data, "--dataset-name", "mag",
                                       "--corpus-path", data, "--output-path", scores,
                                       "--index-path", idx])
        secs["inputs"] = time.perf_counter() - t
        check(len([f for f in os.listdir(scores) if f.endswith("_bm25.npy")]) == 2 * 6,
              f"precompute_sparse_scores wrote {sorted(os.listdir(scores))}")
        common = ["--dataset-name", "mag", "--data", data, "--field-names", fields,
                  "--lexical-index", idx, "--model-name", bert, "--device", DEVICE]
        reset_counts()
        t = time.perf_counter()
        train_cmd.main([*common, "--out", out, "--weights-lr", "0.1", "--sparse-scores-path",
                        scores, "--run-one-iteration", "--max-epochs", "1"])
        secs["train"] = time.perf_counter() - t
        check(counts() == (0, 0, 0), f"the train command (attention 'xla') launched {counts()}")
        check(os.path.exists(os.path.join(out, "checkpoints/0/state.pt")),
              "the hybrid train command wrote no checkpoint")
        t = time.perf_counter()
        mask_fields.main([*common, "--out", abl, "--checkpoint-dir", out])
        secs["mask_fields"] = time.perf_counter() - t
        with open(os.path.join(abl, "results_dicts.jsonl")) as f:
            records = [json.loads(line) for line in f]
        want = 1 + n_fields + 2 + n_fields // 2
        check(len(records) == want, f"mask_fields wrote {len(records)} records, want {want}")
        check(all(0.0 <= float(r["ndcg_cut_10"]) <= 1.0 for r in records), "a metric out of range")
        by_mask = {r["masked_fields"]: float(r["ndcg_cut_10"]) for r in records}
        run = os.path.join(d, "test.qres")
        gather_per_field_scores.launches = 0
        t = time.perf_counter()
        retrieve_cmd.main([*common, "--out", run, "--partition", "test", "--checkpoint-dir", out,
                           "--mode", "rerank"])
        secs["retrieve"] = time.perf_counter() - t
        launches = gather_per_field_scores.launches
        check(launches > 0, "retrieve --mode rerank launched K1 no time")
        by_query = collections.Counter(r.query_id for r in trec.QRes.from_file(run))
        check(len(by_query) == 15 and set(by_query.values()) == {100},
              f"retrieve wrote {dict(by_query)}")
        # the serve command: --smoke-out POSTs test.queries to the daemon over
        # HTTP; its answers == the same engine's
        smoke = {}
        for mode in ("rerank", "exact"):
            out_json = os.path.join(d, f"smoke_{mode}.json")
            argv = [*common, "--checkpoint-dir", out, "--mode", mode, "--port", "0",
                    "--top-k", "100", "--max-batch", "64", "--smoke-out", out_json]
            gather_per_field_scores.launches = 0
            t = time.perf_counter()
            serve_cmd.main(argv)
            secs[f"serve_{mode}"] = time.perf_counter() - t
            smoke[mode] = gather_per_field_scores.launches
            with open(out_json) as f:
                got = json.load(f)
            engine = build_engine(serve_cmd.build_parser().parse_args(argv), label="serve")
            queries = trec.read_queries(os.path.join(data, "test.queries"))
            want = engine.retrieve_many([queries[q] for q in got["qids"]], top_k=100)
            msg = rankings_agree(hits_of(got["results"]), want, E2E_RTOL, E2E_ATOL)
            check(msg is None, f"serve --smoke-out --mode {mode} vs the engine: {msg}")
            check(got["stats"]["errors"] == 0 and got["stats"]["queries"] == len(got["qids"]),
                  f"serve --smoke-out stats {got['stats']}")
        check(smoke["rerank"] > 0, "serve --mode rerank launched K1 no time")
        check(smoke["exact"] == 0, "serve --mode exact launched K1")
    sparse_key = ",".join(k for k in resolve_fields(fields, "mag") if k.endswith("_sparse"))
    dense_key = ",".join(k for k in resolve_fields(fields, "mag") if k.endswith("_dense"))
    phase("hybrid_cli", f"{n_docs}-doc mag dataset from make_synth_data, BERT directory at "
                        f"Contriever-base width: inputs (data, BERT dir, BM25 index, "
                        f"precomputed scores) {secs['inputs']:.1f}s; train {fields} "
                        f"--sparse-scores-path --run-one-iteration {secs['train']:.1f}s; "
                        f"mask_fields {secs['mask_fields']:.1f}s ({len(records)} configurations; "
                        f"ndcg@10 baseline {by_mask['']:.3f}, all sparse masked "
                        f"{by_mask[sparse_key]:.3f}, all dense masked {by_mask[dense_key]:.3f}); "
                        f"retrieve --lexical-index --checkpoint-dir --mode rerank "
                        f"{secs['retrieve']:.1f}s, K1 launches {launches}, 100 hits for each "
                        f"of {len(by_query)} queries; serve --smoke-out --mode rerank "
                        f"{secs['serve_rerank']:.1f}s (K1 launches {smoke['rerank']}), --mode "
                        f"exact {secs['serve_exact']:.1f}s, both == the engine")
    return dict(hybrid_cli_s=secs, hybrid_cli_k1_launches=launches,
                hybrid_cli_serve_k1_launches=smoke["rerank"])


# ----------------------------------------------------------------------
# phase 16: the T5/GTR family at GTR-T5-base width

# The bf16 index build against an f32 build of the same weights: bf16
# activations through 12 pre-LN layers whose residual stream stays in bf16
# (one ulp is 2**-8 relative), per embedding row.
GTR_MIN_COSINE = 0.99
# The grafted seq2seq's bf16 logits against f32 ones, per (row, position),
# through 12 encoder and 12 decoder layers.
SEQ2SEQ_MIN_COSINE = 0.99


def write_gtr_dir(root, corpus, cfg, seed) -> tuple:
    """A local sentence-transformers GTR directory under ``root`` at the
    relative path of its hub id, ``sentence-transformers/gtr-t5-base``:
    seeded weights of ``cfg`` and a Unigram vocab of the corpus's most
    common words.  Returns its path and the words."""
    counts = collections.Counter(
        w for t in corpus_texts_for_vocab(corpus, resolve_fields("all_dense", "mag"))
        for w in t.lower().split())
    words = [w for w, _ in counts.most_common(cfg.vocab_size - 40)]  # after 40 fixed pieces
    path = os.path.join(root, "sentence-transformers", "gtr-t5-base")
    save_gtr_dir(path, cfg, init_t5_encoder(cfg, seed=seed).state_dict(), words)
    return path, words


def run_gtr(seed, corpus, queries, cfg=None, n_cli_docs=512, batch_size=64, epochs=2,
            steps=8, batch=16, n_check=256) -> dict:
    """The T5/GTR family through the port's entry points at GTR-T5-base's
    published widths (``T5Config.gtr_base``: d_model 768, 12 layers, 12
    heads, d_kv 64, d_ff 3072, vocab 32128, 32 buckets, max distance 128,
    relu, a 768 -> 768 projection without bias) with seeded weights, written
    as a local sentence-transformers directory and loaded by
    ``prepare_model``: (a) the e2e corpus's bf16 index, a subset held
    against an f32 build; (b) rerank (K1) and exact serving against
    references; (c) ``serve --smoke-out``; (d) Trainer.fit with Adafactor
    and remat, a checkpoint round trip; (e) the train and retrieve
    commands; (f) a seq2seq grafted from a seeded local T5-base directory.
    T5 attention is the plain product (as in JAX), so K2 never runs."""
    cfg = cfg or T5Config.gtr_base()
    rng = np.random.default_rng(seed + 30)
    pairs = list(corpus.pairs())
    field_info = resolve_fields("all_dense", "mag")
    secs, out = {}, {}
    with tempfile.TemporaryDirectory() as d:
        t = time.perf_counter()
        gtr, words = write_gtr_dir(d, corpus, cfg, seed + 31)
        secs["write"] = time.perf_counter() - t
        t = time.perf_counter()
        config, state, tok = prepare_model(gtr)
        secs["load"] = time.perf_counter() - t
        check(dataclasses.replace(config, dtype=cfg.dtype, dropout=cfg.dropout) == cfg
              and config.dtype == torch.bfloat16, f"prepare_model gave {config}")
        encoder = build_encoder(config)
        encoder.load_state_dict(state)
        encode = make_encode_fn(encoder, device=DEVICE)
        warm = tok.encode_batch(["w1 w2"] * 256, 512, bucket=False)
        encode(warm["input_ids"], warm["attention_mask"])
        torch.cuda.synchronize()

        # (a) the index build, counted, then again for its spread
        flash_attention.launches = gather_per_field_scores.launches = 0
        matrix, build_s = timed_build(encode, tok, corpus, field_info)
        check(flash_attention.launches == 0 and gather_per_field_scores.launches == 0,
              "the T5 index build launched K2 or K1")
        builds = [build_s, timed_build(encode, tok, corpus, field_info)[1]]
        check(matrix.shape == (len(pairs), len(field_info), cfg.projection_dim)
              and bool(np.isfinite(matrix).all()), f"matrix {matrix.shape}")
        enc32 = build_encoder(dataclasses.replace(config, dtype=torch.float32))
        enc32.load_state_dict(state)
        sub = Corpus.from_pairs(pairs[:n_check], dataset_name="mag")
        want, f32_s = timed_build(make_encode_fn(enc32, device=DEVICE), tok, sub, field_info)
        del enc32
        a = torch.from_numpy(np.asarray(matrix[:n_check])).reshape(-1, matrix.shape[-1]).double()
        b = torch.from_numpy(np.asarray(want)).reshape(-1, want.shape[-1]).double()
        cos = ((a * b).sum(1) / (a.norm(dim=1) * b.norm(dim=1))).min().item()
        check(cos >= GTR_MIN_COSINE, f"bf16 build vs f32 build: min row cosine {cos:.6f}")
        field = next(f for f in field_info.values() if f.max_seq_length == 512)
        texts = [t for _, t in format_documents(pairs[:256], field.name, field.dataset)]
        toks = tok.encode_batch(texts, field.max_seq_length, bucket=False)
        prof = device_profile(lambda: encode(toks["input_ids"], toks["attention_mask"]), top=6)
        n_seq = len(pairs) * len(field_info)
        phase("gtr", f"seeded GTR-T5-base directory (d_model {cfg.d_model} x {cfg.num_layers} "
                     f"layers, {cfg.num_heads} heads x d_kv {cfg.d_kv}, d_ff {cfg.d_ff}, vocab "
                     f"{cfg.vocab_size}, projection {cfg.projection_dim}; Unigram vocab "
                     f"{tok.vocab_size}) written in {secs['write']:.1f}s, loaded by "
                     f"prepare_model in {secs['load']:.1f}s; index build of {len(pairs)} docs x "
                     f"{len(field_info)} fields in bf16 {builds[0]:.2f}s / {builds[1]:.2f}s "
                     f"({n_seq / builds[0]:.0f} / {n_seq / builds[1]:.0f} field-docs/s), no K2 "
                     f"launched; {n_check} docs in f32 {f32_s:.2f}s, against the bf16 rows: min "
                     f"cosine {cos:.6f} (bound {GTR_MIN_COSINE}); one build batch [256, 512] "
                     f"({field.name}): wall {prof['wall_ms']:.2f} ms, device busy "
                     f"{prof['device_ms']:.2f} ms; device ms by kernel: {prof['top']} ({CARD})")
        out.update(gtr_build_s=builds, gtr_f32_check_s=f32_s, gtr_min_cosine=cos,
                   gtr_build_batch_device_ms=prof["device_ms"])

        # (b) rerank through K1 and exact, each against a reference
        mixer = {"weight": rng.normal(scale=0.05, size=(cfg.projection_dim, len(field_info)))
                 .astype(np.float32)}
        kw = dict(field_info=field_info, doc_keys=list(corpus.keys()), encode_fn=encode,
                  tokenizer=tok, mixer_params=mixer, dense_matrix=matrix, recall_k=100,
                  dense_dtype=torch.bfloat16, device=DEVICE)
        engine = RetrievalEngine(mode="rerank", **kw)
        engine.retrieve(queries[:batch_size], top_k=100)  # warm-up
        gather_per_field_scores.launches = 0
        rerank, rerank_s = timed_run(engine, queries, "rerank", batch_size)
        k1 = gather_per_field_scores.launches
        check(k1 > 0 and engine.last_serve_path == "singlechip-rerank-k1",
              f"GTR rerank: K1 launches {k1}, path {engine.last_serve_path}")
        exact, exact_s = timed_run(engine, queries, "exact", batch_size)
        check(engine.last_serve_path == "singlechip-dense", f"path {engine.last_serve_path}")
        k = min(100, len(pairs))
        for got in (rerank, exact):
            check_results(got, len(queries), k)
        plain = RetrievalEngine(mode="rerank", use_pallas_gather=False, **kw)
        msg = rankings_agree(rerank, plain.retrieve_many(queries, top_k=100,
                                                         batch_size=batch_size),
                             E2E_RTOL, E2E_ATOL)
        check(msg is None, f"GTR rerank K1 vs the plain gather: {msg}")
        msg = rankings_agree(exact, brute_force_exact(engine, queries, mixer, k),
                             E2E_RTOL, E2E_ATOL)
        check(msg is None, f"GTR exact vs brute force: {msg}")
        del plain
        phase("gtr", f"{len(queries)} queries, batch {batch_size}: rerank "
                     f"{len(queries) / rerank_s:.1f} QPS (K1 launches {k1}) == the plain "
                     f"gather; exact {len(queries) / exact_s:.1f} QPS == brute force (rtol "
                     f"{E2E_RTOL}, atol {E2E_ATOL}) ({CARD})")
        out.update(gtr_rerank_qps=len(queries) / rerank_s, gtr_exact_qps=len(queries) / exact_s,
                   gtr_k1_launches=k1)

        # (c) the serve command over the GTR directory
        sub_pairs = pairs[:n_cli_docs]
        splits = dict(zip(("train", "val", "test"), mag_splits(sub_pairs, (32, 16, 16), rng)))
        data = os.path.join(d, "data")
        write_data_dir(data, sub_pairs, splits)
        common = ["--dataset-name", "mag", "--data", data, "--model-name", gtr,
                  "--device", DEVICE]
        out_json = os.path.join(d, "smoke.json")
        argv = [*common, "--mode", "rerank", "--port", "0", "--top-k", "100", "--max-batch",
                "64", "--smoke-out", out_json]
        gather_per_field_scores.launches = 0
        t = time.perf_counter()
        serve_cmd.main(argv)
        secs["serve"] = time.perf_counter() - t
        serve_k1 = gather_per_field_scores.launches
        check(serve_k1 > 0, "serve --mode rerank over the GTR directory launched K1 no time")
        with open(out_json) as f:
            got = json.load(f)
        cli_engine = build_engine(serve_cmd.build_parser().parse_args(argv), label="serve")
        test_q = trec.read_queries(os.path.join(data, "test.queries"))
        msg = rankings_agree(hits_of(got["results"]),
                             cli_engine.retrieve_many([test_q[q] for q in got["qids"]],
                                                      top_k=100), E2E_RTOL, E2E_ATOL)
        check(msg is None and got["stats"]["errors"] == 0,
              f"serve --smoke-out over the GTR directory: {msg} {got['stats']}")
        del cli_engine
        out.update(gtr_serve_k1_launches=serve_k1)

        # (d) Trainer.fit with Adafactor and remat, the main path of training
        (train_q, train_r), (val_q, val_r) = mag_splits(pairs, (steps * batch, 2 * batch), rng)
        sampler = IndexNegativeSampler(load_negative_sampler_index(corpus, None, "mag"),
                                       100, 50, 1)
        train_ds, val_ds = (ContrastiveDataset(q, corpus, r, sampler, field_info, tok)
                            for q, r in ((train_q, train_r), (val_q, val_r)))
        tcfg = dataclasses.replace(config, remat=True)
        opt = make_optimizer(encoder_lr=1e-4, weights_lr=0.1, use_adafactor=True)

        def fresh(s):
            st = init_state(MFARModel(tcfg, num_fields=len(field_info), temperature=0.05), opt,
                            seed=s, device=DEVICE)
            st.model.encoder.load_state_dict(state)
            return st

        tstate = fresh(seed)
        run_dir = os.path.join(d, "fit")
        trainer = Trainer(tok, field_info, corpus, train_ds, val_ds, val_q,
                          os.path.join(d, "val.qrels"),
                          TrainerConfig(out_dir=run_dir, max_epochs=epochs,
                                        train_batch_size=batch, seed=seed,
                                        query_max_length=512))
        trec.write_qrels(os.path.join(d, "val.qrels"), val_r)
        torch.cuda.synchronize()
        reset_counts()
        t = time.perf_counter()
        tstate = trainer.fit(tstate)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t
        n_steps = tstate.step
        check(counts() == (0, 0, 0), f"T5 training launched K2/K2b {counts()}")
        check(n_steps == epochs * steps, f"fit ran {n_steps} steps")
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            log = [json.loads(ln) for ln in f if '"train_loss"' in ln]
        losses, valid = [r["train_loss"] for r in log], [r["valid_loss"] for r in log]
        check(all(math.isfinite(x) for x in losses + valid), f"losses {losses} {valid}")

        one = to_device(strip_meta(next(train_ds.epoch_batches(batch, seed=seed))),
                        torch.device(DEVICE))
        restored = trainer.ckpt.restore(trainer.ckpt.latest_step(), fresh(seed + 1))
        for (name, x), y in zip(tstate.model.state_dict().items(),
                                restored.model.state_dict().values()):
            check(torch.equal(x, y), f"restored {name} differs")
        check(optimizer_states_equal(tstate.optimizer.state_dict(),
                                     restored.optimizer.state_dict()),
              "the restored Adafactor/AdamW state differs")
        _, m_a = train_step(tstate, one)
        _, m_b = train_step(restored, one)
        step_diff = max((x - y).abs().max().item() for x, y in
                        zip(tstate.model.parameters(), restored.model.parameters()))
        loss_diff = abs(m_a["loss"].item() - m_b["loss"].item())
        check(loss_diff <= CKPT_ATOL and step_diff <= CKPT_ATOL,
              f"a step after restore differs: loss by {loss_diff}, parameters by {step_diff}")
        del restored

        real = sum(token_stats(strip_meta(b))["tokens_real"]
                   for b in train_ds.epoch_batches(batch, seed=seed))
        rates, peaks = [], []
        for _ in range(2):
            secs_ep, _, peak = timed_epoch(trainer, tstate, 0)
            rates.append((steps / secs_ep, real / secs_ep))
            peaks.append(peak)
        tprof = device_profile(lambda: train_step(tstate, one), top=8)
        phase("gtr", f"(d) MFARModel over the GTR encoder ({tcfg.dtype}, dropout "
                     f"{tcfg.dropout}, remat), Adafactor on the encoder (lr 1e-4) and AdamW on "
                     f"the head: Trainer.fit {n_steps} steps in {epochs} epochs of "
                     f"{steps} (batch {batch}, one BM25 negative) in {fit_s:.1f}s with "
                     f"validation and checkpoints; train loss by epoch {losses}, valid loss "
                     f"{valid}; no K2/K2b launched; epochs of {steps} steps: "
                     f"{rates[0][0]:.3f} / {rates[1][0]:.3f} steps/s ({rates[0][1]:.0f} / "
                     f"{rates[1][1]:.0f} real tokens/s), peak memory {peaks[0]:.2f} / "
                     f"{peaks[1]:.2f} GB; one profiled step: wall {tprof['wall_ms']:.2f} ms, "
                     f"device busy {tprof['device_ms']:.2f} ms (share {tprof['busy_share']}); "
                     f"device ms by kernel: {tprof['top']}; checkpoint round trip: state and "
                     f"optimizer equal, a step after it vs without: loss by {loss_diff:.3g}, "
                     f"parameters by {step_diff:.3g} (tolerance {CKPT_ATOL}) ({CARD})")
        out.update(gtr_fit_s=fit_s, gtr_train_losses=losses, gtr_valid_losses=valid,
                   gtr_steps_per_s=[r[0] for r in rates],
                   gtr_tokens_per_s=[r[1] for r in rates], gtr_train_peak_gb=peaks,
                   gtr_train_step_device_ms=tprof["device_ms"],
                   gtr_train_busy_share=tprof["busy_share"])
        del tstate, trainer

        # (e) the train command on the GTR directory, then retrieve from it
        run_out = os.path.join(d, "out")
        t = time.perf_counter()
        train_cmd.main([*common, "--out", run_out, "--lexical-index", os.path.join(d, "idx"),
                        "--weights-lr", "0.1", "--run-one-iteration", "--max-epochs", "1"])
        secs["train_cli"] = time.perf_counter() - t
        payload = torch.load(os.path.join(run_out, "checkpoints", "0", "state.pt"),
                             map_location="cpu", weights_only=True)
        check(set(payload["optimizer"]) == {"encoder", "head"},
              "the train command's checkpoint holds no Adafactor state")
        run = os.path.join(d, "test.qres")
        gather_per_field_scores.launches = 0
        t = time.perf_counter()
        retrieve_cmd.main([*common, "--out", run, "--partition", "test", "--checkpoint-dir",
                           run_out, "--mode", "rerank"])
        secs["retrieve"] = time.perf_counter() - t
        cli_k1 = gather_per_field_scores.launches
        by_query = collections.Counter(r.query_id for r in trec.QRes.from_file(run))
        check(cli_k1 > 0 and set(by_query) == set(splits["test"][0])
              and set(by_query.values()) == {min(100, len(sub_pairs))},
              f"retrieve --checkpoint-dir: K1 launches {cli_k1}, hits {dict(by_query)}")
        out.update(gtr_cli_k1_launches=cli_k1)

        # (f) the seq2seq graft over a seeded local T5-base directory
        t5cfg = dataclasses.replace(cfg, projection_dim=None)
        t = time.perf_counter()
        t5 = init_t5_seq2seq(T5Seq2SeqConfig(encoder=t5cfg, decoder=t5cfg), seed=seed + 32)
        dec_state = t5.decoder.state_dict()
        dec_state["token_embed.weight"] = t5.encoder.token_embed.weight.detach()  # v1.0 ties them
        save_t5_dir(os.path.join(d, "google-t5", "t5-base"), t5cfg, t5.encoder.state_dict(),
                    words, decoder_state=dec_state)
        del t5, dec_state
        cwd = os.getcwd()
        os.chdir(d)  # the graft resolves the hub ids' names as local directories
        try:
            *_, (s2s_cfg, s2s_state) = prepare_model("sentence-transformers/gtr-t5-base",
                                                     with_decoder=True)
        finally:
            os.chdir(cwd)
        secs["seq2seq_setup"] = time.perf_counter() - t
        qtoks = tok.encode_batch(queries[:16], 512)
        dec_ids = torch.randint(0, cfg.vocab_size, (16, 32),
                                generator=torch.Generator().manual_seed(seed))
        logits = {}
        for dt in (torch.bfloat16, torch.float32):
            model = T5Seq2Seq(dataclasses.replace(
                s2s_cfg, encoder=dataclasses.replace(s2s_cfg.encoder, dtype=dt),
                decoder=dataclasses.replace(s2s_cfg.decoder, dtype=dt)))
            model.load_state_dict(s2s_state)
            model = model.to(DEVICE).eval()
            with torch.inference_mode():
                logits[dt] = model(torch.from_numpy(qtoks["input_ids"]).long().to(DEVICE),
                                   torch.from_numpy(qtoks["attention_mask"]).to(DEVICE),
                                   dec_ids.to(DEVICE)).float().cpu()
            del model
        lb, lf = logits[torch.bfloat16], logits[torch.float32]
        check(lb.shape == (16, 32, cfg.vocab_size) and bool(torch.isfinite(lb).all()),
              f"seq2seq logits {tuple(lb.shape)}")
        s2s_cos = torch.nn.functional.cosine_similarity(
            lb.reshape(-1, lb.shape[-1]).double(), lf.reshape(-1, lf.shape[-1]).double(),
            dim=-1).min().item()
        check(s2s_cos >= SEQ2SEQ_MIN_COSINE, f"seq2seq bf16 vs f32 logits: cosine {s2s_cos}")
        out.update(gtr_seq2seq_min_cosine=s2s_cos)
    phase("gtr", f"(c) serve --smoke-out over the GTR directory ({n_cli_docs} docs) in "
                 f"{secs['serve']:.1f}s, K1 launches {serve_k1}, == the same engine; (e) train "
                 f"--model-name <GTR dir> --run-one-iteration {secs['train_cli']:.1f}s "
                 f"(Adafactor state in its checkpoint), retrieve --checkpoint-dir --mode rerank "
                 f"{secs['retrieve']:.1f}s, K1 launches {cli_k1}, {min(100, n_cli_docs)} hits for each of "
                 f"{len(by_query)} queries; (f) seq2seq grafted from a seeded local T5-base "
                 f"directory (written and grafted in {secs['seq2seq_setup']:.1f}s): "
                 f"teacher-forced logits [16, 32, {cfg.vocab_size}] finite, bf16 against f32 "
                 f"min cosine {s2s_cos:.6f} (bound {SEQ2SEQ_MIN_COSINE}) ({CARD})")
    out["gtr_cli_s"] = secs
    return out


# ----------------------------------------------------------------------
# phases 18-20: the serving daemon, the int8 corpus, the host-streamed corpus

# The load generator of the serve phase, run in a child process so that its
# 64 client threads do not share the server's interpreter lock (after
# benchmarks/exp_server.py): each client keeps one HTTP/1.1 connection and
# sends one request of 8 queries of 8 words drawn from a 5000-word
# vocabulary (benchmarks/synth_engine.py:54-56), waits, and repeats until the
# run's seconds are up.  A failed request ends the client and fails the run.
SERVE_CLIENTS = r"""
import http.client, json, sys, threading, time
import numpy as np
host, port, n_clients, seconds, per_req, seed, n_sample = sys.argv[1:8]
port, n_clients, per_req, seed, n_sample = map(int, (port, n_clients, per_req, seed, n_sample))
words = np.array([f"w{i}" for i in range(5000)])
stop = threading.Event()
counts, lats, samples, errors = [0] * n_clients, [[] for _ in range(n_clients)], [], []

def client(ci):
    rng = np.random.default_rng(seed * 1000 + ci)
    conn = http.client.HTTPConnection(host, port, timeout=300)
    try:
        while not stop.is_set():
            qs = [" ".join(words[rng.integers(0, 5000, size=8)]) for _ in range(per_req)]
            t1 = time.perf_counter()
            conn.request("POST", "/retrieve", json.dumps({"queries": qs, "top_k": 100}),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            body = json.loads(resp.read())
            if resp.status != 200:
                raise RuntimeError(f"HTTP {resp.status}: {body}")
            lats[ci].append(time.perf_counter() - t1)
            if counts[ci] == 0 and ci < n_sample:
                samples.append({"queries": qs, "results": body["results"]})
            counts[ci] += per_req
    except Exception as e:
        errors.append(f"client {ci}: {type(e).__name__}: {e}")
    finally:
        conn.close()

threads = [threading.Thread(target=client, args=(i,), daemon=True) for i in range(n_clients)]
t0 = time.perf_counter()
for t in threads:
    t.start()
time.sleep(float(seconds))
stop.set()
for t in threads:
    t.join(timeout=300)
elapsed = time.perf_counter() - t0
lat = np.concatenate([np.asarray(x) for x in lats if x]) if any(lats) else np.zeros(1)
print(json.dumps({"queries": sum(counts), "requests": int(lat.size), "seconds": elapsed,
                  "p50_ms": float(np.percentile(lat, 50)) * 1e3,
                  "p95_ms": float(np.percentile(lat, 95)) * 1e3,
                  "errors": errors, "alive": sum(t.is_alive() for t in threads),
                  "samples": samples}))
"""


def word_queries(n, rng, words=8, vocab=5000):
    """Queries of ``words`` words drawn from the first ``vocab`` words of
    the e2e corpus's vocabulary, as the serve phase's clients draw them."""
    return [" ".join(f"w{i}" for i in rng.integers(0, vocab, size=words)) for _ in range(n)]


def hits_of(results):
    """JSON [[key, score], ...] lists -> the engine's [(key, score), ...]."""
    return [[(k, s) for k, s in hits] for hits in results]


def score_drift(want, got) -> float:
    """The largest relative difference of a document's score between two
    answers to the same queries, over the documents both lists of a query
    hold."""
    worst = 0.0
    for a, b in zip(want, got):
        b = dict(b)
        worst = max([worst] + [abs(s - b[k]) / max(abs(b[k]), 1e-30) for k, s in a if k in b])
    return worst


def ranked_keys(answers):
    return [[k for k, _ in hits] for hits in answers]


def answer_drift(retrieve, qs, n=8, sizes=None) -> dict:
    """How far ``n`` queries' answers move with the batch they share and
    from one run to the next.  ``retrieve(texts)`` gives the engine's
    [(key, score), ...] lists.  Batch drift: the first ``n`` of ``qs``
    alone against the same queries first in batches of ``sizes`` (every
    multiple of ``n`` from 2n to len(qs) by default) and last in one of
    len(qs); run drift: all of ``qs`` retrieved twice.  Each gives the
    largest relative score difference over the documents both lists hold,
    the batches (or whether the runs) whose ranked top-100 keys differ, and
    whether every answer is the same bits.  Where answers move, the first
    operator whose outputs move is named (:func:`first_moved_op` on the
    ``retrieve`` call): for the run drift on the whole batch twice, for the
    batch drift on the ``n`` queries alone and first in the smallest batch
    that moved, unless the runs moved too (then the run names it: the
    inputs of a batch lie in another layout, such as postings padded to
    the batch's longest, which that comparison cannot tell from a move)."""
    t = time.perf_counter()
    sizes = list(sizes or range(2 * n, len(qs) + 1, n))
    alone = retrieve(qs[:n])
    by_size = {size: retrieve(qs[:size])[:n] for size in sizes}
    by_size["last"] = retrieve(qs[n:] + qs[:n])[-n:]
    first, second = retrieve(qs), retrieve(qs)
    rel = {size: score_drift(alone, got) for size, got in by_size.items()}
    moved = [size for size, got in by_size.items() if got != alone]
    out = dict(batch_max=max(rel.values()), batch_at=max(rel, key=rel.get), batch_moved=moved,
               batch_lists_differ=[size for size, got in by_size.items()
                                   if ranked_keys(got) != ranked_keys(alone)],
               batch_bits_equal=not moved, run_max=score_drift(first, second),
               run_lists_differ=ranked_keys(first) != ranked_keys(second),
               run_bits_equal=first == second, batch_first_moved_op=None,
               run_first_moved_op=None)
    if not out["run_bits_equal"]:
        out["run_first_moved_op"] = first_moved_op(retrieve, qs, qs, len(qs))
    elif [s for s in moved if s != "last"]:
        out["batch_first_moved_op"] = first_moved_op(
            retrieve, qs[:n], qs[:min(s for s in moved if s != "last")], n)
    out["seconds"] = time.perf_counter() - t
    return out


# drift checks that failed: held at the end of the run, so that one run
# reports every route's drift
DRIFT_FAULTS = []


def hold_drift(where, route, d) -> str:
    """Hold a route's drift (:func:`answer_drift`): its answers the same bits
    in every batch and in both runs; a failure is kept for the end of the
    run.  Returns the drift's line."""
    line = (f"{route}: batch drift {d['batch_max']:.3g} at {d['batch_at']} (bits "
            f"{'equal' if d['batch_bits_equal'] else 'moved at ' + str(d['batch_moved'])}; "
            f"top-100 lists differ at {d['batch_lists_differ']}), run drift {d['run_max']:.3g} "
            f"(bits {'equal' if d['run_bits_equal'] else 'moved'}; lists "
            f"{'differ' if d['run_lists_differ'] else 'alike'}); {d['seconds']:.1f} s")
    for kind in ("batch", "run"):
        if d[f"{kind}_first_moved_op"] is not None:
            line += f"; {kind}: first moved op {d[f'{kind}_first_moved_op']}"
    if not (d["batch_bits_equal"] and d["run_bits_equal"]):
        DRIFT_FAULTS.append(f"{where} {route}: {line}")
    return line


def encoder_drift(engine, qs, n=8) -> dict:
    """Whether ``engine.encode_queries`` gives the first ``n`` of ``qs``
    other bits alone than inside batches of 2n, 3n, ... len(qs) queries and
    last in one of len(qs) (``encoder_moved``), and, as the control that
    shows what the check catches, the batches at which the encoder itself
    does when called on the batch's own row count (``rows_moved``, how the
    engine encoded before it fixed the row count of a call), with the first
    operator whose rows change there (``first_moved_op``)."""
    sizes = list(range(2 * n, len(qs) + 1, n))

    def rows_encoded(texts):
        return engine.tokenizer.encode_batch([clean_query(q) for q in texts],
                                             engine.query_max_length)

    def encode(toks):
        return engine.encode_fn(toks["input_ids"], toks["attention_mask"])

    with torch.inference_mode():
        enc = engine.encode_queries(qs[:n])
        batched = {size: engine.encode_queries(qs[:size])[:n] for size in sizes}
        batched["last"] = engine.encode_queries(qs[n:] + qs[:n])[-n:]
        encoder_moved = [size for size, e in batched.items() if not torch.equal(e, enc)]
        small = rows_encoded(qs[:n])
        enc_rows = encode(small)
        rows_moved = [size for size in sizes
                      if not torch.equal(encode(rows_encoded(qs[:size]))[:n], enc_rows)]
    first_op = (first_moved_op(encode, small, rows_encoded(qs[:rows_moved[0]]), n)
                if rows_moved else None)
    return dict(encoder_moved=encoder_moved, rows_moved=rows_moved, first_moved_op=first_op)


def _tensors(out):
    return [t for t in (out if isinstance(out, (tuple, list)) else (out,))
            if isinstance(t, torch.Tensor)]


# operators whose outputs are uninitialised memory (a kernel written by hand
# fills them where no aten operator sees it)
UNINITIALISED_OPS = ("aten.empty", "aten.new_empty", "aten.empty_like", "aten.empty_strided")


def first_moved_op(run, small, big, rows) -> dict:
    """The first aten operator of ``run(x)`` (an encoder call, a retrieve)
    whose outputs for the ``rows`` queries of ``small`` differ when the same
    queries run at the head of ``big``: every operator's outputs of the
    ``small`` run are recorded, then the ``big`` run's are compared with
    them, both cut to the recorded shape in every dimension and to the
    first ``rows`` entries of dim 0 (the first queries sit first in dim 0
    and in the batch dim of a [F, B, c] stack, a [B * S, E] GEMM output
    holds the first query's tokens first, a candidate matrix holds a
    query's candidates first; past ``rows`` lie the padding rows of a
    fixed-shape call, which differ by design); views of earlier outputs
    and uninitialised outputs are not recorded.
    The inputs of that operator are the same in both runs, since every
    earlier output was.  With ``small`` equal to ``big`` it names the first
    operator whose outputs differ between two runs of one call, where the
    second run reproduces the move.  Replays that operator on both runs'
    inputs under ``torch.profiler`` and returns its name, its index among
    the run's outputs, both output shapes, the largest difference and the
    device kernels each replay launched."""
    from torch.profiler import ProfilerActivity, profile
    from torch.utils._python_dispatch import TorchDispatchMode

    class Trace(TorchDispatchMode):
        def __init__(self, ref=None, keep_at=None):
            super().__init__()
            self.ref, self.keep_at, self.seen, self.moved, self.kept = ref, keep_at, [], None, None

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            # a view's values are those of an output already recorded (and
            # under inference_mode a view does not say it is one)
            if func.is_view or str(func).startswith(UNINITIALISED_OPS):
                return out
            for t in _tensors(out):
                i = len(self.seen)
                self.seen.append(t.detach().clone() if self.ref is None else None)
                if i == self.keep_at:
                    self.kept = (func, args, kwargs)
                if self.ref is None or self.moved is not None or i >= len(self.ref):
                    continue
                want = self.ref[i]
                if t.dim() != want.dim() or any(g < w for g, w in zip(t.shape, want.shape)):
                    continue
                got = t[tuple(slice(0, w) for w in want.shape)] if t.dim() else t
                if t.dim():
                    got, want = got[:rows], want[:rows]
                if got.dtype == want.dtype and not torch.equal(got, want):
                    diff = (got.double() - want.double()).abs().max().item()
                    self.moved = dict(index=i, op=str(func), shape=list(t.shape),
                                      small_shape=list(want.shape), max_abs_diff=diff)
                    self.kept = (func, args, kwargs)
            return out

    def traced(x, mode):
        with torch.inference_mode(), mode:
            run(x)
        return mode

    # three traced runs whatever they find, so that the ranks of a mesh,
    # each comparing its own shard's operators, issue the same collectives
    ref = traced(small, Trace())
    moved = traced(big, Trace(ref=ref.seen))
    del ref
    at = moved.moved["index"] if moved.moved is not None else -1
    replays = {"big": moved.kept, "small": traced(small, Trace(keep_at=at)).kept}
    if moved.moved is None:
        return dict(op=None)
    out = dict(moved.moved)
    for name, kept in replays.items():
        if kept is None:
            continue
        func, args, kwargs = kept
        for _ in range(2):  # the first profiler window after a long pause may see no kernel
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof, torch.inference_mode():
                func(*args, **kwargs)
                torch.cuda.synchronize()
        out[f"{name}_kernels"] = sorted({e.name.split("(")[0][:100] for e in prof.events()
                                         if e.device_type.name == "CUDA"})
    return out


def served_batch_agrees(engine, batches, sample, mode) -> str:
    """Whether a sampled daemon answer is ``engine.retrieve`` on the whole
    batch the daemon served it in (the first recorded batch holding the
    request's queries in order): what tells a daemon that mixes up its
    batches from an engine whose scores depend on the batch."""
    qs = sample["queries"]
    for texts in batches:
        at = next((i for i in range(len(texts) - len(qs) + 1)
                   if texts[i:i + len(qs)] == qs), None)
        if at is not None:
            want = engine.retrieve(texts, top_k=100, mode=mode)[at:at + len(qs)]
            same = hits_of(sample["results"]) == [[(k, s) for k, s in w] for w in want]
            return (f"served in a batch of {len(texts)} queries at row {at}: the answer "
                    f"{'==' if same else '!='} engine.retrieve on that batch")
    return f"no recorded batch of the {len(batches)} holds the request"


def drive_daemon(engine, mode, depth, seed, seconds, max_batch=256, clients=64, per_req=8,
                 n_sample=8) -> dict:
    """One daemon run: warmup with the port closed, then ``clients``
    closed-loop HTTP clients in a child process for ``seconds``; the sampled
    responses are held against ``engine.retrieve`` on the same queries, and
    K1's launches are counted from just before the clients start to just
    after they stop.  The batches the daemon dispatches are recorded, so a
    sampled answer that disagrees is also held to ``engine.retrieve`` on
    the whole batch it was served in (reported in the failure)."""
    batches = []

    def recorded(texts, *args, **kw):
        batches.append(list(texts))
        return type(engine).dispatch(engine, texts, *args, **kw)

    engine.dispatch = recorded
    srv = RetrievalServer(engine, port=0, max_batch=max_batch, max_wait_ms=5.0, top_k=100,
                          mode=mode, pipeline_depth=depth)
    try:
        warm_s = srv.warmup()
        check(srv.port is None and srv.httpd.socket.getsockname()[1] == 0,
              "the port was bound before warmup ended")
        check(srv.batcher.stats()["requests"] == 0, "the daemon answered during warmup")
        srv.start_background()
        gather_per_field_scores.launches = 0
        proc = subprocess.run(
            [sys.executable, "-c", SERVE_CLIENTS, srv.host, str(srv.port), str(clients),
             str(seconds), str(per_req), str(seed), str(n_sample)],
            capture_output=True, text=True, timeout=seconds + 300)
        launches = gather_per_field_scores.launches
        stats = srv.batcher.stats()
    finally:
        srv.shutdown()
        del engine.dispatch
    check(proc.returncode == 0, f"the clients exited {proc.returncode}: {proc.stderr[-2000:]}")
    load = json.loads(proc.stdout.strip().splitlines()[-1])
    check(not load["errors"] and not load["alive"], f"clients failed: {load['errors'][:3]}")
    check(stats["errors"] == 0 and stats["queries"] >= load["queries"], f"daemon stats {stats}")
    for sample in load["samples"]:
        want = engine.retrieve(sample["queries"], top_k=100, mode=mode)
        msg = rankings_agree(hits_of(sample["results"]), want, E2E_RTOL, E2E_ATOL)
        if msg is not None:
            msg += "; " + served_batch_agrees(engine, batches, sample, mode)
        check(msg is None, f"daemon {mode} depth {depth} vs engine.retrieve: {msg}")
    return dict(qps=load["queries"] / load["seconds"], p50_ms=load["p50_ms"],
                p95_ms=load["p95_ms"], fill=stats.get("mean_batch_fill"),
                phase_s=stats["phase_s"], k1_launches=launches, warmup_s=warm_s,
                requests=load["requests"],
                sampled=sum(len(x["queries"]) for x in load["samples"]))


# the serve phase's drift query sets: offsets from the run's seed; at seed 0
# they are the query sets of runs at seeds 0, 2 and 3 (seed + 23), where the
# daemon check failed while the engine encoded each batch at its own row
# count
SERVE_DRIFT_OFFSETS = (23, 25, 26)
# a request's scores alone against inside any batch: a tenth of the daemon
# check's rtol, so that the check's margin is not spent on the batch
SERVE_DRIFT_RTOL = E2E_RTOL / 10
# the batches of the drift of a route whose batch of 256 takes seconds (the
# host-streamed scans, hybrid rerank's host BM25 stage) or whose scoring
# code a route drifted at every batch also runs (K1x's and the plain
# gather's stage 1 and mix, the int8, host and mesh twins of a sum), so
# that the checks add about a minute to a run
FEW_DRIFT_SIZES = (16, 24, 64, 256)


def route_drift(where, route, engine, mode, qs, sizes=None) -> dict:
    """:func:`answer_drift` of ``engine.retrieve`` in ``mode`` on ``qs``,
    whose route must be ``route``; prints it and holds it
    (:func:`hold_drift`)."""
    d = answer_drift(lambda texts: engine.retrieve(texts, top_k=100, mode=mode), qs,
                     sizes=sizes)
    check(engine.last_serve_path == route, f"{where} drift: path {engine.last_serve_path}, "
                                           f"want {route}")
    phase(where, f"drift of 8 queries alone vs first in batches of "
                 f"{list(sizes) if sizes else '16-' + str(len(qs))} and last in one of "
                 f"{len(qs)}, and of {len(qs)} queries run twice: "
                 f"{hold_drift(where, route, d)} ({CARD})")
    return d


def sample_queries(engine, pool, n, seed) -> list:
    """Up to ``n`` queries of ``pool`` in a seeded order, all of the bucket
    width most of them take: a batch's queries encode at its widest
    query's width, as in the JAX engine, so a query's answer depends on
    how wide its batch-mates are, which the drift does not measure."""
    width = [engine.tokenizer.encode_batch([clean_query(q)], engine.query_max_length)
             ["input_ids"].shape[1] for q in pool]
    common = collections.Counter(width).most_common(1)[0][0]
    order = np.random.default_rng(seed).permutation(len(pool))
    return [pool[i] for i in order if width[i] == common][:n]


def run_serve(seed, engine, n=1048576, seconds=10.0) -> dict:
    """The daemon over a random bf16 [1048576, 5, 768] corpus made on the
    card (benchmarks/exp_server.py's workload: max_batch 256, max_wait_ms 5,
    top_k 100, 64 closed-loop clients of 8 queries; its 20 s runs cut to
    ``seconds``): first how far a request's exact answers move with the
    batch it shares and from run to run (answer_drift and encoder_drift at
    three query sets, a check: the encoded queries' bits must not move, the
    scores not past SERVE_DRIFT_RTOL, and every answer must be the same
    bits), then the same drift of rerank through K1, K1x and the plain
    gather at one query set, then exact at pipeline depth 2, 1 and 2, then
    rerank through K1 at depth 2.  Returns the engine for the int8 and
    host_stream phases."""
    fd, e = len(engine.dense_keys), engine.emb_dim
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 21)
    t = time.perf_counter()
    matrix = torch.randn(n, fd * e, device=DEVICE, generator=gen, dtype=torch.bfloat16)
    kw = dict(field_info=engine.field_info, doc_keys=[f"doc{i}" for i in range(n)],
              encode_fn=engine.encode_fn, tokenizer=engine.tokenizer,
              mixer_params=engine.mixer_params, recall_k=100, device=DEVICE)
    big = RetrievalEngine(dense_matrix=matrix, **kw)
    del matrix
    torch.cuda.synchronize()
    make_s = time.perf_counter() - t
    drifts = {}
    for offset in SERVE_DRIFT_OFFSETS:
        qs = word_queries(256, np.random.default_rng(seed + offset))
        enc = encoder_drift(big, qs)
        drift = answer_drift(lambda texts: big.retrieve(texts, top_k=100), qs)
        drifts[seed + offset] = dict(drift, **enc)
        phase("serve", f"drift at query seed {seed + offset}: 8 queries' exact answers alone "
                       f"vs inside batches of 16-256 queries and last in one of 256, and 256 "
                       f"queries run twice: {hold_drift('serve', big.last_serve_path, drift)} "
                       f"(bound {SERVE_DRIFT_RTOL}, a tenth of the daemon check's rtol "
                       f"{E2E_RTOL}); batches that changed the bits of engine.encode_queries: "
                       f"{enc['encoder_moved']}; the encoder called on each batch's own row "
                       f"count changes them at {enc['rows_moved']}, first at "
                       f"{enc['first_moved_op']} ({CARD})")
        check(not enc["encoder_moved"] and drift["batch_max"] <= SERVE_DRIFT_RTOL,
              f"query seed {seed + offset}: a query's encoding or scores depend on its batch: "
              f"{drifts[seed + offset]}")
    qs = word_queries(256, np.random.default_rng(seed + SERVE_DRIFT_OFFSETS[0]))
    for route, flags, sizes in (("singlechip-rerank-k1", {}, None),
                                ("singlechip-rerank-k1x", dict(pallas_cross_row=True),
                                 FEW_DRIFT_SIZES),
                                ("singlechip-rerank-plain", dict(use_pallas_gather=False),
                                 FEW_DRIFT_SIZES)):
        eng = RetrievalEngine(dense_matrix=big.docs_flat, **flags, **kw)  # the same rows
        drifts[route] = route_drift("serve", route, eng, "rerank", qs, sizes)
        del eng
    runs = []
    for i, (mode, depth) in enumerate((("exact", 2), ("exact", 1), ("exact", 2),
                                       ("rerank", 2))):
        r = drive_daemon(big, mode, depth, seed + i, seconds)
        want_path = "singlechip-dense" if mode == "exact" else "singlechip-rerank-k1"
        check(big.last_serve_path == want_path, f"daemon path {big.last_serve_path}")
        if mode == "rerank":
            check(r["k1_launches"] > 0, "the daemon's rerank launched K1 no time")
        else:
            check(r["k1_launches"] == 0, "the daemon's exact mode launched K1")
        runs.append(dict(r, mode=mode, depth=depth))
        phase("serve", f"{mode}, pipeline depth {depth}: {r['qps']:.1f} QPS, request latency "
                       f"p50 {r['p50_ms']:.2f} ms p95 {r['p95_ms']:.2f} ms, mean batch fill "
                       f"{r['fill']}, phase_s {r['phase_s']}, K1 launches {r['k1_launches']}, "
                       f"{r['requests']} requests, warmup {r['warmup_s']:.2f}s; "
                       f"{r['sampled']} sampled queries == engine.retrieve ({CARD})")
    phase("serve", f"N={n} bf16 [{n}, {fd * e}] corpus made on the card in {make_s:.2f}s "
                   f"({big.docs_flat.nbytes / 1e9:.2f} GB); max_batch 256, max_wait_ms 5, "
                   f"top_k 100, 64 closed-loop clients x 8 queries of 8 words (5000-word "
                   f"vocabulary) in a child process, {seconds:.0f} s a run (cut from "
                   f"benchmarks/exp_server.py's 20 s); order exact d2, d1, d2, rerank d2")
    return big, dict(serve_runs=[{k: v for k, v in r.items() if k != "phase_s"} for r in runs],
                     serve_k1_launches=runs[-1]["k1_launches"], serve_drift=drifts)


# int8_dot's shapes: a 1-query batch, row counts off a multiple of 8 (the
# tail product), a serving batch against a chunk and a depth off 8
INT8_DOT_SHAPES = ((1, 3840, 1000), (7, 3840, 1003), (256, 3840, 131077), (5, 100, 61))


def quantize_reference(x):
    """Per-row int8 quantization written out here, not through the port's
    helpers: absmax / 127, round half to even, clip to 127; the values stay
    in ``x``'s float dtype, with the [rows] scales."""
    scale = torch.clamp(x.abs().amax(1, keepdim=True), min=1e-12) / 127.0
    return torch.clamp(torch.round(x / scale), -127, 127), scale[:, 0]


def folded_queries(engine, queries):
    """The engine's folded f32 queries written out (softmax field weights
    of the encoded queries, each weight times the query), the queries
    encoded as one batch, as the engine encodes them."""
    w_mix = torch.as_tensor(engine.mixer_params["weight"], dtype=torch.float32, device=DEVICE)
    with torch.inference_mode():
        q = engine.encode_queries(queries)
        w = torch.softmax(q @ w_mix, dim=-1)
        return (w[:, :, None] * q[:, None, :]).reshape(q.shape[0], -1)


def int8_reference(engine, queries, matrix, k=100):
    """Brute-force int8 retrieval written out here, not through the port's
    scoring helpers: folded f32 queries and the corpus rows quantized per
    row (:func:`quantize_reference`), their integer dots summed in f64
    (exact: every partial sum is an integer below 2**53), rounded to f32 and
    times the two scales in the JAX package's order."""
    d8, ds = quantize_reference(matrix.float())
    check(torch.equal(d8.to(torch.int8), engine.docs_q), "the engine's int8 rows differ")
    check(torch.equal(ds, engine.doc_scales), "the engine's row scales differ")
    d8 = d8.double()
    qf = folded_queries(engine, queries)
    with torch.inference_mode():
        q8, qs = quantize_reference(qf)
        scores = (q8.double() @ d8.T).float() * qs[:, None] * ds[None, :]
        top_s, top_i = torch.topk(scores, k, dim=-1)
    return engine._to_keyed(top_s.cpu().numpy(), top_i.cpu().numpy())


def overlap(a, b) -> float:
    """Mean share of one result list's keys found in the other's, per query."""
    return float(np.mean([len({k for k, _ in x} & {k for k, _ in y}) / max(len(y), 1)
                          for x, y in zip(a, b)]))


def run_int8(seed, big, e2e_engine, e2e_queries, n_queries=1024, batch=256,
             slice_rows=131072) -> dict:
    """The serve phase's corpus quantized on the card; exact serving in bf16
    and int8 in turns, recall@100 of int8 against bf16, the int8 scores of
    a slice against a brute-force reference, ``_int_mm``'s padding at a
    1-query batch and at row counts off a multiple of 8, and int8 rerank on
    the e2e corpus."""
    rng = np.random.default_rng(seed + 31)
    qs = word_queries(n_queries, rng)
    kw = dict(field_info=big.field_info, encode_fn=big.encode_fn, tokenizer=big.tokenizer,
              mixer_params=big.mixer_params, recall_k=100, device=DEVICE)
    torch.cuda.synchronize()
    t = time.perf_counter()
    i8 = RetrievalEngine(doc_keys=big.doc_keys, dense_matrix=big.docs_flat, quantize="int8",
                         **kw)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t
    bf16_bytes = big.docs_flat.nbytes
    i8_bytes = i8.docs_q.nbytes + i8.doc_scales.nbytes
    for eng in (big, i8):
        eng.retrieve(qs[:batch], top_k=100)  # warm-up
    gather_per_field_scores.launches = 0
    qps, results = {"bf16": [], "int8": []}, {}
    for label, eng in (("bf16", big), ("int8", i8), ("int8", i8), ("bf16", big)):
        out, secs = timed_run(eng, qs, "exact", batch)
        qps[label].append(n_queries / secs)
        results[label] = out
    check(i8.last_serve_path == "singlechip-int8-dense", f"path {i8.last_serve_path}")
    check(gather_per_field_scores.launches == 0, "exact serving launched K1")
    check_results(results["int8"], n_queries, 100)
    recall = overlap(results["int8"], results["bf16"])

    small = RetrievalEngine(doc_keys=big.doc_keys[:slice_rows],
                            dense_matrix=big.docs_flat[:slice_rows], quantize="int8", **kw)
    got = small.retrieve_many(qs[:batch], top_k=100, batch_size=batch)
    ref = int8_reference(small, qs[:batch], big.docs_flat[:slice_rows])
    msg = rankings_agree(got, ref, 1e-6, 0.0)
    check(msg is None, f"int8 scores vs the brute-force int8 reference: {msg}")
    del small

    gen = torch.Generator(device=DEVICE).manual_seed(seed + 32)
    shapes = INT8_DOT_SHAPES
    for m, depth, c in shapes:
        a = torch.randint(-127, 128, (m, depth), device=DEVICE, generator=gen, dtype=torch.int8)
        b = torch.randint(-127, 128, (c, depth), device=DEVICE, generator=gen, dtype=torch.int8)
        got_dot = int8_dot(a, b)
        want_dot = (a.double() @ b.double().T).to(torch.int32)  # exact: below 2**53
        check(got_dot.dtype == torch.int32 and torch.equal(got_dot, want_dot),
              f"int8_dot [{m}, {depth}] x [{c}, {depth}] is not the exact product")

    e2e_kw = dict(field_info=e2e_engine.field_info, doc_keys=e2e_engine.doc_keys,
                  encode_fn=e2e_engine.encode_fn, tokenizer=e2e_engine.tokenizer,
                  mixer_params=e2e_engine.mixer_params, recall_k=100, device=DEVICE)
    rr8 = RetrievalEngine(dense_matrix=e2e_engine.docs_flat, quantize="int8", mode="rerank",
                          **e2e_kw)
    gather_per_field_scores.launches = 0
    rerank8 = rr8.retrieve_many(e2e_queries, top_k=100, batch_size=64)
    check(rr8.last_serve_path == "singlechip-rerank-int8", f"path {rr8.last_serve_path}")
    check(gather_per_field_scores.launches == 0, "int8 rerank launched K1")
    check_results(rerank8, len(e2e_queries), 100)
    rerank_recall = overlap(rerank8, e2e_engine.retrieve_many(e2e_queries, top_k=100,
                                                             mode="rerank", batch_size=64))
    dq = word_queries(256, np.random.default_rng(seed + SERVE_DRIFT_OFFSETS[0]))
    drifts = {route: route_drift("int8", route, eng, mode, dq, FEW_DRIFT_SIZES)
              for route, eng, mode in (("singlechip-int8-dense", i8, "exact"),
                                       ("singlechip-rerank-int8", rr8, "rerank"))}
    phase("int8", f"N={big.n_docs} corpus quantized on the card in {quant_s:.2f}s: "
                  f"{i8_bytes / 1e9:.3f} GB int8 + scales against {bf16_bytes / 1e9:.3f} GB "
                  f"bf16; exact, {n_queries} queries of 8 words, batch {batch}, order bf16, "
                  f"int8, int8, bf16: bf16 {qps['bf16'][0]:.1f} / {qps['bf16'][1]:.1f} QPS, "
                  f"int8 {qps['int8'][0]:.1f} / {qps['int8'][1]:.1f} QPS; recall@100 of int8 "
                  f"against bf16 {recall:.4f} (not gated); {slice_rows}-row slice == "
                  f"brute-force int8 (exact integer dots; rtol 1e-6, ties allowed); int8_dot exact at "
                  f"{list(shapes)}; e2e rerank through int8 (path "
                  f"{rr8.last_serve_path}) shares {rerank_recall:.4f} of bf16 rerank's "
                  f"top-100 ({CARD})")
    return i8, dict(int8_quantize_s=quant_s, int8_bytes=i8_bytes, bf16_bytes=bf16_bytes,
                    int8_qps=qps["int8"], bf16_qps=qps["bf16"], int8_recall_at_100=recall,
                    int8_rerank_overlap=rerank_recall, int8_drift=drifts)


def mem_available_bytes() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def run_host_stream(seed, big, i8, n_queries=1024, batch=256) -> dict:
    """The serve phase's corpus copied once to host memory and streamed to
    the card per scan, in bf16 (cast once into pinned memory) and int8
    (quantized on the card into pinned memory): QPS, chunks a scan, the
    achieved copy rate against one plain pinned copy of a chunk's bytes,
    device memory over the encoder's working set, and results against the
    device-resident engines on the same corpus."""
    rng = np.random.default_rng(seed + 41)
    qs = word_queries(n_queries, rng)
    row_bytes = big.docs_flat[0].nbytes
    n = big.n_docs
    avail = mem_available_bytes()
    cut = ""
    if avail < 3 * n * row_bytes:
        n = max(HOST_STREAM_CHUNK, (avail // (3 * row_bytes)) // 65536 * 65536)
        cut = f" (cut from {big.n_docs} rows: MemAvailable {avail / 1e9:.1f} GB < 3x corpus)"
    kw = dict(field_info=big.field_info, doc_keys=big.doc_keys[:n], encode_fn=big.encode_fn,
              tokenizer=big.tokenizer, mixer_params=big.mixer_params, recall_k=100,
              device=DEVICE)
    t = time.perf_counter()
    host = big.docs_flat[:n].cpu()  # the corpus, copied once to host memory
    hs = RetrievalEngine(dense_matrix=host, corpus_on_host=True, **kw)
    del host
    place_s = time.perf_counter() - t
    t = time.perf_counter()
    hs8 = RetrievalEngine(dense_matrix=big.docs_flat[:n], corpus_on_host=True, quantize="int8",
                          **kw)
    place8_s = time.perf_counter() - t
    check(hs.docs_host.is_pinned() and hs8.docs_host_q.is_pinned(), "host corpus not pinned")
    chunks = math.ceil(n / HOST_STREAM_CHUNK)

    # one plain pinned copy of a bf16 chunk's bytes: the yardstick
    pinned = torch.empty(HOST_STREAM_CHUNK, big.docs_flat.shape[1], dtype=torch.bfloat16,
                         pin_memory=True)
    dev = torch.empty(pinned.shape, dtype=pinned.dtype, device=DEVICE)
    copy_ms = time_cuda(lambda: dev.copy_(pinned, non_blocking=True), reps=5, inner=3, warmup=1)
    yard_gbs = pinned.nbytes / copy_ms / 1e6
    del pinned, dev

    rates, qps, out = {}, {}, {}
    for label, eng, nbytes in (("bf16", hs, n * row_bytes), ("int8", hs8, n * row_bytes // 2)):
        eng.retrieve(qs[:batch], top_k=100)  # warm-up
        res, secs = timed_run(eng, qs, "exact", batch)
        check_results(res, n_queries, 100)
        qps[label] = n_queries / secs
        rates[label] = nbytes * math.ceil(n_queries / batch) / secs / 1e9
        out[label] = res
    check(hs.last_serve_path == "host-stream-dense", f"path {hs.last_serve_path}")
    check(hs8.last_serve_path == "host-stream-dense-int8", f"path {hs8.last_serve_path}")

    # device memory of one streamed batch over the encoder's own working set
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    hs.encode_queries(qs[:batch])
    torch.cuda.synchronize()
    enc_bytes = torch.cuda.max_memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    hs.retrieve(qs[:batch], top_k=100)
    torch.cuda.synchronize()
    stream_bytes = torch.cuda.max_memory_allocated() - base
    chunk_bytes = HOST_STREAM_CHUNK * row_bytes
    check(stream_bytes - enc_bytes < 3 * chunk_bytes,
          f"a streamed batch held {(stream_bytes - enc_bytes) / 1e9:.2f} GB over the encoder, "
          f"more than 3 chunk buffers ({3 * chunk_bytes / 1e9:.2f} GB)")

    # the device-resident engines on the same corpus: f32 rows of the same
    # bf16 values (the in-RAM stream multiplies f32 queries by them), and
    # the int8 phase's engine
    # (every batch of the timed runs: batches in flight together must not
    # share chunk buffers)
    f32 = RetrievalEngine(dense_matrix=big.docs_flat[:n], dense_dtype=torch.float32, **kw)
    msg = rankings_agree(out["bf16"], f32.retrieve_many(qs, top_k=100, batch_size=batch),
                         E2E_RTOL, E2E_ATOL)
    check(msg is None, f"host-stream bf16 vs the device-resident engine: {msg}")
    del f32
    ref8 = i8 if n == big.n_docs else RetrievalEngine(
        dense_matrix=big.docs_flat[:n], quantize="int8", **kw)
    msg = rankings_agree(out["int8"], ref8.retrieve_many(qs, top_k=100, batch_size=batch),
                         E2E_RTOL, E2E_ATOL)
    check(msg is None, f"host-stream int8 vs the device-resident int8 engine: {msg}")
    dq = word_queries(256, np.random.default_rng(seed + SERVE_DRIFT_OFFSETS[0]))
    drifts = {route: route_drift("host_stream", route, eng, "exact", dq, FEW_DRIFT_SIZES)
              for route, eng in (("host-stream-dense", hs), ("host-stream-dense-int8", hs8))}
    phase("host_stream", f"N={n}{cut} in host memory: bf16 {n * row_bytes / 1e9:.2f} GB cast "
                         f"into pinned memory in {place_s:.2f}s, int8 quantized on the card "
                         f"into pinned memory in {place8_s:.2f}s; {chunks} chunks of "
                         f"{HOST_STREAM_CHUNK} rows a scan; exact, {n_queries} queries, batch "
                         f"{batch}: bf16 {qps['bf16']:.1f} QPS ({rates['bf16']:.2f} GB/s "
                         f"streamed), int8 {qps['int8']:.1f} QPS ({rates['int8']:.2f} GB/s); "
                         f"one pinned copy of a chunk's bytes {copy_ms:.2f} ms = "
                         f"{yard_gbs:.2f} GB/s; a streamed batch held "
                         f"{(stream_bytes - enc_bytes) / 1e9:.2f} GB over the encoder's "
                         f"{enc_bytes / 1e9:.2f} GB (chunk buffer {chunk_bytes / 1e9:.2f} GB); "
                         f"every batch == the device-resident engines (rtol {E2E_RTOL}, atol "
                         f"{E2E_ATOL}) ({CARD})")
    return dict(host_stream_rows=n, host_stream_qps=qps, host_stream_gbs=rates,
                host_stream_yardstick_gbs=yard_gbs, host_stream_chunks=chunks,
                host_stream_extra_gb=(stream_bytes - enc_bytes) / 1e9,
                host_stream_drift=drifts)


# ----------------------------------------------------------------------
# phase 17: serving over several ranks (torch.distributed)

MESH_RANK_TIMEOUT_S = 600  # a rank that is not done by then fails the phase
# a mesh rerank against one device's at recall_k 100 (2047 docs over two
# ranks in (b), 1048576 rows over the cards in (c)): the share of top-100
# docs the two lists hold alike
MESH_RERANK_MIN_OVERLAP = 0.99
BIG_ROW_BLOCK = 65536  # the 1048576-doc corpus is made in seeded blocks of rows


class SeededRows:
    """A bf16 ``[n, width]`` corpus made on the card from a seed, block by
    block of ``BIG_ROW_BLOCK`` rows, so that any rank makes any rows alike:
    ``rows[a:b]`` makes only those rows (the engine's row block of a
    rank)."""

    ndim = 2

    def __init__(self, n, width, seed):
        self.shape = (n, width)
        self.seed = seed

    def __getitem__(self, sl):
        start, stop = sl.start or 0, min(sl.stop, self.shape[0])
        parts = []
        for b in range(start // BIG_ROW_BLOCK, -(-stop // BIG_ROW_BLOCK)):
            gen = torch.Generator(device=DEVICE).manual_seed(self.seed * 1000003 + b)
            block = torch.randn(BIG_ROW_BLOCK, self.shape[1], device=DEVICE, generator=gen,
                                dtype=torch.bfloat16)
            lo, hi = max(start - b * BIG_ROW_BLOCK, 0), min(stop - b * BIG_ROW_BLOCK,
                                                            BIG_ROW_BLOCK)
            parts.append(block[lo:hi])
        return torch.cat(parts) if parts else torch.empty(0, self.shape[1], device=DEVICE,
                                                          dtype=torch.bfloat16)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_ranks(argvs, envs, log_dir, label):
    """Start one process per argv, output to ``log_dir/<label><i>.log``."""
    procs = []
    for i, (argv, env) in enumerate(zip(argvs, envs)):
        log = open(os.path.join(log_dir, f"{label}{i}.log"), "w")
        procs.append((subprocess.Popen(argv, env=env, stdout=log, stderr=subprocess.STDOUT,
                                       cwd=os.path.dirname(os.path.abspath(__file__))), log))
    return procs


def _log_tail(log, n=3000) -> str:
    log.flush()
    with open(log.name) as f:
        return f.read()[-n:]


def stop_ranks(procs) -> None:
    for p, log in procs:
        if p.poll() is None:
            p.kill()
            p.wait(timeout=60)
        log.close()


def watch_ranks(procs, label, until=None, timeout=MESH_RANK_TIMEOUT_S):
    """Wait until every rank exits 0 (or ``until()`` is true, with the ranks
    still running); a rank that fails, or the timeout, kills every rank and
    fails the phase."""
    deadline = time.perf_counter() + timeout
    while True:
        codes = [p.poll() for p, _ in procs]
        failed = [i for i, c in enumerate(codes) if c not in (None, 0)]
        late = time.perf_counter() > deadline
        if failed or late:
            i = failed[0] if failed else 0
            tail = _log_tail(procs[i][1])
            stop_ranks(procs)
            check(False, f"{label}: rank {i} " + (f"exited {codes[i]}" if failed else
                         f"not done in {timeout} s") + f"; its log ends:\n{tail}")
        if until is None and all(c == 0 for c in codes):
            for _, log in procs:
                log.close()
            return
        if until is not None and until():
            return
        time.sleep(0.2)


def rank_env(coord, world, rank, **extra):
    env = {k: v for k, v in os.environ.items() if not k.startswith("MFAR_")}
    env.update(MFAR_COORDINATOR=coord, MFAR_NUM_PROCESSES=str(world),
               MFAR_PROCESS_ID=str(rank), OMP_NUM_THREADS="4", **extra)
    return env


def post_queries(host, port, batches, top_k=100):
    """POST each batch of queries from its own thread (so that the daemon
    coalesces them); returns the answers in order."""
    import http.client

    def one(qs):
        conn = http.client.HTTPConnection(host, port, timeout=300)
        try:
            conn.request("POST", "/retrieve", json.dumps({"queries": qs, "top_k": top_k}),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            body = json.loads(resp.read())
            check(resp.status == 200, f"/retrieve answered {resp.status}: {body}")
            return hits_of(body["results"])
        finally:
            conn.close()

    with concurrent.futures.ThreadPoolExecutor(len(batches)) as pool:
        return list(pool.map(one, batches))


class BatchRecorder:
    """Rank 0's engine under the daemon: each batch's queries and results,
    as the micro-batcher formed and delivered them."""

    def __init__(self, engine):
        self.engine, self.batches = engine, []

    n_docs = property(lambda self: self.engine.n_docs)
    device = property(lambda self: self.engine.device)

    def dispatch(self, queries, top_k=100, mode=None):
        return list(queries), self.engine.dispatch(queries, top_k=top_k, mode=mode)

    def finish(self, handle):
        queries, inner = handle
        results = self.engine.finish(inner)
        self.batches.append((queries, results))
        return results


def rank_daemon(engine, mesh, work, mode, max_batch) -> tuple:
    """The daemon over the ranks: rank 0 serves HTTP through
    ``MultihostEngineProxy`` (its address in ``work/daemon.json``) until
    ``work/stop`` appears, the others follow.  Then each HTTP answer the
    parent sampled (``work/samples.json``) is found in the batch rank 0's
    micro-batcher put it in and held against that batch's results, and
    every rank retrieves those batches again, in the same composition (a
    bf16 encoder rounds a query's rows by its batch's shape), to hold the
    daemon's batches against ``retrieve``.  Returns (stats, samples held)."""
    from mfar_tpu_torch.serve import MultihostEngineProxy, follower_loop

    stats, rerun_path = None, os.path.join(work, "rerun.json")
    if mesh.rank == 0:
        rec = BatchRecorder(engine)
        proxy = MultihostEngineProxy(rec, max_batch=max_batch)
        srv = RetrievalServer(proxy, port=0, max_batch=max_batch, max_wait_ms=5.0, top_k=100,
                              mode=mode, pipeline_depth=2)
        try:
            srv.warmup()
            srv.start_background()
            with open(os.path.join(work, "daemon.tmp"), "w") as f:
                json.dump({"host": srv.host, "port": srv.port}, f)
            os.replace(os.path.join(work, "daemon.tmp"), os.path.join(work, "daemon.json"))
            deadline = time.perf_counter() + MESH_RANK_TIMEOUT_S
            while not os.path.exists(os.path.join(work, "stop")):
                check(time.perf_counter() < deadline, "the parent never stopped the daemon")
                time.sleep(0.1)
            stats = srv.batcher.stats()
            srv.shutdown()
            with open(os.path.join(work, "samples.json")) as f:
                samples = json.load(f)
            found = []  # (batch index, offset) of each sample
            for smp in samples:
                qs = smp["queries"]
                at = [(b, o) for b, (bq, _) in enumerate(rec.batches)
                      for o in range(len(bq) - len(qs) + 1) if bq[o : o + len(qs)] == qs]
                check(len(at) >= 1, "a sampled request is in no batch of the daemon")
                b, o = at[0]
                msg = rankings_agree(hits_of(smp["results"]),
                                     rec.batches[b][1][o : o + len(qs)], 0.0, 0.0)
                check(msg is None, f"an HTTP answer differs from its batch's results: {msg}")
                found.append(b)
            rerun = sorted(set(found))
            with open(rerun_path, "w") as f:
                json.dump([rec.batches[b][0] for b in rerun], f)
        finally:
            srv.shutdown()
            proxy.stop()
    else:
        follower_loop(engine)
    with open(rerun_path) as f:
        batches = json.load(f)
    again = [engine.retrieve(qs, top_k=100, mode=mode) for qs in batches]
    if mesh.rank == 0:
        for b, res in zip(rerun, again):
            msg = rankings_agree(rec.batches[b][1], res, E2E_RTOL, E2E_ATOL)
            check(msg is None, f"a daemon batch vs retrieve on the same batch: {msg}")
        return stats, len(samples)
    return stats, None


def mesh_rank(spec_path: str) -> int:
    """One rank of the mesh or train_mesh phase, started with the
    ``MFAR_*`` triple: ``job`` "shared" is a gloo rank of mesh (b) sharing
    card 0, "cards" an NCCL rank of mesh (c) on its own card,
    "train_shared" and "train_cards" the same for train_mesh (a) and (b),
    "capacity" an NCCL rank of mesh_capacity.
    Writes what it measured to ``<work>/rank<R>.pt``."""
    import torch.distributed as dist

    from mfar_tpu_torch.parallel import multihost
    from mfar_tpu_torch.parallel.mesh import make_mesh

    global DEVICE
    spec = torch.load(spec_path, weights_only=False)
    DEVICE = spec["device"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(multihost.maybe_initialize("force", DEVICE), "the world did not start")
    # ranks that share a card run their collectives over gloo (NCCL
    # refuses two ranks on one card)
    mesh = make_mesh(backend="gloo" if spec["job"] in ("shared", "train_shared", "tp_shared")
                     else None)
    out = {"rank": mesh.rank, "world": dist.get_world_size(), "backend": mesh.backend,
           "card": torch.cuda.current_device()}
    jobs = {"shared": shared_rank, "cards": cards_rank, "train_shared": train_rank,
            "train_cards": train_rank, "tp_shared": tp_rank, "tp_cards": tp_rank,
            "capacity": capacity_rank}
    jobs[spec["job"]](spec, mesh, out)
    torch.save(out, os.path.join(spec["work"], f"rank{mesh.rank}.pt"))
    multihost.sync("mesh-rank-done")
    dist.destroy_process_group()
    return 0


def split_encode(encode, n_shards):
    """``encode`` over a batch in the calls a mesh of ``n_shards`` ranks
    makes (``make_encode_fn(mesh=)``: rank i encodes its share and the rows
    left over in one call): a one-device reference then rounds each query's
    bf16 activations as the ranks do, since a GEMM's algorithm follows its
    shape."""
    def run(input_ids, attention_mask):
        ids, mask = torch.as_tensor(input_ids), torch.as_tensor(attention_mask)
        n = ids.shape[0]
        per = n // n_shards
        if per == 0:
            return encode(ids, mask)
        tail = slice(n_shards * per, n)
        outs = [encode(torch.cat([ids[i * per : (i + 1) * per], ids[tail]]),
                       torch.cat([mask[i * per : (i + 1) * per], mask[tail]]))
                for i in range(n_shards)]
        return torch.cat([o[:per] for o in outs] + [outs[0][per:]])

    return run


# the corpus placements of the (a)/(b) mesh cases: on the cards in bf16
# (first: the daemon serves its hybrid engine) or int8, and in host memory
# in bf16 or int8
MESH_PLACEMENTS = (("", {}), ("int8 ", dict(quantize="int8")),
                   ("host ", dict(corpus_on_host=True)),
                   ("host int8 ", dict(corpus_on_host=True, quantize="int8")))


def mesh_routes(int8: bool, host: bool) -> tuple:
    """The routes of a mesh engine's dense exact, dense rerank, hybrid
    postings, hybrid combined and hybrid rerank, over a corpus on the cards
    or in host memory, int8 or not."""
    i8 = "-int8" if int8 else ""
    if host:
        rows = "int8" if int8 else "rows"
        return (f"host-stream-dense{i8}-mesh", f"host-stream-rerank-{rows}-mesh",
                f"host-stream-hybrid{i8}-mesh-postings", f"host-stream-hybrid{i8}-mesh-combined",
                f"host-stream-rerank-hybrid-{rows}-mesh")
    return (f"mesh{i8}-dense", f"mesh-rerank{i8}", f"mesh{i8}-hybrid-postings",
            f"mesh{i8}-hybrid-combined", f"mesh-rerank-hybrid{i8}")


def mesh_engines(spec, mesh, matrix, encode, plain_encode, n, recall_k=100):
    """The (a)/(b) cases on the first ``n`` docs, for each corpus placement
    of ``MESH_PLACEMENTS``: (name, mesh engine, its one-device twin with the
    same placement or None off rank 0, queries, mode, route)."""
    pairs = spec["pairs"][:n]
    sub = Corpus.from_pairs(pairs, dataset_name="mag")
    dense_fi = resolve_fields("all_dense", "mag")
    hybrid_fi = resolve_fields("all_dense,all_sparse", "mag")
    sparse = build_sparse_indices(sub, {k: f for k, f in hybrid_fi.items() if f.is_sparse})
    cases = []
    for label, placement in MESH_PLACEMENTS:
        routes = mesh_routes("quantize" in placement, "corpus_on_host" in placement)
        for fields, fi, mixer, idx in (("dense", dense_fi, spec["mixer_dense"], None),
                                       ("hybrid", hybrid_fi, spec["mixer_hybrid"], sparse)):
            kw = dict(field_info=fi, doc_keys=list(sub.keys()), tokenizer=spec["tok"],
                      mixer_params={"weight": mixer}, dense_matrix=matrix[:n],
                      sparse_indices=idx, recall_k=recall_k, dense_dtype=torch.bfloat16,
                      device=DEVICE, **placement)
            eng = RetrievalEngine(mesh=mesh, encode_fn=encode, **kw)
            ref = (RetrievalEngine(encode_fn=split_encode(plain_encode, mesh.size("data")), **kw)
                   if mesh.rank == 0 else None)
            if fields == "dense":
                cases += [(label + "dense exact", eng, ref, spec["queries"], "exact", routes[0]),
                          (label + "dense rerank", eng, ref, spec["queries"], "rerank",
                           routes[1])]
            else:
                cases += [(label + "hybrid postings", eng, ref, spec["rare"], "exact", routes[2]),
                          (label + "hybrid combined", eng, ref, spec["queries"], "exact",
                           routes[3]),
                          (label + "hybrid rerank", eng, ref, spec["rare"], "rerank",
                           routes[4])]
    return cases


def run_mesh_cases(cases, batch_size=64) -> dict:
    """Every case through its mesh engine (all ranks) and, where present,
    its one-device twin: {name: (mesh results, path, reference results)}."""
    out = {}
    for name, eng, ref, qs, mode, route in cases:
        got = eng.retrieve_many(qs, top_k=100, mode=mode, batch_size=batch_size)
        path = eng.last_serve_path
        want = ref.retrieve_many(qs, top_k=100, mode=mode, batch_size=batch_size) if ref else None
        out[name] = (got, path, route, want)
    return out


def hold_mesh_cases(results, label) -> None:
    for name, (got, path, route, want) in results.items():
        check(path == route, f"{label} {name}: path {path}, want {route}")
        msg = rankings_agree(got, want, E2E_RTOL, E2E_ATOL)
        check(msg is None, f"{label} {name} vs the one-device engine: {msg}")


def hold_rerank_overlap(got, want, label) -> float:
    """A mesh rerank at a recall boundary against one device's: a top-100
    overlap of at least ``MESH_RERANK_MIN_OVERLAP``, and the docs both lists
    hold scored alike.  Returns the overlap."""
    ov = overlap(got, want)
    check(ov >= MESH_RERANK_MIN_OVERLAP,
          f"{label}: top-100 overlap with one device {ov:.4f} < {MESH_RERANK_MIN_OVERLAP}")
    for g, w in zip(got, want):
        wd = dict(w)
        check(all(abs(s - wd[k]) <= E2E_ATOL + E2E_RTOL * abs(wd[k]) for k, s in g if k in wd),
              f"{label}: a shared doc's score differs from one device's")
    return ov


def shared_rank(spec, mesh, out) -> None:
    """(b): the index build split over the ranks through K2, the routes on
    a row count that does not divide 2, then the daemon."""
    tok, cfg = spec["tok"], spec["cfg"]
    encoder = init_encoder(cfg, seed=spec["seed"])
    encode = make_encode_fn(encoder, device=DEVICE, mesh=mesh)
    plain_encode = make_encode_fn(encoder, device=DEVICE)
    corpus = Corpus.from_pairs(spec["pairs"], dataset_name="mag")
    field_info = resolve_fields("all_dense", "mag")
    warm = tok.encode_batch(["w1 w2"] * 256, 512, bucket=False)
    encode(warm["input_ids"], warm["attention_mask"])  # cuBLAS, allocator, the gather
    flash_attention.launches = 0
    matrix, secs = timed_build(encode, tok, corpus, field_info)
    out.update(k2_launches=flash_attention.launches, build_s=secs)
    if mesh.rank == 0:
        out["matrix"] = matrix
    n = len(spec["pairs"]) - 1  # odd: the row blocks of 2 ranks have a padded tail
    # recall_k = n: every doc is a candidate.  The shards' recall scans are
    # other GEMM shapes than one device's, whose f32 sums round apart, so a
    # near-tie at a recall boundary could admit another candidate; with
    # every doc admitted, rerank is held to the one-device engine exactly
    cases = mesh_engines(spec, mesh, matrix, encode, plain_encode, n, recall_k=n)
    out["cases"] = run_mesh_cases(cases)
    # then recall_k 100, where the merge of the shards' per-field lists
    # chooses the candidates (held by overlap, as in (c))
    rerank = [c for c in cases if c[4] == "rerank"]
    for eng in {id(x): x for c in rerank for x in c[1:3] if x is not None}.values():
        eng.recall_k = 100
    out["recall_cases"] = run_mesh_cases(rerank)
    # every rank retrieves alike, so each takes the same decisions and
    # issues the same collectives
    drift_cases = {"dense exact", "dense rerank", "hybrid postings", "hybrid rerank"}
    out["drift"] = {
        route: answer_drift(lambda texts: eng.retrieve(texts, top_k=100, mode=mode),
                            sample_queries(eng, qs, 256, spec["seed"] + SERVE_DRIFT_OFFSETS[0]))
        for name, eng, _, qs, mode, route in cases if name in drift_cases}
    hybrid = cases[2][1]
    out["stats"], out["daemon_held"] = rank_daemon(hybrid, mesh, spec["work"], "exact", 64)
    out["daemon_path"] = hybrid.last_serve_path


def cards_rank(spec, mesh, out) -> None:
    """(c): exact and rerank QPS at batch 256 over the 1048576-doc corpus,
    each rank making only its own rows (rank 0 first serves the whole
    corpus on its card alone, the others waiting), then the daemon."""
    from mfar_tpu_torch.parallel import multihost

    tok, cfg = spec["tok"], spec["cfg"]
    encoder = init_encoder(cfg, seed=spec["seed"])
    fd, e = 5, cfg.hidden_size
    rows = SeededRows(spec["n_big"], fd * e, spec["seed"] + 31)
    kw = dict(field_info=resolve_fields("all_dense", "mag"),
              doc_keys=[f"doc{i}" for i in range(spec["n_big"])], tokenizer=tok,
              mixer_params={"weight": spec["mixer_dense"]}, recall_k=100, device=DEVICE)
    qs = spec["big_queries"]

    def qps(eng, mode):
        eng.retrieve_many(qs[:256], top_k=100, mode=mode, batch_size=256)  # warm-up
        multihost.sync("qps")
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = eng.retrieve_many(qs, top_k=100, mode=mode, batch_size=256)
        torch.cuda.synchronize()
        return len(qs) / (time.perf_counter() - t), res[:256]

    if mesh.rank == 0:
        plain = make_encode_fn(encoder, device=DEVICE)
        one = RetrievalEngine(dense_matrix=rows[0 : spec["n_big"]], encode_fn=plain, **kw)
        for mode in ("exact", "rerank"):
            one.encode_fn = plain
            one.retrieve_many(qs[:256], top_k=100, mode=mode, batch_size=256)
            torch.cuda.synchronize()
            t = time.perf_counter()
            one.retrieve_many(qs, top_k=100, mode=mode, batch_size=256)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
            # the reference for the ranks' first batch: its queries encoded
            # in the ranks' calls
            one.encode_fn = split_encode(plain, mesh.size("data"))
            ref = one.retrieve_many(qs[:256], top_k=100, mode=mode, batch_size=256)
            out[f"one_{mode}"] = (len(qs) / secs, ref)
        del one
        torch.cuda.empty_cache()
    multihost.sync("one-rank-done")
    torch.cuda.reset_peak_memory_stats()
    eng = RetrievalEngine(dense_matrix=rows, mesh=mesh,
                          encode_fn=make_encode_fn(encoder, device=DEVICE, mesh=mesh), **kw)
    out["shard_rows"] = eng.docs_flat.shape[0]
    for mode in ("exact", "rerank"):
        out[f"mesh_{mode}"] = (*qps(eng, mode), eng.last_serve_path)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["stats"], out["daemon_held"] = rank_daemon(eng, mesh, spec["work"], "exact", 256)


def run_ranks_job(job, spec, world, label, drive):
    """Start ``world`` ranks of chip_smoke's ``mesh_rank`` on ``job``; once
    rank 0's daemon is up, ``drive(host, port)`` sends its traffic and
    returns the sampled query batches; the ranks' outputs come back."""
    with tempfile.TemporaryDirectory() as work:
        spec = dict(spec, job=job, work=work)
        path = os.path.join(work, "spec.pt")
        torch.save(spec, path)
        coord = f"file://{os.path.join(work, 'init')}"
        me = os.path.abspath(__file__)
        # ranks that share a card see card 0 only
        extra = {"CUDA_VISIBLE_DEVICES": "0"} if job == "shared" else {}
        procs = start_ranks([[sys.executable, me, "--mesh-rank", path]] * world,
                            [rank_env(coord, world, r, **extra) for r in range(world)], work,
                            label)
        try:
            daemon = os.path.join(work, "daemon.json")
            watch_ranks(procs, label, until=lambda: os.path.exists(daemon))
            with open(daemon) as f:
                addr = json.load(f)
            samples, load = drive(addr["host"], addr["port"])
            with open(os.path.join(work, "samples.json"), "w") as f:
                json.dump(samples, f)
            open(os.path.join(work, "stop"), "w").close()
            watch_ranks(procs, label)
        finally:
            stop_ranks(procs)
        ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
                 for r in range(world)]
    check(ranks[0]["daemon_held"] == len(samples) > 0,
          f"{label}: {ranks[0]['daemon_held']} of {len(samples)} sampled answers held")
    return ranks, load


def run_mesh(seed, e2e=None, n_serve=131072) -> dict:
    """Serving over several ranks: (a) one NCCL rank in this process, (b) two
    gloo ranks sharing the card, (c) one NCCL rank per card where there are
    several.  ``e2e`` is the e2e phase's (engine, corpus, queries); without
    it the phase makes them itself."""
    import torch.distributed as dist

    from mfar_tpu_torch.parallel.mesh import make_mesh

    if e2e is None:
        e2e = mesh_world(seed)
    engine, corpus, queries = e2e
    spec = mesh_spec(seed, e2e)
    cfg, pairs = spec["cfg"], spec["pairs"]
    out = {}

    # (a) one NCCL rank: a world of 1 made here
    t = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1, rank=0)
    try:
        mesh = make_mesh()
        matrix = engine.docs_flat.view(engine.n_docs, len(engine.dense_keys), engine.emb_dim)
        cases = mesh_engines(spec, mesh, matrix, engine.encode_fn, engine.encode_fn,
                             engine.n_docs)
        hold_mesh_cases(run_mesh_cases(cases), "mesh (a)")
        fd, e = len(engine.dense_keys), engine.emb_dim
        gen = torch.Generator(device=DEVICE).manual_seed(seed + 1)
        big = torch.randn(n_serve, fd * e, device=DEVICE, generator=gen, dtype=torch.bfloat16)
        kw = dict(field_info=engine.field_info, doc_keys=[f"doc{i}" for i in range(n_serve)],
                  encode_fn=engine.encode_fn, tokenizer=engine.tokenizer,
                  mixer_params=engine.mixer_params, dense_matrix=big, recall_k=100,
                  device=DEVICE)
        big_mesh = RetrievalEngine(mesh=mesh, **kw)
        big_one = RetrievalEngine(**kw)
        del big
        qs = (queries * 2)[:256]
        serving = {}
        for mode, route in (("exact", "mesh-dense"), ("rerank", "mesh-rerank")):
            serving[f"{mode} [{n_serve}]"] = (
                big_mesh.retrieve_many(qs, top_k=100, mode=mode, batch_size=64),
                big_mesh.last_serve_path, route,
                big_one.retrieve_many(qs, top_k=100, mode=mode, batch_size=64))
        hold_mesh_cases(serving, "mesh (a)")
        del big_mesh, big_one
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    out["mesh_a_s"] = time.perf_counter() - t
    phase("mesh", f"(a) one NCCL rank (make_mesh over a world of 1): exact and rerank, dense "
                  f"and all_dense,all_sparse (postings, combined) on the e2e corpus, on the "
                  f"card in bf16 and int8 and in host memory in bf16 and int8, and the "
                  f"[{n_serve}, {fd}, {e}] bf16 corpus in exact and rerank, each == the one-device "
                  f"engine (rtol {E2E_RTOL}, atol {E2E_ATOL}, ties allowed) with its mesh-* "
                  f"path, in {out['mesh_a_s']:.1f}s")

    # (b) two gloo ranks sharing the card
    t = time.perf_counter()
    sample = [queries[i : i + 8] for i in range(0, min(64, len(queries)), 8)]

    def drive_b(host, port):
        # a burst of concurrent requests, which the daemon coalesces
        answers = post_queries(host, port, sample)
        for res in answers:
            check_results(res, 8, min(100, len(pairs) - 1))
        return [{"queries": qs, "results": res} for qs, res in zip(sample, answers)], None

    ranks, _ = run_ranks_job("shared", spec, 2, "mesh_b", drive_b)
    out["mesh_b_s"] = time.perf_counter() - t
    check([(r["backend"], r["card"]) for r in ranks] == [("gloo", 0)] * 2,
          f"(b) ranks' backends and cards {[(r['backend'], r['card']) for r in ranks]}")
    want = engine.docs_flat.float().view(engine.n_docs, -1, engine.emb_dim).cpu().numpy()
    agree = index_agreement(ranks[0]["matrix"], want, "the 2-rank K2 build vs the one-device one")
    k2 = [r["k2_launches"] for r in ranks]
    want_k2 = cfg.num_layers * sum(f.max_seq_length >= 128 and f.max_seq_length % 128 == 0
                                   for f in engine.field_info.values()) * math.ceil(
        engine.n_docs / 256)
    check(k2 == [want_k2] * 2, f"(b) K2 launches per rank {k2}, want each {want_k2}")
    hold_mesh_cases(ranks[0]["cases"], "mesh (b)")
    recall_overlap = {}
    for name, (got, path, route, want) in ranks[0]["recall_cases"].items():
        check(path == route, f"mesh (b) {name} at recall_k 100: path {path}, want {route}")
        recall_overlap[name] = hold_rerank_overlap(got, want, f"mesh (b) {name} at recall_k 100")
    for r in ranks[1:]:
        for key in ("cases", "recall_cases"):
            for name, (got, path, _, _) in r[key].items():
                check(got == ranks[0][key][name][0] and path == ranks[0][key][name][1],
                      f"(b) rank {r['rank']} {name} ({key}) differs from rank 0")
    for route, d in ranks[0]["drift"].items():
        # each rank traces its own shard and keeps its own clock
        same = [k for k in d if not k.endswith("first_moved_op") and k != "seconds"]
        check(all({k: r["drift"][route][k] for k in same} == {k: d[k] for k in same}
                  for r in ranks[1:]), f"(b) {route}: the ranks' answers drift apart")
        phase("mesh", f"(b) drift of 8 queries alone vs first in batches of 16 up to the "
                      f"query set's size and last in a full one, and of the full one run "
                      f"twice: {hold_drift('mesh (b)', route, d)} ({CARD})")
    check(ranks[0]["daemon_path"] == "mesh-hybrid-combined",
          f"(b) daemon path {ranks[0]['daemon_path']}")
    out.update(mesh_k2_launches=sum(k2), mesh_b_build_s=[r["build_s"] for r in ranks],
               mesh_b_stats=ranks[0]["stats"], mesh_b_recall100_overlap=recall_overlap,
               mesh_b_drift=ranks[0]["drift"])
    n_seq = len(pairs) * 5
    phase("mesh", f"(b) two gloo ranks on card 0 in {out['mesh_b_s']:.1f}s (process start "
                  f"included): the {len(pairs)}-doc build split over them through K2 in "
                  f"{ranks[0]['build_s']:.2f}s / {ranks[1]['build_s']:.2f}s "
                  f"({n_seq / max(r['build_s'] for r in ranks):.0f} field-docs/s), K2 launches "
                  f"{k2} (each rank's = the one-device build's), against the one-device K2 "
                  f"build: {agree}; dense and hybrid exact and rerank (recall_k = every doc) "
                  f"on {len(pairs) - 1} docs, on the card in bf16 and int8 and in host memory "
                  f"in bf16 and int8 ({len(ranks[0]['cases'])} cases) "
                  f"(row blocks of {len(pairs) // 2} and {len(pairs) // 2 - 1}) == the "
                  f"one-device engine of each placement, with the mesh-* and host-stream-*-mesh "
                  f"paths; rerank at recall_k 100: top-100 "
                  f"overlap with the one-device engine {recall_overlap} (>= "
                  f"{MESH_RERANK_MIN_OVERLAP}, shared docs' scores equal); "
                  f"rank 1 == rank 0; the daemon (rank 0 RetrievalServer over "
                  f"MultihostEngineProxy, rank 1 follower_loop): {len(sample)} concurrent "
                  f"requests of 8 queries, each answer == its batch's results == retrieve "
                  f"on that batch, stats {ranks[0]['stats']}")

    # (c) one NCCL rank per card
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        phase("mesh", f"(c) needs several cards; {n_cards} visible: skipped")
        return out
    out.update(run_mesh_cards(seed, spec, n_cards))
    return out


def mesh_spec(seed, e2e) -> dict:
    """What the ranks of the mesh phases read, from the e2e world: the
    encoder's config (Contriever-base, attention "auto"), the tokenizer,
    the corpus's pairs, its queries, 128 rare-word queries and a dense and
    a hybrid mixer."""
    engine, corpus, queries = e2e
    cfg = EncoderConfig.contriever_base(vocab_size=engine.tokenizer.vocab_size,
                                        attention_impl="auto")
    rng = np.random.default_rng(seed + 41)
    pairs = list(corpus.pairs())
    fi_h = resolve_fields("all_dense,all_sparse", "mag")
    return dict(seed=seed, device=DEVICE, cfg=cfg, tok=engine.tokenizer, pairs=pairs,
                queries=queries,
                rare=rare_word_queries(pairs, 128, rng, min_rank=5000),
                mixer_dense=np.asarray(engine.mixer_params["weight"], np.float32),
                mixer_hybrid=rng.normal(scale=0.05, size=(engine.emb_dim, len(fi_h)))
                .astype(np.float32))


def mesh_world(seed, n_docs=2048, n_queries=256):
    """The e2e phase's corpus, queries, tokenizer, K2 build and engine, for
    a run whose phases leave e2e out."""
    rng = np.random.default_rng(seed)
    corpus, queries = synth_mag(n_docs, n_queries, rng)
    field_info = resolve_fields("all_dense", "mag")
    texts = [t for _, p in corpus.pairs() for t in (p["title"], p["abstract"])]
    tok = SimpleVocabTokenizer.build(texts + queries, max_length=512)
    cfg = EncoderConfig.contriever_base(vocab_size=tok.vocab_size, attention_impl="auto")
    encode = make_encode_fn(init_encoder(cfg, seed=seed), device=DEVICE)
    matrix, _ = timed_build(encode, tok, corpus, field_info)
    mixer = {"weight": rng.normal(scale=0.05, size=(cfg.hidden_size, len(field_info)))
             .astype(np.float32)}
    engine = RetrievalEngine(field_info=field_info, doc_keys=list(corpus.keys()),
                             encode_fn=encode, tokenizer=tok, mixer_params=mixer,
                             dense_matrix=matrix, recall_k=100, dense_dtype=torch.bfloat16,
                             device=DEVICE)
    return engine, corpus, queries


def run_mesh_cards(seed, spec, n_cards, n_big=1048576, n_cli_docs=512) -> dict:
    """(c): the commands under several ranks against one card's, the QPS of
    the 1048576-doc corpus over the cards beside one card's, the daemon."""
    out = {}
    rng = np.random.default_rng(seed + 43)
    pairs = spec["pairs"][:n_cli_docs]
    sub = Corpus.from_pairs(pairs, dataset_name="mag")
    with tempfile.TemporaryDirectory() as d:
        data, bert = os.path.join(d, "data"), os.path.join(d, "bert")
        write_data_dir(data, pairs)
        with open(os.path.join(data, "test.queries"), "w", encoding="utf-8") as f:
            for i, q in enumerate(spec["queries"][:128]):
                f.write(f"q{i}\t{q}\n")
        write_bert_dir(bert, sub, seed + 4)
        base = ["--dataset-name", "mag", "--data", data, "--model-name", bert,
                "--device", DEVICE]
        t = time.perf_counter()
        encode_corpus.main([*base, "--out", os.path.join(d, "one.npz"), "--mesh", "off"])
        one_encode_s = time.perf_counter() - t
        # one card's batches are the ranks' shares of theirs (64 queries over
        # n_cards ranks), so that each bf16 query row is encoded in the same
        # GEMM shapes on both sides
        retrieve_cmd.main([*base, "--dense-index", os.path.join(d, "one.npz"), "--mesh", "off",
                           "--out", os.path.join(d, "one.qres"),
                           "--batch-size", str(64 // n_cards)])
        coord = f"127.0.0.1:{free_port()}"
        t = time.perf_counter()
        procs = start_ranks(
            [[sys.executable, "-m", "mfar_tpu_torch.commands.encode_corpus", *base,
              "--out", os.path.join(d, f"enc{r}.npz")] for r in range(n_cards)],
            [rank_env(coord, n_cards, r) for r in range(n_cards)], d, "encode")
        watch_ranks(procs, "encode_corpus over the cards")
        ranks_encode_s = time.perf_counter() - t
        check(not any(os.path.exists(os.path.join(d, f"enc{r}.npz")) for r in range(1, n_cards)),
              "a rank other than 0 wrote the encoded corpus")
        one, keys = load_dense_matrix(os.path.join(d, "one.npz"))
        many, keys2 = load_dense_matrix(os.path.join(d, "enc0.npz"))
        check(keys == keys2, "encode_corpus over the cards: keys differ")
        agree = index_agreement(many, one, "encode_corpus over the cards vs one card")
        torchrun = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
                    str(n_cards), "--master-port", str(free_port())]
        for cmd, extra in (
            ("retrieve", ["--out", os.path.join(d, "many.qres"), "--batch-size", "64"]),
            ("serve", ["--port", "0", "--max-batch", "64",
                       "--smoke-out", os.path.join(d, "smoke.json")]),
        ):
            env = {k: v for k, v in os.environ.items() if not k.startswith("MFAR_")}
            procs = start_ranks([[*torchrun, "-m", f"mfar_tpu_torch.commands.{cmd}", *base,
                                  "--dense-index", os.path.join(d, "one.npz"),
                                  "--multihost", "pod", *extra]], [env], d, cmd)
            watch_ranks(procs, f"{cmd} under torchrun")
        want = qres_lists(os.path.join(d, "one.qres"))
        got = qres_lists(os.path.join(d, "many.qres"))
        msg = rankings_agree([got[q] for q in want], [want[q] for q in want], E2E_RTOL, E2E_ATOL)
        check(got.keys() == want.keys() and msg is None, f"retrieve over the cards: {msg}")
        with open(os.path.join(d, "smoke.json")) as f:
            smoke = json.load(f)
        served = dict(zip(smoke["qids"], hits_of(smoke["results"])))
        msg = rankings_agree([served[q] for q in want], [want[q] for q in want], E2E_RTOL,
                             E2E_ATOL)
        check(served.keys() == want.keys() and msg is None, f"serve over the cards: {msg}")
    phase("mesh", f"(c) {n_cards} NCCL ranks, one a card: encode_corpus ({n_cli_docs} docs, "
                  f"MFAR_* triple) in {ranks_encode_s:.1f}s against one card's "
                  f"{one_encode_s:.1f}s (process start and model load included), == one "
                  f"card's file: {agree}; retrieve and serve --smoke-out under torchrun "
                  f"--multihost pod == one card's retrieve ({len(want)} queries) ({CARD})")

    big = dict(spec, n_big=n_big, big_queries=word_queries(2048, rng))

    def drive_c(host, port):
        proc = subprocess.run(
            [sys.executable, "-c", SERVE_CLIENTS, host, str(port), "64", "10", "8",
             str(seed), "8"], capture_output=True, text=True, timeout=400)
        check(proc.returncode == 0, f"the clients exited {proc.returncode}: {proc.stderr[-2000:]}")
        load = json.loads(proc.stdout.strip().splitlines()[-1])
        check(not load["errors"] and not load["alive"], f"clients failed: {load['errors'][:3]}")
        return [{"queries": s["queries"], "results": hits_of(s["results"])}
                for s in load["samples"]], load

    t = time.perf_counter()
    ranks, load = run_ranks_job("cards", big, n_cards, "mesh_c", drive_c)
    r0 = ranks[0]
    check(sorted(r["card"] for r in ranks) == list(range(n_cards)), "ranks share a card")
    for mode in ("exact", "rerank"):
        q_one, res_one = r0[f"one_{mode}"]
        q_mesh, res_mesh, path = r0[f"mesh_{mode}"]
        check(path == ("mesh-dense" if mode == "exact" else "mesh-rerank"), f"path {path}")
        if mode == "exact":
            msg = rankings_agree(res_mesh, res_one, E2E_RTOL, E2E_ATOL)
            check(msg is None, f"{mode} over {n_cards} cards vs one card: {msg}")
        else:
            # recall_k 100 of 1048576 rows: a near-tie at a recall boundary,
            # which the shards' GEMM shapes round apart from one device's,
            # can admit another candidate (held exactly on 2047 docs in (b))
            out["mesh_c_rerank_overlap"] = hold_rerank_overlap(
                res_mesh, res_one, f"rerank over {n_cards} cards")
        out[f"mesh_c_{mode}_qps"] = {"1": q_one, str(n_cards): q_mesh}
    stats = r0["stats"]
    out.update(mesh_c_daemon=dict(qps=load["queries"] / load["seconds"], p50_ms=load["p50_ms"],
                                  p95_ms=load["p95_ms"], fill=stats.get("mean_batch_fill"),
                                  requests=load["requests"]),
               mesh_c_s=time.perf_counter() - t)
    phase("mesh", f"(c) {n_big} docs bf16, batch 256, 2048 8-word queries: exact "
                  f"{out['mesh_c_exact_qps']} QPS and rerank {out['mesh_c_rerank_qps']} QPS "
                  f"(1 card, {n_cards} cards; each rank made only its {r0['shard_rows']} rows, "
                  f"peak {r0['peak_gb']:.2f} GB on rank 0), == one card; daemon over "
                  f"{n_cards} ranks (64 clients x 8 queries, 10 s, max_batch 256): "
                  f"{out['mesh_c_daemon']}, phase_s {stats['phase_s']}, {r0['daemon_held']} "
                  f"sampled answers == their batches' results == retrieve on those batches "
                  f"({CARD})")
    return out


# ----------------------------------------------------------------------
# phase 18: capacity over several cards (the int8 and host-streamed corpora)

CAPACITY_ROWS = 33554432  # int8 rows over four cards: 32.2 GB a card, 128.8 GB in all
CAPACITY_CHECK = 64  # queries held against rank 0's own scan of the capacity corpus
KEY_BYTES = 80  # host bytes a doc key costs a rank: its str and its slots in two arrays
HOST_QUERIES = 1024  # queries a host-stream run (each batch reads every rank's rows)


def seeded_int8_topk(rows, n, qf, k):
    """The exact int8 top-``k`` of the folded f32 queries ``qf`` over
    ``rows[0:n]`` (a :class:`SeededRows`), the rows made again block by
    block on the card and quantized by :func:`quantize_reference`; integer
    dots summed in f64, rounded to f32 and times both scales in the JAX
    package's order.  Returns [Q, k] scores and row ids on the card."""
    q8, qs = quantize_reference(qf)
    q8 = q8.double()
    top_s = top_i = None
    for lo in range(0, n, BIG_ROW_BLOCK):
        hi = min(n, lo + BIG_ROW_BLOCK)
        d8, ds = quantize_reference(rows[lo:hi].float())
        s = (q8 @ d8.double().T).float() * qs[:, None] * ds[None, :]
        s_top, i_top = torch.topk(s, min(k, hi - lo), dim=-1)
        i_top = i_top + lo
        if top_s is not None:
            s_top, sel = torch.topk(torch.cat([top_s, s_top], 1), k, dim=-1)
            i_top = torch.gather(torch.cat([top_i, i_top], 1), 1, sel)
        top_s, top_i = s_top, i_top
    return top_s, top_i


def capacity_rank(spec, mesh, out) -> None:
    """mesh_capacity's rank, one a card: (1) the serve cell's corpus as int8
    on the cards, exact and rerank, rank 0 alone on the whole corpus first;
    (2) that corpus in host memory, from one f32 .npy that rank 0 writes and
    every rank memmaps, streamed in bf16 and int8, rank 0 alone first; (3)
    ``n_capacity`` int8 rows over the cards, exact, rank 0 holding
    ``CAPACITY_CHECK`` queries against its own scan of every row.  Every
    rank makes only its rows, from the seed."""
    from mfar_tpu_torch.parallel import multihost

    tok, cfg, n_cards = spec["tok"], spec["cfg"], mesh.size("data")
    encoder = init_encoder(cfg, seed=spec["seed"])
    plain = make_encode_fn(encoder, device=DEVICE)
    ranks_encode = make_encode_fn(encoder, device=DEVICE, mesh=mesh)
    fi = resolve_fields("all_dense", "mag")
    width = len(fi) * cfg.hidden_size
    qs = spec["big_queries"]
    hq = qs[: spec["host_queries"]]

    def kw(n):
        return dict(field_info=fi, doc_keys=[f"doc{i}" for i in range(n)], tokenizer=tok,
                    mixer_params={"weight": spec["mixer_dense"]}, recall_k=100, device=DEVICE)

    def run(eng, queries, mode, collective):
        """QPS of ``queries`` at batch 256 after a warm-up batch (the ranks
        start together), and the results."""
        eng.retrieve_many(queries[:256], top_k=100, mode=mode, batch_size=256)
        if collective:
            multihost.sync("capacity-run")
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = eng.retrieve_many(queries, top_k=100, mode=mode, batch_size=256)
        torch.cuda.synchronize()
        return len(queries) / (time.perf_counter() - t), res

    def placed(make):
        """(engine, seconds to place it, peak device GB of the placement)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        eng = make()
        torch.cuda.synchronize()
        return eng, time.perf_counter() - t, torch.cuda.max_memory_allocated() / 1e9

    def one_card(name, make, queries, modes):
        """Rank 0 alone: QPS per mode with its own encoder calls, then the
        ranks' first batch encoded in the ranks' calls, the reference."""
        if mesh.rank == 0:
            eng, place_s, _ = placed(make)
            for mode in modes:
                eng.encode_fn = plain
                rate, _ = run(eng, queries, mode, collective=False)
                eng.encode_fn = split_encode(plain, n_cards)
                ref = eng.retrieve_many(queries[:256], top_k=100, mode=mode, batch_size=256)
                out[f"one_{name}_{mode}"] = (rate, ref, eng.last_serve_path)
            out[f"one_{name}"] = dict(place_s=place_s, peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                                      **corpus_bytes(eng))
            del eng
            torch.cuda.empty_cache()
        multihost.sync(f"capacity-one-{name}")

    def ranks(name, make, queries, modes):
        eng, place_s, _ = placed(make)
        for mode in modes:
            rate, res = run(eng, queries, mode, collective=True)
            out[f"mesh_{name}_{mode}"] = (rate, res[:256], eng.last_serve_path)
        out[f"mesh_{name}"] = dict(place_s=place_s, peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                                   **corpus_bytes(eng))
        del eng
        torch.cuda.empty_cache()

    # (1) the serve cell's corpus as int8 on the cards
    n = spec["n_big"]
    rows = SeededRows(n, width, spec["seed"] + 31)
    one_card("int8", lambda: RetrievalEngine(dense_matrix=rows, quantize="int8",
                                             encode_fn=plain, **kw(n)),
             qs, ("exact", "rerank"))
    ranks("int8", lambda: RetrievalEngine(dense_matrix=rows, quantize="int8", mesh=mesh,
                                          encode_fn=ranks_encode, **kw(n)),
          qs, ("exact", "rerank"))

    # (2) in host memory: one f32 .npy, every rank's engine over a memmap
    n_host = spec["n_host"]
    path = os.path.join(spec["work"], "corpus.npy")
    if mesh.rank == 0:
        t = time.perf_counter()
        mm = np.lib.format.open_memmap(path, mode="w+", dtype=np.float32, shape=(n_host, width))
        for lo in range(0, n_host, BIG_ROW_BLOCK):
            hi = min(n_host, lo + BIG_ROW_BLOCK)
            mm[lo:hi] = rows[lo:hi].float().cpu().numpy()
        mm.flush()
        del mm
        out["npy_write_s"] = time.perf_counter() - t
    multihost.sync("capacity-npy")
    flat = np.load(path, mmap_mode="r")
    placements = {"host_bf16": dict(dense_dtype=torch.bfloat16), "host_int8": dict(quantize="int8")}
    for name, placement in placements.items():
        one_card(name, lambda: RetrievalEngine(dense_matrix=flat, corpus_on_host=True,
                                               encode_fn=plain, **placement, **kw(n_host)),
                 hq, ("exact",))
    # one pinned copy of a bf16 chunk's bytes to each card at once: the yardstick
    pinned = torch.empty(HOST_STREAM_CHUNK, width, dtype=torch.bfloat16, pin_memory=True)
    dev = torch.empty(pinned.shape, dtype=pinned.dtype, device=DEVICE)
    multihost.sync("capacity-yardstick")
    copy_ms = time_cuda(lambda: dev.copy_(pinned, non_blocking=True), reps=5, inner=3, warmup=1)
    out["yardstick_gbs"] = pinned.nbytes / copy_ms / 1e6
    del pinned, dev
    for name, placement in placements.items():
        ranks(name, lambda: RetrievalEngine(dense_matrix=flat, corpus_on_host=True, mesh=mesh,
                                            encode_fn=ranks_encode, **placement, **kw(n_host)),
              hq, ("exact",))
    del flat
    multihost.sync("capacity-host-done")

    # (3) more int8 rows than one card holds
    n_cap = spec["n_capacity"]
    cap_rows = SeededRows(n_cap, width, spec["seed"] + 59)
    cap, place_s, _ = placed(lambda: RetrievalEngine(
        dense_matrix=cap_rows, quantize="int8", mesh=mesh, encode_fn=ranks_encode, **kw(n_cap)))
    rate, _ = run(cap, qs, "exact", collective=True)
    out["mesh_capacity"] = dict(qps=rate, place_s=place_s, path=cap.last_serve_path,
                                peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                                **corpus_bytes(cap))
    check_qs = qs[:CAPACITY_CHECK]
    got = cap.retrieve(check_qs, top_k=100)
    qf = folded_queries(cap, check_qs)  # the ranks' encoder calls, as retrieve's
    if mesh.rank == 0:
        d8, ds = quantize_reference(cap_rows[0:BIG_ROW_BLOCK].float())
        check(torch.equal(d8.to(torch.int8), cap.docs_q[:BIG_ROW_BLOCK])
              and torch.equal(ds, cap.doc_scales[:BIG_ROW_BLOCK]),
              "the capacity engine's first int8 rows differ from the reference's")
        t = time.perf_counter()
        with torch.inference_mode():
            top_s, top_i = seeded_int8_topk(cap_rows, n_cap, qf, 100)
        out["capacity_scan_s"] = time.perf_counter() - t
        ref = cap._to_keyed(top_s.cpu().numpy(), top_i.cpu().numpy())
        out["capacity_check"] = (len(check_qs), rankings_agree(got, ref, 1e-6, 0.0))
    multihost.sync("capacity-check")


def corpus_bytes(eng) -> dict:
    """GB of a rank's corpus on its card and pinned in its host memory (a
    memmap's rows stay in the page cache and count nothing)."""
    on_card = (eng.docs_flat, eng.docs_q, eng.doc_scales)
    pinned = (eng.docs_host_q, eng.docs_host if torch.is_tensor(eng.docs_host) else None)
    return {key: sum(t.numel() * t.element_size() for t in ts if t is not None) / 1e9
            for key, ts in (("device_gb", on_card), ("host_gb", pinned))}


def run_capacity_commands(seed, spec, n_cards, n_docs=512) -> dict:
    """The commands over the cards on a corpus in int8 and in host memory:
    ``retrieve --quantize int8`` and ``retrieve --corpus-on-host`` under
    torchrun --multihost pod against one card's run of each (one card's
    batches the ranks' shares of theirs), and ``mask_fields --corpus-on-host``
    over the ranks against one card's, on a seeded checkpoint (one card's
    encoder calls split as the ranks split them, so each bf16 row rounds
    alike)."""
    from mfar_tpu_torch.train import trainer as trainer_mod
    from mfar_tpu_torch.train.checkpoint import CheckpointManager

    rng = np.random.default_rng(seed + 53)
    pairs = spec["pairs"][:n_docs]
    sub = Corpus.from_pairs(pairs, dataset_name="mag")
    out = {}
    with tempfile.TemporaryDirectory() as d:
        data, bert, ckpt = (os.path.join(d, x) for x in ("data", "bert", "ckpt"))
        write_data_dir(data, pairs, {"val": mag_splits(pairs, (16,), rng)[0]})
        with open(os.path.join(data, "test.queries"), "w", encoding="utf-8") as f:
            for i, q in enumerate(spec["queries"][:128]):
                f.write(f"q{i}\t{q}\n")
        write_bert_dir(bert, sub, seed + 4)
        base = ["--dataset-name", "mag", "--data", data, "--model-name", bert,
                "--device", DEVICE]
        npz = os.path.join(d, "one.npz")
        encode_corpus.main([*base, "--out", npz, "--mesh", "off"])
        torchrun = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
                    str(n_cards), "--master-port", str(free_port())]
        env = {k: v for k, v in os.environ.items() if not k.startswith("MFAR_")}

        def over_ranks(cmd, args, label):
            t = time.perf_counter()
            procs = start_ranks([[*torchrun, "-m", f"mfar_tpu_torch.commands.{cmd}", *args,
                                  "--multihost", "pod"]], [env], d, label)
            watch_ranks(procs, f"{cmd} {label} under torchrun")
            return time.perf_counter() - t

        for label, flags in (("int8", ["--quantize", "int8"]), ("host", ["--corpus-on-host"])):
            one, many = (os.path.join(d, f"{w}_{label}.qres") for w in ("one", "many"))
            retrieve_cmd.main([*base, "--dense-index", npz, "--mesh", "off", "--out", one,
                               "--batch-size", str(64 // n_cards), *flags])
            secs = over_ranks("retrieve", [*base, "--dense-index", npz, "--out", many,
                                           "--batch-size", "64", *flags], f"retrieve_{label}")
            want, got = qres_lists(one), qres_lists(many)
            msg = rankings_agree([got.get(q, []) for q in want], [want[q] for q in want],
                                 E2E_RTOL, E2E_ATOL)
            check(got.keys() == want.keys() and msg is None,
                  f"retrieve {' '.join(flags)} over the cards vs one card: {msg}")
            out[f"retrieve_{label}_s"] = secs

        # a seeded checkpoint of the all_dense model, then the ablation sweep
        fi = resolve_fields("all_dense", "mag")
        config, encoder_state, _ = prepare_model(bert)
        state = init_state(MFARModel(encoder_config=config, num_fields=len(fi)),
                           make_optimizer(encoder_lr=1e-4, weights_lr=1e-1), seed=seed,
                           device=DEVICE)
        state.model.encoder.load_state_dict(encoder_state)
        CheckpointManager(ckpt).save(0, state, {"valid_loss": 0.0}, fi)
        del state
        sweep = [*base, "--field-names", "all_dense", "--lexical-index",
                 os.path.join(d, "idx"), "--checkpoint-dir", ckpt, "--corpus-on-host"]
        make = trainer_mod.make_encode_fn
        trainer_mod.make_encode_fn = lambda enc, device=None, mesh=None: split_encode(
            make(enc, device=device), n_cards)
        try:
            t = time.perf_counter()
            mask_fields.main([*sweep, "--out", os.path.join(d, "abl_one"), "--mesh", "off"])
            one_s = time.perf_counter() - t
        finally:
            trainer_mod.make_encode_fn = make
        secs = over_ranks("mask_fields", [*sweep, "--out", os.path.join(d, "abl_many")],
                          "mask_fields")
        records = {}
        for w in ("one", "many"):
            with open(os.path.join(d, f"abl_{w}", "results_dicts.jsonl")) as f:
                records[w] = [json.loads(line) for line in f]
        check(len(records["one"]) > 1 and records["one"] == records["many"],
              f"mask_fields over the cards vs one card: {records['many']} against "
              f"{records['one']}")
        out.update(mask_fields_one_s=one_s, mask_fields_ranks_s=secs,
                   mask_fields_records=len(records["one"]))
    phase("mesh_capacity", f"commands on {n_docs} docs over {n_cards} NCCL ranks under torchrun "
                           f"--multihost pod: retrieve --quantize int8 "
                           f"({out['retrieve_int8_s']:.1f}s) and retrieve --corpus-on-host "
                           f"({out['retrieve_host_s']:.1f}s), each == one card's "
                           f"({len(want)} queries); mask_fields --corpus-on-host on a seeded "
                           f"checkpoint ({out['mask_fields_records']} configurations) in "
                           f"{secs:.1f}s == one card's in {one_s:.1f}s (process start and model "
                           f"load included) ({CARD})")
    return out


def run_mesh_capacity(seed, e2e=None, n_big=1048576, n_capacity=CAPACITY_ROWS,
                      n_queries=2048) -> dict:
    """Capacity over several cards: the commands on int8 and host corpora,
    then the ranks of :func:`capacity_rank`, against one card's answers
    and rank 0's own scan."""
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        phase("mesh_capacity", f"needs several cards; {n_cards} visible: skipped")
        return {}
    spec = mesh_spec(seed, e2e or mesh_world(seed))
    out = run_capacity_commands(seed, spec, n_cards)
    width = 5 * spec["cfg"].hidden_size
    avail = mem_available_bytes()
    cuts = []
    # the .npy (in the page cache), one card's pinned int8 copy and staging
    n_host = n_big
    if avail < 3 * n_host * width * 4:
        n_host = max(HOST_STREAM_CHUNK, avail // (3 * width * 4) // BIG_ROW_BLOCK * BIG_ROW_BLOCK)
        cuts.append(f"the host corpus cut from {n_big} rows")
    # each rank's doc keys
    if avail < 2 * n_cards * n_capacity * KEY_BYTES:
        n_capacity = avail // (2 * n_cards * KEY_BYTES) // BIG_ROW_BLOCK * BIG_ROW_BLOCK
        cuts.append(f"the capacity corpus cut from {CAPACITY_ROWS} rows")
    rng = np.random.default_rng(seed + 59)
    job = dict(spec, n_big=n_big, n_host=n_host, n_capacity=n_capacity,
               big_queries=word_queries(n_queries, rng),
               host_queries=min(HOST_QUERIES, n_queries))
    t = time.perf_counter()
    ranks = run_ranks("capacity", job, n_cards, "mesh_capacity", timeout=1500)
    out["mesh_capacity_ranks_s"] = time.perf_counter() - t
    r0 = ranks[0]
    check(sorted(r["card"] for r in ranks) == list(range(n_cards)), "ranks share a card")
    lines, rates = [], {}
    for name, modes, one_route, mesh_route in (
            ("int8", ("exact", "rerank"), ("singlechip-int8-dense", "singlechip-rerank-int8"),
             ("mesh-int8-dense", "mesh-rerank-int8")),
            ("host_bf16", ("exact",), ("host-stream-dense",), ("host-stream-dense-mesh",)),
            ("host_int8", ("exact",), ("host-stream-dense-int8",),
             ("host-stream-dense-int8-mesh",))):
        for mode, want_one, want_mesh in zip(modes, one_route, mesh_route):
            q_one, ref, path_one = r0[f"one_{name}_{mode}"]
            q_mesh, got, path_mesh = r0[f"mesh_{name}_{mode}"]
            check((path_one, path_mesh) == (want_one, want_mesh),
                  f"{name} {mode}: paths {path_one}, {path_mesh}")
            if mode == "exact":
                msg = rankings_agree(got, ref, E2E_RTOL, E2E_ATOL)
                check(msg is None, f"{name} {mode} over {n_cards} cards vs one card: {msg}")
            else:
                out[f"capacity_{name}_rerank_overlap"] = hold_rerank_overlap(
                    got, ref, f"{name} rerank over {n_cards} cards")
            rates[f"{name}_{mode}"] = {"1": q_one, str(n_cards): q_mesh}
        one, many = r0[f"one_{name}"], [r[f"mesh_{name}"] for r in ranks]
        lines.append(f"{name}: place {one['place_s']:.1f}s on one card, "
                     f"{max(m['place_s'] for m in many):.1f}s on {n_cards}; a card holds "
                     f"{one['device_gb']:.3f} GB on the card / {one['host_gb']:.3f} GB pinned "
                     f"alone, {many[0]['device_gb']:.3f} / {many[0]['host_gb']:.3f} GB as one "
                     f"of {n_cards}; peak {one['peak_gb']:.2f} GB alone, "
                     f"{max(m['peak_gb'] for m in many):.2f} GB of {n_cards}")
    # a batch of 256 moves each card's rows once: n_host / cards rows of
    # 2 bytes an element in bf16, 1 in int8
    gbs = {name: {k: n_host / int(k) * width * per_elem * qps / 256 / 1e9
                  for k, qps in rates[f"{name}_exact"].items()}
           for name, per_elem in (("host_bf16", 2), ("host_int8", 1))}
    yard = [r["yardstick_gbs"] for r in ranks]
    cap = [r["mesh_capacity"] for r in ranks]
    check(all(c["path"] == "mesh-int8-dense" for c in cap), f"capacity path {cap[0]['path']}")
    n_check, msg = r0["capacity_check"]
    check(msg is None, f"{n_capacity} int8 rows over {n_cards} cards vs rank 0's scan: {msg}")
    out.update(mesh_capacity_qps=rates, mesh_capacity_stream_gbs=gbs,
               mesh_capacity_yardstick_gbs=yard, mesh_capacity_rows=n_capacity,
               mesh_capacity_big_qps=cap[0]["qps"],
               mesh_capacity_device_gb=[c["device_gb"] for c in cap],
               mesh_capacity_peak_gb=[c["peak_gb"] for c in cap])
    phase("mesh_capacity", f"[{n_big}, 5, {width // 5}] corpus, each rank making its rows; "
                           f"batch 256, {n_queries} queries of 8 words ({job['host_queries']} "
                           f"for the host streams, exact), QPS one card -> {n_cards}: {rates}; "
                           f"the ranks' "
                           f"first batch == one card's (rtol {E2E_RTOL}, atol {E2E_ATOL}; "
                           f"rerank by top-100 overlap "
                           f"{out['capacity_int8_rerank_overlap']:.4f}); " + "; ".join(lines)
                           + f"; the host corpus: {n_host} rows, one f32 .npy of "
                           f"{n_host * width * 4 / 1e9:.2f} GB written by rank 0 in "
                           f"{r0['npy_write_s']:.1f}s and memmapped by every rank; streamed "
                           f"GB/s a card {gbs} against one pinned copy of a chunk's bytes "
                           f"{[round(y, 2) for y in yard]} GB/s ({CARD})")
    phase("mesh_capacity", f"{n_capacity} int8 rows over {n_cards} cards "
                           f"({n_capacity * width / 1e9:.1f} GB in all): each rank quantized "
                           f"its {cap[0]['device_gb']:.2f} GB block from the seed in "
                           f"{max(c['place_s'] for c in cap):.1f}s; exact {cap[0]['qps']:.1f} "
                           f"QPS at batch 256 ({n_queries} queries), peak "
                           f"{max(c['peak_gb'] for c in cap):.2f} GB a card; {n_check} queries "
                           f"== rank 0's own scan of every row made again on its card (exact "
                           f"integer dots, rtol 1e-6, ties allowed) in "
                           f"{r0['capacity_scan_s']:.1f}s" + (f"; {', '.join(cuts)} (MemAvailable "
                           f"{avail / 1e9:.1f} GB)" if cuts else "") + f" ({CARD})")
    return out


def qres_lists(path):
    out = {}
    for r in trec.QRes.from_file(path):
        out.setdefault(r.query_id, []).append((r.doc_id, float(r.sim)))
    return out


def device_profile(fn, top: int = 8, host_top: int = 0) -> dict:
    """Run ``fn()`` once under ``torch.profiler``: wall time, the summed
    time of the device's kernels (one stream, so busy time; user-annotation
    ranges, which enclose kernels, are not kernels), their share of
    the wall time, the ``top`` kernels by device time and, with
    ``host_top``, the host's operators by their own CPU time (the profiler's
    per-operator cost included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    # device-side user-annotation ranges (Optimizer.step#AdamW.step, ...)
    # enclose kernels that are counted on their own: leave them out
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:  # a profiler without device tracing: say so, claim nothing
        return dict(wall_ms=wall_ms, device_ms=float("nan"), busy_share=None,
                    top="not measured (the profiler saw no device kernel)",
                    host_top="not measured")
    kernels.sort(key=lambda e: -e.self_device_time_total)
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    host = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)[:host_top]
    return dict(
        wall_ms=wall_ms, device_ms=device_ms, busy_share=device_ms / wall_ms,
        top="; ".join(f"{e.key[:60]} x{e.count} {e.self_device_time_total / 1e3:.2f}"
                      for e in kernels[:top]),
        host_top="; ".join(f"{e.key[:50]} x{e.count} {e.self_cpu_time_total / 1e3:.2f}"
                           for e in host),
    )


def kernel_usage(logs: dict) -> dict:
    """Each kernel's registers and spills from the ptxas lines of its
    library's build log (nvcc -Xptxas -v), by kernel name (the flash
    kernels by name and slabs, and "rows" for the forwards on row
    maps)."""
    usage = {}
    for log in logs.values():
        name = None
        for ln in log.splitlines():
            if "Function properties for" in ln:
                mangled = ln.split("for", 1)[1].strip()
                slabs = re.search(r"(flash_attention_fwd|flash_tf32_fwd|flash_attention_bwd_dkv|"
                                  r"flash_attention_bwd_dq|flash_tf32_bwd_dkv(?:_wide)?|"
                                  r"flash_tf32_bwd_dq(?:_wide)?)_kernelILi(\d+)E(Lb1E)?", mangled)
                name = (f"{slabs[1]} NS={slabs[2]}{' rows' if slabs[3] else ''}"
                        if slabs else next(
                            (k for k in ("flash_attention_bwd_dkv", "flash_attention_bwd_dq",
                                         "flash_attention_fwd", "gather_scores_cross_row",
                                         "gather") if k in mangled), mangled))
            elif name and "spill" in ln:
                usage[name] = ln.strip()
            elif name and "registers" in ln:
                usage[name] = f"{ln.split(':', 1)[1].strip()}, {usage.get(name, '')}"
                name = None
    return usage


# the phases after device and build, in the order they run
PHASES = ("k1", "k2", "k2b", "k2g", "e2e", "long", "cli", "train", "train_mesh", "train_tp",
          "train_tp_cards", "train_cli", "f32",
          "serving", "hybrid", "hybrid_serving", "hybrid_cli", "gtr", "mesh", "mesh_capacity",
          "serve", "int8", "host_stream")
# phases that read what an earlier one made
NEEDS = {"long": "e2e", "cli": "e2e", "train": "e2e", "train_mesh": "e2e", "train_tp": "e2e",
         "train_tp_cards": "e2e", "train_cli": "e2e", "f32": "e2e",
         "serving": "e2e",
         "hybrid": "e2e", "hybrid_serving": "e2e", "gtr": "e2e", "serve": "e2e",
         "int8": "serve", "host_stream": "int8"}


def selected_phases(arg: str) -> list:
    """The phases to run, in order: all of them, or the comma-separated
    ones and those they read from."""
    if arg == "all":
        return list(PHASES)
    want = set(arg.split(",")) - {"device", "build"}
    unknown = want - set(PHASES)
    if unknown:
        raise SystemExit(f"unknown phases {sorted(unknown)}; choose from {PHASES}")
    for name in PHASES[::-1]:
        if name in want and name in NEEDS:
            want.add(NEEDS[name])
    return [name for name in PHASES if name in want]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--phases", default="all",
                   help="comma-separated phases to run after device and build (with those "
                        f"they read from), default all: {','.join(PHASES)}")
    p.add_argument("--mesh-rank", default=None, help=argparse.SUPPRESS)  # a mesh phase rank
    args = p.parse_args(argv)
    phases = selected_phases(args.phases)
    if args.mesh_rank:
        return mesh_rank(args.mesh_rank)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    global CARD
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    CARD = smi.splitlines()[0]
    phase("device", f"{kind}; torch {torch.__version__} CUDA {torch.version.cuda}; "
                    f"TF32 off (matmul and cuDNN)")
    print(smi.splitlines()[0], flush=True)

    def build(name):
        t = time.perf_counter()
        return _build.build(name), round(time.perf_counter() - t, 1)

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(_build.SOURCES)) as pool:
        built = list(pool.map(build, _build.SOURCES))  # one nvcc per source
    build_s = time.perf_counter() - t0
    usage = kernel_usage(dict(zip(_build.SOURCES, (log for log, _ in built))))
    each = dict(zip(_build.SOURCES, (s for _, s in built)))
    phase("build", f"{sorted(_build.SOURCES)} built in {build_s:.2f}s (each, in parallel: "
                   f"{json.dumps(each)}); ptxas: "
                   f"{'; '.join(f'{k}: {v}' for k, v in usage.items())}")
    for name, line in usage.items():
        if name.startswith("flash"):
            check(" 0 bytes spill stores, 0 bytes spill loads" in line, f"{name} spills: {line}")

    r = {}  # each phase's numbers
    seconds = {"build": round(build_s, 1)}  # each phase's wall time: the run's budget

    def timed(name, fn, *fn_args):
        t = time.perf_counter()
        out = fn(*fn_args)
        seconds[name] = round(time.perf_counter() - t, 1)
        return out

    if "k1" in phases:
        r["k1"] = timed("k1", run_k1, args.seed)
    if "k2" in phases:
        r["k2"] = timed("k2", run_k2, args.seed)
    if "k2b" in phases:
        r["k2b"] = timed("k2b", run_k2b, args.seed)
    if "k2g" in phases:
        r["k2g"] = timed("k2g", run_k2g, args.seed)
    e2e_world = None
    if "e2e" in phases:
        engine, plain_engine, corpus, queries, r["e2e"] = timed("e2e", run_e2e, args.seed)
        e2e_world = (engine, corpus, queries)
    if "long" in phases:
        r["long"] = timed("long", run_long, args.seed, engine, plain_engine, corpus,
                          EncoderConfig.contriever_base().num_layers)
    if "e2e" in phases:
        del plain_engine
    if "cli" in phases:
        r["cli"] = timed("cli", run_cli, args.seed, corpus)
    if "train" in phases:
        r["train"] = timed("train", run_train, args.seed, corpus, engine.tokenizer)
    if "train_mesh" in phases:
        r["train_mesh"] = timed("train_mesh", run_train_mesh, args.seed, corpus, engine.tokenizer)
    if "train_tp" in phases:
        r["train_tp"] = timed("train_tp", run_train_tp, args.seed, corpus, engine.tokenizer)
    if "train_tp_cards" in phases:
        r["train_tp_cards"] = timed("train_tp_cards", run_train_tp_cards, args.seed, corpus,
                                    engine.tokenizer)
    if "train_cli" in phases:
        r["train_cli"] = timed("train_cli", run_train_cli, args.seed, corpus)
    if "f32" in phases:
        r["f32"] = timed("f32", run_f32, args.seed, corpus, engine.tokenizer, queries)
    if "serving" in phases:
        r["serving"] = timed("serving", run_serving, args.seed, engine, queries)
    if "hybrid" in phases:
        r["hybrid"] = timed("hybrid", run_hybrid, args.seed, engine, corpus, queries)
    if "hybrid_serving" in phases:
        r["hybrid_serving"] = timed("hybrid_serving", run_hybrid_serving, args.seed, engine)
    if "hybrid_cli" in phases:
        r["hybrid_cli"] = timed("hybrid_cli", run_hybrid_cli, args.seed)
    if "gtr" in phases:
        r["gtr"] = timed("gtr", run_gtr, args.seed, corpus, queries)
    if "mesh" in phases:
        r["mesh"] = timed("mesh", run_mesh, args.seed, e2e_world)
    if "mesh_capacity" in phases:
        r["mesh_capacity"] = timed("mesh_capacity", run_mesh_capacity, args.seed, e2e_world)
    # the 1048576-doc phases last, so that their 8 GB corpus and its host
    # copies come after the earlier phases, as in the runs before them
    if "serve" in phases:
        big, r["serve"] = timed("serve", run_serve, args.seed, engine)
    if "int8" in phases:
        i8, r["int8"] = timed("int8", run_int8, args.seed, big, engine, queries)
    if "host_stream" in phases:
        r["host_stream"] = timed("host_stream", run_host_stream, args.seed, big, i8)

    phase("seconds", json.dumps(seconds))
    check(not DRIFT_FAULTS, "answers move with their batch or from run to run:\n"
                            + "\n".join(DRIFT_FAULTS))
    summary = {k: v for name, res in r.items() if name not in ("k1", "k2", "k2b", "k2g")
               for k, v in res.items()}
    for name in ("k2", "k2b", "k2g"):
        if name in r:
            summary[name] = r[name]
    if "k1" in r:
        summary.update(k1_f32=r["k1"]["f32"], k1_bf16=r["k1"]["bf16"],
                       k1x_bit_equal=r["k1"]["k1x_bit_equal"])
    phase("summary", json.dumps(summary))
    if phases != list(PHASES):
        print(json.dumps({"kernels": "measured in a run of every phase", "phases": phases}),
              flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
        return 0
    k1, k2, k2b, e2e, cli, train = r["k1"], r["k2"], r["k2b"], r["e2e"], r["cli"], r["train"]
    k2g, f32_launches = r["k2g"], r["f32"]["f32_launches"]
    by_route = k2g["by_route"]
    serve, hybrid, hybrid_serving = r["serve"], r["hybrid"], r["hybrid_serving"]
    hybrid_cli, gtr, mesh = r["hybrid_cli"], r["gtr"], r["mesh"]
    train_mesh = r["train_mesh"]["train_mesh_launches"]  # every rank's, in its fit
    train_tp = r["train_tp"]["train_tp_launches"]  # every model rank's, in its fit
    k1_row = k1["bf16"]
    print(json.dumps({"kernels": [{
        "name": "gather_per_field_scores",
        "route": "cuda",
        "source": "mfar_tpu_torch/csrc/gather_scores.cu",
        "replaces": "mfar_tpu/ops/pallas_kernels.py:192",
        # the main paths that run K1: e2e rerank, the daemon's rerank (the
        # serve phase and serve --smoke-out), hybrid rerank, hybrid
        # serving's rerank, the hybrid retrieve command, and GTR's rerank,
        # serve --smoke-out and retrieve command
        "launches": (e2e["k1_launches"] + serve["serve_k1_launches"]
                     + hybrid_cli["hybrid_cli_serve_k1_launches"]
                     + hybrid["hybrid_k1_launches"]
                     + hybrid_serving["hybrid_serving_k1_launches"]
                     + hybrid_cli["hybrid_cli_k1_launches"]
                     + gtr["gtr_k1_launches"] + gtr["gtr_serve_k1_launches"]
                     + gtr["gtr_cli_k1_launches"]),
        "max_abs_err": k1["max_abs_err"],
        "ms": k1_row["kernel_ms"],
        "plain_ms": k1_row["plain_ms"],
        "bound_ms": k1_row["bound_ms"],
        "bound_by": k1_row["bound_by"],
        "library_ms": k1_row["library_ms"],
    }, {
        "name": "gather_per_field_scores_cross_row",
        "route": "cuda",
        "source": "mfar_tpu_torch/csrc/gather_scores.cu",
        "replaces": "mfar_tpu/ops/pallas_kernels.py:92",
        # the main paths that run K1x: e2e rerank with pallas_cross_row, and
        # retrieve --mode rerank --pallas-cross-row (phase cli)
        "launches": e2e["k1x_launches"] + cli["cli_k1x_launches"],
        "max_abs_err": k1["k1x_max_abs_err"],
        "ms": k1_row["cross_row_ms"],
        "plain_ms": k1_row["plain_ms"],
        "bound_ms": k1_row["bound_ms"],
        "bound_by": k1_row["bound_by"],
        "library_ms": k1_row["library_ms"],
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "mfar_tpu_torch/csrc/flash_attention.cu",
        "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:758",
        # the one-device build's, each mesh rank's share of the split build
        # (phase mesh (b)), each rank's share of data-parallel training
        # (phase train_mesh, Trainer.fit) and each model rank's heads in
        # tensor-parallel training (phase train_tp (a), Trainer.fit)
        "launches": e2e["k2_launches"] + mesh["mesh_k2_launches"] + train_mesh[0] + train_tp[0],
        "max_abs_err": k2["max_abs_err"],
        "ms": k2["kernel_ms"],
        "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"],
        "library_ms": k2["library_ms"],
    }, {
        "name": "flash_attention_bwd_dkv",
        "route": "cuda",
        "source": "mfar_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:1121",
        # one device's Trainer.fit, each train_mesh rank's and each train_tp rank's
        "launches": train["train_launches"][1] + train_mesh[1] + train_tp[1],
        "max_abs_err": k2b["dkv_max_abs_err"],
        "ms": k2b["dkv_ms"],
        "plain_ms": k2b["plain_bwd_ms"],
        "bound_ms": k2b["dkv_bound_ms"],
        "bound_by": k2b["dkv_bound_by"],
        "library_ms": k2b["library_bwd_ms"],
    }, {
        "name": "flash_attention_bwd_dq",
        "route": "cuda",
        "source": "mfar_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:1456",
        "launches": train["train_launches"][2] + train_mesh[2] + train_tp[2],
        "max_abs_err": k2b["dq_max_abs_err"],
        "ms": k2b["dq_ms"],
        "plain_ms": k2b["plain_bwd_ms"],
        "bound_ms": k2b["dq_bound_ms"],
        "bound_by": k2b["dq_bound_by"],
        "library_ms": k2b["library_bwd_ms"],
    }, {
        # K2 at other head dims in bf16 (the wgmma kernel at ceil(D / 64)
        # slabs): times at all-MiniLM-L6-v2's [256, 12, 512, 32]; launches
        # from phase f32's MiniLM-width build and batch
        "name": "flash_attention_headdim",
        "route": "cuda",
        "source": "mfar_tpu_torch/csrc/flash_attention.cu",
        "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:758",
        "launches": f32_launches["wgmma_headdim"],
        "max_abs_err": by_route["wgmma_headdim"]["fwd"],
        "ms": k2g["bf16_d32"]["ms"],
        "plain_ms": k2g["bf16_d32"]["plain_ms"],
        "bound_ms": k2g["bf16_d32"]["bound_ms"],
        "bound_by": k2g["bf16_d32"]["bound_by"],
        "library_ms": k2g["bf16_d32"]["library_ms"],
    }, {
        # K2 in f32 on the tensor cores (3xTF32): times at the f32 build's
        # [256, 12, 512, 64]; launches from phase f32's build and Trainer.fit
        "name": "flash_attention_tf32",
        "route": "cuda",
        "source": "mfar_tpu_torch/csrc/flash_attention_tf32.cu",
        "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:758",
        "launches": f32_launches["tf32"],
        "max_abs_err": by_route["tf32"]["fwd"],
        "ms": k2g["f32"]["ms"],
        "plain_ms": k2g["f32"]["plain_ms"],
        "bound_ms": k2g["f32"]["bound_ms"],
        "bound_by": k2g["f32"]["bound_by"],
        "library_ms": k2g["f32"]["library_ms"],
    }, {
        # K2b at other bf16 head dims (the wgmma pair at ceil(D / 64)
        # slabs): times at all-MiniLM-L6-v2's [96, 12, 512, 32]; launches
        # from phase f32's MiniLM-width batch and TinyBERT-width bf16 batch
        # (on copies padded to D = 32)
        "name": "flash_attention_bwd_headdim_dkv",
        "route": "cuda",
        "source": "mfar_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:1121",
        "launches": f32_launches["wgmma_headdim_dkv"],
        "max_abs_err": by_route["wgmma_headdim"]["dkv"],
        "ms": k2g["bf16_d32_train"]["dkv_ms"],
        "plain_ms": k2g["bf16_d32_train"]["plain_bwd_ms"],
        "bound_ms": k2g["bf16_d32_train"]["dkv_bound_ms"],
        "bound_by": k2g["bf16_d32_train"]["dkv_bound_by"],
        "library_ms": k2g["bf16_d32_train"]["library_bwd_ms"],
    }, {
        "name": "flash_attention_bwd_headdim_dq",
        "route": "cuda",
        "source": "mfar_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:1456",
        "launches": f32_launches["wgmma_headdim_dq"],
        "max_abs_err": by_route["wgmma_headdim"]["dq"],
        "ms": k2g["bf16_d32_train"]["dq_ms"],
        "plain_ms": k2g["bf16_d32_train"]["plain_bwd_ms"],
        "bound_ms": k2g["bf16_d32_train"]["dq_bound_ms"],
        "bound_by": k2g["bf16_d32_train"]["dq_bound_by"],
        "library_ms": k2g["bf16_d32_train"]["library_bwd_ms"],
    }, {
        # K2b in f32 on the tensor cores (3xTF32): times at the f32 train
        # step's [96, 12, 512, 64]; launches from phase f32's Trainer.fit
        "name": "flash_attention_tf32_bwd_dkv",
        "route": "cuda",
        "source": "mfar_tpu_torch/csrc/flash_attention_tf32_bwd.cu",
        "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:1121",
        "launches": f32_launches["tf32_dkv"],
        "max_abs_err": by_route["tf32"]["dkv"],
        "ms": k2g["f32_train"]["dkv_ms"],
        "plain_ms": k2g["f32_train"]["plain_bwd_ms"],
        "bound_ms": k2g["f32_train"]["dkv_bound_ms"],
        "bound_by": k2g["f32_train"]["dkv_bound_by"],
        "library_ms": k2g["f32_train"]["library_bwd_ms"],
    }, {
        "name": "flash_attention_tf32_bwd_dq",
        "route": "cuda",
        "source": "mfar_tpu_torch/csrc/flash_attention_tf32_bwd.cu",
        "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:1456",
        "launches": f32_launches["tf32_dq"],
        "max_abs_err": by_route["tf32"]["dq"],
        "ms": k2g["f32_train"]["dq_ms"],
        "plain_ms": k2g["f32_train"]["plain_bwd_ms"],
        "bound_ms": k2g["f32_train"]["dq_bound_ms"],
        "bound_by": k2g["f32_train"]["dq_bound_by"],
        "library_ms": k2g["f32_train"]["library_bwd_ms"],
    }, {
        # K2's wgmma kernel on row maps (bf16 heads no per-head map reads,
        # side by side in rows that one does): times at TinyBERT-4L-312D's
        # [256, 12, 512, 26]; launches from phase f32's TinyBERT-width build
        # and bf16 batch
        "name": "flash_attention_rows",
        "route": "cuda",
        "source": "mfar_tpu_torch/csrc/flash_attention.cu",
        "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:758",
        "launches": f32_launches["wgmma_rows"],
        "max_abs_err": by_route["wgmma_rows"]["fwd"],
        "ms": k2g["bf16_d26"]["ms"],
        "plain_ms": k2g["bf16_d26"]["plain_ms"],
        "bound_ms": k2g["bf16_d26"]["bound_ms"],
        "bound_by": k2g["bf16_d26"]["bound_by"],
        "library_ms": k2g["bf16_d26"]["library_ms"],
    }, {
        # K2's 3xTF32 kernel on row maps (f32): times at TinyBERT-4L-312D's
        # [256, 12, 512, 26] f32; launches from phase f32's TinyBERT-width
        # f32 batch
        "name": "flash_attention_tf32_rows",
        "route": "cuda",
        "source": "mfar_tpu_torch/csrc/flash_attention_tf32.cu",
        "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:758",
        "launches": f32_launches["tf32_rows"],
        "max_abs_err": by_route["tf32_rows"]["fwd"],
        "ms": k2g["f32_d26"]["ms"],
        "plain_ms": k2g["f32_d26"]["plain_ms"],
        "bound_ms": k2g["f32_d26"]["bound_ms"],
        "bound_by": k2g["f32_d26"]["bound_by"],
        "library_ms": k2g["f32_d26"]["library_ms"],
    }, {
        # K2's padding routes (what no map reads: a contiguous [B, H, S,
        # 26], strides or a base off 16 bytes) run the wgmma and 3xTF32
        # forwards on zero-padded copies: the whole route (copies, kernel,
        # the output a view) timed at a contiguous [256, 12, 512, 26]; the
        # launches are the routes' own counts (flash_attention.pad_launches)
        # on the main paths, which no model's heads take
        "name": "flash_attention_headdim (wgmma_pad)",
        "route": "cuda",
        "source": "mfar_tpu_torch/csrc/flash_attention.cu",
        "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:758",
        "launches": f32_launches["wgmma_pad_fwd"],
        "max_abs_err": by_route["wgmma_pad"]["fwd"],
        "ms": k2g["bf16_d26_contiguous"]["ms"],
        "plain_ms": k2g["bf16_d26_contiguous"]["plain_ms"],
        "bound_ms": k2g["bf16_d26_contiguous"]["bound_ms"],
        "bound_by": k2g["bf16_d26_contiguous"]["bound_by"],
        "library_ms": k2g["bf16_d26_contiguous"]["library_ms"],
    }, {
        "name": "flash_attention_tf32 (tf32_pad)",
        "route": "cuda",
        "source": "mfar_tpu_torch/csrc/flash_attention_tf32.cu",
        "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:758",
        "launches": f32_launches["tf32_pad_fwd"],
        "max_abs_err": by_route["tf32_pad"]["fwd"],
        "ms": k2g["f32_d26_contiguous"]["ms"],
        "plain_ms": k2g["f32_d26_contiguous"]["plain_ms"],
        "bound_ms": k2g["f32_d26_contiguous"]["bound_ms"],
        "bound_by": k2g["f32_d26_contiguous"]["bound_by"],
        "library_ms": k2g["f32_d26_contiguous"]["library_ms"],
    }, {
        # K2b's wide pairs (the head dims no model of the repo has: bf16
        # past D = 128 in blocks of one warpgroup, NS = 3-4, dkv split into
        # dV and dK blocks; f32 past D = 64 on wgmma in 3xTF32, NS = 4 and
        # 8), launched by the wrappers of their pairs, which count these
        # instances apart (.wide_launches): times at bf16 [96, 12, 512, 256]
        # and f32 [96, 12, 512, 128], both NS = 4 (k2g's phase line has the
        # f32 pair at D = 96, 192 and 256 too)
        "name": "flash_attention_bwd_headdim_dkv (wide)",
        "route": "cuda",
        "source": "mfar_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:1121",
        "launches": f32_launches["wgmma_headdim_wide_dkv"],
        "max_abs_err": by_route["wgmma_headdim_wide"]["dkv"],
        "ms": k2g["bf16_d256_train"]["dkv_ms"],
        "plain_ms": k2g["bf16_d256_train"]["plain_bwd_ms"],
        "bound_ms": k2g["bf16_d256_train"]["dkv_bound_ms"],
        "bound_by": k2g["bf16_d256_train"]["dkv_bound_by"],
        "library_ms": k2g["bf16_d256_train"]["library_bwd_ms"],
    }, {
        "name": "flash_attention_bwd_headdim_dq (wide)",
        "route": "cuda",
        "source": "mfar_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:1456",
        "launches": f32_launches["wgmma_headdim_wide_dq"],
        "max_abs_err": by_route["wgmma_headdim_wide"]["dq"],
        "ms": k2g["bf16_d256_train"]["dq_ms"],
        "plain_ms": k2g["bf16_d256_train"]["plain_bwd_ms"],
        "bound_ms": k2g["bf16_d256_train"]["dq_bound_ms"],
        "bound_by": k2g["bf16_d256_train"]["dq_bound_by"],
        "library_ms": k2g["bf16_d256_train"]["library_bwd_ms"],
    }, {
        "name": "flash_attention_tf32_bwd_dkv (wide)",
        "route": "cuda",
        "source": "mfar_tpu_torch/csrc/flash_attention_tf32_bwd.cu",
        "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:1121",
        "launches": f32_launches["tf32_wide_dkv"],
        "max_abs_err": by_route["tf32_wide"]["dkv"],
        "ms": k2g["f32_d128_train"]["dkv_ms"],
        "plain_ms": k2g["f32_d128_train"]["plain_bwd_ms"],
        "bound_ms": k2g["f32_d128_train"]["dkv_bound_ms"],
        "bound_by": k2g["f32_d128_train"]["dkv_bound_by"],
        "library_ms": k2g["f32_d128_train"]["library_bwd_ms"],
    }, {
        "name": "flash_attention_tf32_bwd_dq (wide)",
        "route": "cuda",
        "source": "mfar_tpu_torch/csrc/flash_attention_tf32_bwd.cu",
        "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:1456",
        "launches": f32_launches["tf32_wide_dq"],
        "max_abs_err": by_route["tf32_wide"]["dq"],
        "ms": k2g["f32_d128_train"]["dq_ms"],
        "plain_ms": k2g["f32_d128_train"]["plain_bwd_ms"],
        "bound_ms": k2g["f32_d128_train"]["dq_bound_ms"],
        "bound_by": k2g["f32_d128_train"]["dq_bound_by"],
        "library_ms": k2g["f32_d128_train"]["library_bwd_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
