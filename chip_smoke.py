"""Smoke run of the PyTorch port on one CUDA card: build, check, serve, train.

    python3 chip_smoke.py [--seed 0]

Drives ``mfar_tpu_torch`` (and nothing of JAX or ``mfar_tpu``) end to end at
Contriever-base width with seeded random weights:

1. device    -- the card's name and power limit (nvidia-smi)
2. build     -- every CUDA kernel of the port, from ``mfar_tpu_torch/csrc``,
                one nvcc per source, all started together
3. k1        -- kernel K1 (rerank gather) against its plain PyTorch version
                for bf16 and f32 corpora at B=64 C=512 N=131072 F=5 E=768,
                plus edge cases; CUDA-event times of kernel, plain version
                and a library yardstick, beside the bytes bound
4. k2        -- kernel K2 (flash attention) against its plain PyTorch version
                at the index build's [256, 12, 512, 64] bf16 with ragged
                segments, plus edge cases (S = 128 and 256, B = 1, H = 1,
                pad rows whose first key tiles are wholly masked); times of
                kernel, plain version and a library yardstick (SDPA with the
                boolean segment mask), beside the bound
5. k2b       -- K2's logsumexp output and the backward kernels (dkv, dq)
                against their plain version at the training shape
                [96, 12, 512, 64] bf16 and edge cases; the autograd Function
                against autograd through the plain version; times of each
                kernel, the plain backward and SDPA's backward, beside the
                bounds
6. e2e       -- a synthetic mag-shaped corpus (2048 docs x 5 dense fields)
                encoded by the full-width encoder with attention_impl="auto"
                (the 512-token fields through K2), held against the same
                corpus encoded with plain attention; then the engine in
                rerank mode (through K1) and exact mode, each held against a
                reference (the plain-gather engine; a brute-force f32 scan)
7. long      -- 64 queries of 150 words (the 256-token bucket) through the
                "auto" engine (K2) against a plain-attention engine
8. cli       -- the encode_corpus command on a 512-doc dataset directory and
                a local BERT directory at Contriever-base width (seeded
                weights), both written here, into .npz and .npy, read back
                and held against the same weights built through K2
9. train     -- MFARModel at Contriever-base width on the e2e corpus: one
                batch through K2/K2b against the plain path, Trainer.fit
                (the counted main path of training), steps/s through K2/K2b
                and plain in turns, a profiled step, a trec eval over an
                index rebuilt by the trained encoder, a checkpoint round trip
10. train_cli -- the train command on a dataset directory and a BERT
                directory, one iteration on the card, then retrieve
                --checkpoint-dir on its output
11. serving  -- the same engine over a prebuilt random [131072, 5, 768] bf16
                corpus in rerank mode: QPS, one batch's stages, and the
                device's busy share and time by kernel from torch.profiler

TF32 is switched off for matmuls and cuDNN, so f32 comparisons run in full
f32.  Any failed check raises and the run exits non-zero.  The last two
lines are one JSON object with every kernel's numbers and one with
``"ok": true`` and the device.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.nn import functional as F

from mfar_tpu_torch.commands import encode_corpus
from mfar_tpu_torch.commands import retrieve as retrieve_cmd
from mfar_tpu_torch.commands import train as train_cmd
from mfar_tpu_torch.commands.common import corpus_texts_for_vocab, load_negative_sampler_index
from mfar_tpu_torch.data import trec
from mfar_tpu_torch.data.negative_sampler import IndexNegativeSampler
from mfar_tpu_torch.data.format import format_documents
from mfar_tpu_torch.data.schema import resolve_fields
from mfar_tpu_torch.data.types import Corpus
from mfar_tpu_torch.eval.compare import mismatched_queries, rankings_agree
from mfar_tpu_torch.eval.index_build import (
    build_dense_corpus_matrix,
    load_dense_matrix,
    make_encode_fn,
)
from mfar_tpu_torch.eval.retrieval import RetrievalEngine
from mfar_tpu_torch.models.encoder import Encoder, EncoderConfig, init_encoder
from mfar_tpu_torch.models.registry import prepare_model, save_bert_dir
from mfar_tpu_torch.models.tokenizer import SimpleVocabTokenizer
from mfar_tpu_torch.ops import _build
from mfar_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_bwd_plain,
    flash_attention_fwd,
    flash_attention_plain,
)
from mfar_tpu_torch.ops.gather_scores import (
    gather_per_field_scores,
    gather_per_field_scores_plain,
)
from mfar_tpu_torch.train.data_pipeline import ContrastiveDataset, strip_meta, token_stats
from mfar_tpu_torch.train.model import MFARModel
from mfar_tpu_torch.train.optim import make_optimizer, param_labels
from mfar_tpu_torch.train.train_step import init_state, to_device, train_step
from mfar_tpu_torch.train.trainer import Trainer, TrainerConfig

DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
F32_FLOPS_PER_S = 67e12  # H100 SXM f32 rate outside the tensor cores
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate

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


def run_k1(seed: int, serving_shape=(64, 512, 131072, 5, 768)) -> dict:
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    max_err = 0.0
    # edge cases at small N: odd C, B=1, F=1, C < one block of candidates
    for b, c, n, f, e in [(1, 7, 33, 1, 128), (3, 13, 101, 4, 128), (5, 1, 9, 5, 768),
                          (2, 129, 1001, 3, 256)]:
        for dtype in (torch.bfloat16, torch.float32):
            q, docs, ids = k1_inputs(gen, b, c, n, f, e, dtype)
            got = gather_per_field_scores(q, docs, ids, f)
            torch.cuda.synchronize()
            want = gather_per_field_scores_plain(q, docs, ids, f)
            err = (got - want).abs().max().item()
            check(torch.allclose(got, want, rtol=K1_RTOL, atol=K1_ATOL),
                  f"K1 {dtype} B={b} C={c} N={n} F={f} E={e}: max err {err}")
            max_err = max(max_err, err)
    phase("k1", f"edge cases (odd C, B=1, F=1, small N) agree, max abs err {max_err:.3g}")

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
        lib = library_gather_scores(q, docs, ids, f)
        check(torch.allclose(lib, want, rtol=K1_RTOL, atol=K1_ATOL), "library yardstick disagrees")
        bound_ms, bound_by, distinct = k1_bound(ids, f, e, dtype)
        r = dict(
            kernel_ms=time_cuda(lambda: gather_per_field_scores(q, docs, ids, f)),
            plain_ms=time_cuda(lambda: gather_per_field_scores_plain(q, docs, ids, f)),
            library_ms=time_cuda(lambda: library_gather_scores(q, docs, ids, f)),
            bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err, distinct_rows=distinct,
        )
        name = "bf16" if dtype == torch.bfloat16 else "f32"
        rows[name] = r
        corpus_gb = docs.numel() * docs.element_size() / 1e9
        phase("k1", f"{name} B={b} C={c} N={n} F={f} E={e} ({corpus_gb:.2f} GB corpus; "
                    f"ids distinct per query, {distinct} distinct rows of {b * c}): "
                    f"max abs err {err:.3g}; kernel_ms {r['kernel_ms']:.4f} "
                    f"plain_ms {r['plain_ms']:.4f} library_ms {r['library_ms']:.4f} "
                    f"bound_ms {bound_ms:.4f} ({bound_by}); "
                    f"{r['bound_ms'] / r['kernel_ms']:.1%} of the bound")
        del q, docs, ids, edge_ids, got, want, lib
    rows["max_abs_err"] = max_err
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


def k2_bound(q, seg):
    """Least time for K2's work on these inputs: q/k/v read once, the output
    written once, the segment ids read once, over the memory rate, against
    the two products' bf16 operations over the tensor-core rate, counted
    for the (query, key) pairs of one segment only (all the masked pairs
    add nothing); the larger one bounds it.  Returns (ms, bound_by, the
    bytes time, the operations time)."""
    b, h, s, d = q.shape
    nbytes = 4 * b * h * s * d * q.element_size() + seg.numel() * 4
    n_valid = seg.sum(dim=1).double()
    pairs = (n_valid**2 + (s - n_valid) ** 2).sum().item()
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 4 * h * d * pairs / BF16_FLOPS_PER_S * 1e3
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


def run_k2(seed: int, build_shape=(256, 12, 512)) -> dict:
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 3)
    max_err = 0.0
    # edge cases: S = 128 and 256, B = 1, H = 1, a row of 2 tokens, a full
    # row, and pad rows whose first key tiles are all valid tokens (wholly
    # masked for them: lengths 70, 131, 200)
    for b, h, s, lengths in [(1, 12, 128, [70]), (3, 1, 256, [2, 256, 131]),
                             (2, 4, 512, [512, 200]), (4, 2, 128, [128, 2, 64, 127])]:
        err = check_k2(*k2_inputs(gen, b, h, s, lengths), f"B={b} H={h} S={s} {lengths}")
        max_err = max(max_err, err)
    phase("k2", f"edge cases (S=128/256, B=1, H=1, wholly masked key tiles) agree, "
                f"max abs err {max_err:.3g}")

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
    r = dict(
        kernel_ms=time_cuda(lambda: flash_attention(q, k, v, seg, scale)),
        plain_ms=time_cuda(lambda: flash_attention_plain(q, k, v, seg, scale), reps=5, inner=2),
        library_ms=time_cuda(lambda: library_attention(q, k, v, seg, scale), reps=11, inner=5),
        bound_ms=bound_ms, bound_by=bound_by, max_abs_err=max_err,
    )
    phase("k2", f"bf16 {list(q.shape)} (segment lengths {int(lengths.min())}-"
                f"{int(lengths.max())}, mean {lengths.mean():.1f}): max abs err {err:.3g} "
                f"(tolerance rtol=atol={K2_ATOL}); kernel_ms {r['kernel_ms']:.4f} "
                f"plain_ms {r['plain_ms']:.4f} library_ms {r['library_ms']:.4f} "
                f"bound_ms {bound_ms:.4f} ({bound_by}; bytes {bytes_ms:.4f}, operations "
                f"{ops_ms:.4f}); {bound_ms / r['kernel_ms']:.1%} of the bound")
    return r


# ----------------------------------------------------------------------
# phase 5: K2b (the backward kernels) against their plain version


def k2b_bound(q, seg, n_products):
    """Least time for one backward kernel's work on these inputs: q, k, v,
    dO read once (bf16), lse and di read once (f32), the segment ids read
    once, and the kernel's gradients written once (dk and dv for dkv, dq for
    dq) over the memory rate, against its ``n_products`` products' bf16
    operations over the tensor-core rate, counted for same-segment (query,
    key) pairs only; the larger one bounds it.  Returns (ms, bound_by)."""
    b, h, s, d = q.shape
    n_out = n_products - 2  # dkv: 4 products, 2 gradients; dq: 3 products, 1 gradient
    nbytes = (4 + n_out) * b * h * s * d * q.element_size() + 2 * b * h * s * 4 + seg.numel() * 4
    n_valid = seg.sum(dim=1).double()
    pairs = (n_valid**2 + (s - n_valid) ** 2).sum().item()
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * n_products * h * d * pairs / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k2b_inputs(gen, b, h, s, lengths):
    """k2_inputs plus dO as autograd hands it to the attention: the gradient
    of the [B, S, H*D] context, viewed as [B, H, S, D]."""
    q, k, v, seg = k2_inputs(gen, b, h, s, lengths)
    dout = torch.randn(b, s, h * 64, device=DEVICE, generator=gen).bfloat16()
    return q, k, v, seg, dout.view(b, s, h, 64).transpose(1, 2)


def check_k2b(q, k, v, seg, dout, label) -> float:
    """The forward's logsumexp against the plain one, then the backward
    kernels against the plain backward on the same o and lse; returns the
    largest error relative to the largest gradient, and the largest
    absolute error of each kernel's gradients (dkv: dk and dv; dq)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    out, lse = flash_attention_fwd(q, k, v, seg, scale)
    torch.cuda.synchronize()
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    same = seg[:, None, :, None] == seg[:, None, None, :]
    want_lse = torch.logsumexp(logits.masked_fill(~same, float("-inf")), dim=-1)
    del logits
    lse_err = (lse - want_lse).abs().max().item()
    check(lse_err <= K2B_LSE_ATOL, f"K2 logsumexp {label}: max abs err {lse_err}")
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
    # them), a row of 2 tokens and a full row
    for b, h, s, lengths in [(1, 12, 128, [65]), (3, 1, 256, [2, 256, 131]),
                             (2, 4, 512, [512, 200]), (4, 2, 128, [128, 64, 127, 2]),
                             (5, 3, 256, [64, 65, 127, 131, 200])]:
        r, a = check_k2b(*k2b_inputs(gen, b, h, s, lengths), f"B={b} H={h} S={s} {lengths}")
        rel, abs_err = max(rel, r), {k: max(v, a[k]) for k, v in abs_err.items()}
    phase("k2b", f"edge cases (S=128/256, B=1, H=1, lengths 64/65/127/131/200, wholly "
                 f"masked tiles) agree, max err {rel:.3g} of the largest gradient")

    b, h, s = train_shape
    rng = np.random.default_rng(seed + 5)
    lengths = rng.integers(2, s + 1, size=b)
    lengths[0], lengths[1] = s, 2
    q, k, v, seg, dout = k2b_inputs(gen, b, h, s, lengths.tolist())
    r, a = check_k2b(q, k, v, seg, dout, f"at {list(q.shape)}")
    rel, abs_err = max(rel, r), {k: max(v, a[k]) for k, v in abs_err.items()}
    scale = 1.0 / math.sqrt(q.shape[-1])

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
    di = (out.float() * dout.float()).sum(-1).contiguous()

    def fwd_bwd():
        return torch.autograd.grad(flash_attention(*leaves, seg, scale), leaves, dout)

    lib_out = library_attention(*leaves, seg, scale)
    r = dict(
        dkv_ms=time_cuda(lambda: flash_attention_bwd_dkv(q, k, v, seg, lse, di, dout, scale)),
        dq_ms=time_cuda(lambda: flash_attention_bwd_dq(q, k, v, seg, lse, di, dout, scale)),
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
        function_max_rel_err=fn_rel,
    )
    r["dkv_bound_ms"], r["dkv_bound_by"] = k2b_bound(q, seg, 4)
    r["dq_bound_ms"], r["dq_bound_by"] = k2b_bound(q, seg, 3)
    phase("k2b", f"bf16 {list(q.shape)} (segment lengths {int(lengths.min())}-"
                 f"{int(lengths.max())}, mean {lengths.mean():.1f}, dO as strided views): "
                 f"max err {rel:.3g} of the largest gradient (max abs err dkv "
                 f"{abs_err['dkv']:.3g}, dq {abs_err['dq']:.3g}), "
                 f"autograd Function vs plain "
                 f"autograd {fn_rel:.3g} (tolerance rtol {K2B_RTOL}, atol {K2B_ATOL_REL} x "
                 f"max |grad|); dkv_ms {r['dkv_ms']:.4f} (bound {r['dkv_bound_ms']:.4f}, "
                 f"{r['dkv_bound_by']}; {r['dkv_bound_ms'] / r['dkv_ms']:.1%}), dq_ms "
                 f"{r['dq_ms']:.4f} (bound {r['dq_bound_ms']:.4f}, {r['dq_bound_by']}; "
                 f"{r['dq_bound_ms'] / r['dq_ms']:.1%}); backward with di "
                 f"{r['bwd_ms']:.4f}, plain backward {r['plain_bwd_ms']:.4f}, SDPA backward "
                 f"{r['library_bwd_ms']:.4f}; K2 forward+backward through autograd "
                 f"{r['fwd_bwd_ms']:.4f}, SDPA forward+backward {r['library_fwd_bwd_ms']:.4f}; "
                 f"dO copies {flash_attention_bwd.dout_copies}")
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
        batch_device_ms=profiles, rerank_qps=n_queries / rerank_s,
        exact_qps=n_queries / exact_s,
    )


# ----------------------------------------------------------------------
# phase 6: long queries through K2


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
    n_batches = math.ceil(n / batch_size)
    check(launches == n_layers * n_batches,
          f"long queries launched K2 {launches} times, want {n_layers * n_batches}")
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
# phase 7: the encode_corpus command


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


def write_bert_dir(path, corpus, seed):
    """A local BERT directory at Contriever-base width: seeded weights and a
    WordPiece vocab of the corpus's most common words.  Returns the config
    and the number of tokenizer entries."""
    counts = collections.Counter(
        w for t in corpus_texts_for_vocab(corpus, resolve_fields("all_dense", "mag"))
        for w in t.lower().split())
    cfg = EncoderConfig.contriever_base()
    words = [w for w, _ in counts.most_common(cfg.vocab_size - 5)]  # after 5 specials
    save_bert_dir(path, cfg, init_encoder(cfg, seed=seed).state_dict(), words)
    return cfg, len(words) + 5


def run_cli(seed, corpus, n_docs=512):
    """The command as a user runs it on a model directory: a dataset
    directory of the first ``n_docs`` documents (the reference's ``corpus``
    file: key, tab, JSON payload) and a local BERT directory at
    Contriever-base width (seeded weights, a WordPiece vocab of the corpus's
    words), encoded into .npz and .npy and read back.  The command builds
    the encoder as ``prepare_model`` configures it (attention "xla"), so it
    launches no K2; its matrix is held against the same directory's weights
    built through K2 ("auto")."""
    pairs = list(corpus.pairs())[:n_docs]
    sub = Corpus.from_pairs(pairs, dataset_name="mag")
    field_info = resolve_fields("all_dense", "mag")
    with tempfile.TemporaryDirectory() as d:
        data, bert = os.path.join(d, "data"), os.path.join(d, "bert")
        write_data_dir(data, pairs)
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
    n_seq = n_docs * len(field_info)
    phase("cli", f"encode_corpus on the card with a local BERT directory (hidden "
                 f"{config.hidden_size} x {config.num_layers} layers, {config.dtype}, WordPiece "
                 f"vocab {tok.vocab_size}): {n_docs} docs x {len(field_info)} fields -> .npz in "
                 f"{cli_s[0]:.2f}s, .npy in {cli_s[1]:.2f}s (model load and tokenization "
                 f"included), the same matrix {mats[0].shape}, keys read back; the same "
                 f"weights built through K2 in {k2_s:.2f}s ({n_seq / k2_s:.0f} field-docs/s, "
                 f"{launches} launches); the command's matrix against it: {agree}")
    return dict(cli_s=cli_s, cli_k2_build_s=k2_s)


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
        opt_a, opt_b = state.optimizer.state_dict(), restored.optimizer.state_dict()
        check(opt_a["param_groups"] == opt_b["param_groups"], "restored optimizer groups differ")
        for i, st in opt_a["state"].items():
            for k, v in st.items():
                check(torch.equal(torch.as_tensor(v), torch.as_tensor(opt_b["state"][i][k])),
                      f"restored optimizer state {i}.{k} differs")
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
# phase 10: the train command, then retrieve from its checkpoint


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
# phase 11: serving scale


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


def device_profile(fn, top: int = 8, host_top: int = 0) -> dict:
    """Run ``fn()`` once under ``torch.profiler``: wall time, the summed
    time of the device's kernels (one stream, so busy time), their share of
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
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    phase("device", f"{kind}; torch {torch.__version__} CUDA {torch.version.cuda}; "
                    f"TF32 off (matmul and cuDNN)")
    print(smi.splitlines()[0], flush=True)

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(_build.SOURCES)) as pool:
        logs = list(pool.map(_build.build, _build.SOURCES))  # one nvcc per source
    build_s = time.perf_counter() - t0
    regs = [ln.strip() for log in logs for ln in log.splitlines() if "registers" in ln]
    phase("build", f"{sorted(_build.SOURCES)} built in {build_s:.2f}s ({'; '.join(regs)})")

    k1 = run_k1(args.seed)
    k2 = run_k2(args.seed)
    k2b = run_k2b(args.seed)
    engine, plain_engine, corpus, queries, e2e = run_e2e(args.seed)
    long = run_long(args.seed, engine, plain_engine, corpus,
                    EncoderConfig.contriever_base().num_layers)
    del plain_engine
    cli = run_cli(args.seed, corpus)
    train = run_train(args.seed, corpus, engine.tokenizer)
    train_cli = run_train_cli(args.seed, corpus)
    serving = run_serving(args.seed, engine, queries)

    k1_row = k1["bf16"]
    phase("summary", json.dumps({"k1_f32": k1["f32"], "k1_bf16": k1_row, "k2": k2, "k2b": k2b,
                                 **e2e, **long, **cli, **train, **train_cli, **serving}))
    print(json.dumps({"kernels": [{
        "name": "gather_per_field_scores",
        "route": "cuda",
        "source": "mfar_tpu_torch/csrc/gather_scores.cu",
        "replaces": "mfar_tpu/ops/pallas_kernels.py:192",
        "launches": e2e["k1_launches"],
        "max_abs_err": k1["max_abs_err"],
        "ms": k1_row["kernel_ms"],
        "plain_ms": k1_row["plain_ms"],
        "bound_ms": k1_row["bound_ms"],
        "bound_by": k1_row["bound_by"],
        "library_ms": k1_row["library_ms"],
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "mfar_tpu_torch/csrc/flash_attention.cu",
        "replaces": "mfar_tpu/models/encoder.py:170",
        "launches": e2e["k2_launches"],
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
        "launches": train["train_launches"][1],
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
        "launches": train["train_launches"][2],
        "max_abs_err": k2b["dq_max_abs_err"],
        "ms": k2b["dq_ms"],
        "plain_ms": k2b["plain_bwd_ms"],
        "bound_ms": k2b["dq_bound_ms"],
        "bound_by": k2b["dq_bound_by"],
        "library_ms": k2b["library_bwd_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
