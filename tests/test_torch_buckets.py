"""The scatter-free bucketed hybrid ops (``mfar_tpu/ops/scoring.py:1078-1445``)
in the port against the JAX package's on the same numpy inputs.

``bucket_postings_np`` must equal JAX's bit for bit (ids, values, fields,
the bucket width), with all-padding rows, a corpus that the chunk does not
divide and a chunk no posting lands in.  The bucketed scans must give the
top-k of JAX's bucketed scans and of the port's own scatter route on the
same postings (rtol 1e-4 / atol 1e-3, ties allowed: ``eval/compare.py``),
in f32 and int8, over one chunk and several with a ragged tail.  No engine
route calls these ops, in either package.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mfar_tpu.ops import scoring as jax_scoring
from mfar_tpu_torch.eval.compare import rankings_agree
from mfar_tpu_torch.native import bucket_width
from mfar_tpu_torch.ops import scoring

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-3
FD, K = 3, 10


def _case(seed, b=4, e=16, fd=FD, fs=2, n=1000, m=96):
    """Random fused-hybrid inputs (``tests/test_scoring_ops.py::_hybrid_case``):
    duplicate docs across fields and a padded tail (value 0, id 0)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, e)).astype(np.float32)
    W = rng.normal(size=(e, fd + fs)).astype(np.float32)
    docs = rng.normal(size=(n, fd * e)).astype(np.float32)
    ids = rng.integers(0, n, size=(b, m)).astype(np.int32)
    vals = rng.uniform(0.1, 2.0, size=(b, m)).astype(np.float32)
    fidx = rng.integers(0, fs, size=(b, m)).astype(np.int8)
    npad = m // 3
    ids[:, -npad:] = 0
    vals[:, -npad:] = 0.0
    fidx[:, -npad:] = 0
    valid_n = n - 7
    ids = np.minimum(ids, valid_n - 1)
    return q, W, docs, ids, vals, fidx, valid_n


def _keyed(scores, ids):
    return [[(str(int(d)), float(s)) for d, s in zip(ir, sr) if np.isfinite(s)]
            for sr, ir in zip(np.asarray(scores), np.asarray(ids))]


def _agree(got, want):
    msg = rankings_agree(_keyed(*got), _keyed(*want), RTOL, ATOL)
    assert msg is None, msg


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _postings_case(kind):
    """Postings for the layout cases: (ids, vals, fields, n, chunk)."""
    rng = np.random.default_rng({"random": 0, "padding": 1, "empty": 2, "one": 3}[kind])
    b, m, n, chunk = 5, 40, 1000, 256  # 1000 rows: 3 full chunks and a ragged one
    ids = rng.integers(0, n, size=(b, m)).astype(np.int32)
    vals = rng.uniform(0.1, 2.0, size=(b, m)).astype(np.float32)
    fields = rng.integers(0, 3, size=(b, m)).astype(np.int8)
    if kind == "padding":
        vals[1] = 0.0  # a row of padding only
        vals[3, m // 2 :] = 0.0
    elif kind == "empty":
        ids = np.where((ids >= 256) & (ids < 512), ids - 256, ids)  # no posting in chunk 1
    elif kind == "one":
        n, chunk = 300, 512  # one chunk holds the corpus
        ids = ids % n
    return ids, vals, fields, n, chunk


@pytest.mark.parametrize("kind", ["random", "padding", "empty", "one"])
def test_bucket_postings_np_is_bit_equal_to_jax(kind):
    ids, vals, fields, n, chunk = _postings_case(kind)
    got = scoring.bucket_postings_np(ids, vals, fields, n, chunk)
    want = jax_scoring.bucket_postings_np(ids, vals, fields, n, chunk)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8))
    if kind == "empty":
        assert (got[0][:, 1] == n).all() and (got[1][:, 1] == 0).all()
    if kind == "padding":
        assert (got[0][1] == n).all()


def test_bucket_postings_np_layout():
    """JAX's layout case (``tests/test_scoring_ops.py``) on the port."""
    ids = np.array([[5, 900, 5, 0, 0], [100, 101, 102, 103, 104]], np.int32)
    vals = np.array([[1.0, 2.0, 3.0, 0.0, 0.0], [1, 1, 1, 1, 1]], np.float32)
    fidx = np.zeros_like(ids, dtype=np.int8)
    b_ids, b_vals, _ = scoring.bucket_postings_np(ids, vals, fidx, 1000, 256)
    assert b_ids.shape == (2, 4, bucket_width(5))
    assert b_ids[0, 0, 0] == 5 and b_ids[0, 0, 1] == 5 and b_ids[0, 0, 2] == 1000
    assert b_ids[0, 3, 0] == 900
    assert (b_vals[0, 0, :2] == [1.0, 3.0]).all()
    assert (b_ids[1, 0, :5] == [100, 101, 102, 103, 104]).all()
    assert (b_ids[1, 1:] == 1000).all()


@pytest.mark.parametrize("chunk", [256, 2048])  # a ragged-tail scan / one chunk
def test_fused_buckets_match_jax_and_the_scatter_route(chunk):
    q, W, docs, ids, vals, fidx, valid_n = _case(1)
    n = docs.shape[0]
    bk = scoring.bucket_postings_np(ids, vals, fidx, n, chunk)
    got = scoring.fused_hybrid_topk_buckets_from_query(
        *_t(q, W), None, *_t(docs, *bk), valid_n, FD, K, chunk_size=chunk)
    scatter = scoring.fused_hybrid_topk_postings_from_query(
        *_t(q, W), None, *_t(docs, ids, vals, fidx), valid_n, FD, K, chunk_size=chunk)
    want = jax_scoring.fused_hybrid_topk_buckets_from_query(
        *_j(q, W), None, *_j(docs, *bk), jnp.int32(valid_n), FD, K, chunk_size=chunk)
    assert got[0].shape == got[1].shape == (q.shape[0], K)
    _agree(got, want)
    _agree(got, scatter)


def test_fused_buckets_int8_match_jax_and_the_scatter_route():
    q, W, docs, ids, vals, fidx, valid_n = _case(2)
    n, chunk = docs.shape[0], 256
    dq, ds = scoring.quantize_rows_int8_np(docs)
    bk = scoring.bucket_postings_np(ids, vals, fidx, n, chunk)
    got = scoring.fused_hybrid_topk_buckets_from_query_int8(
        *_t(q, W), None, *_t(dq, ds, *bk), valid_n, FD, K, chunk_size=chunk)
    scatter = scoring.fused_hybrid_topk_postings_from_query_int8(
        *_t(q, W), None, *_t(dq, ds, ids, vals, fidx), valid_n, FD, K, chunk_size=chunk)
    want = jax_scoring.fused_hybrid_topk_buckets_from_query_int8(
        *_j(q, W), None, *_j(dq, ds, *bk), jnp.int32(valid_n), FD, K, chunk_size=chunk)
    _agree(got, want)
    _agree(got, scatter)


@pytest.mark.parametrize("int8", [False, True])
def test_bucketed_scan_matches_jax_on_weighted_postings(int8):
    """The unfused scans on premultiplied impacts and folded queries."""
    q, W, docs, ids, vals, _, valid_n = _case(5)
    n, chunk = docs.shape[0], 256
    rng = np.random.default_rng(6)
    qflat = rng.normal(size=(q.shape[0], docs.shape[1])).astype(np.float32)
    wvals = (vals * rng.uniform(0.0, 1.0, size=vals.shape)).astype(np.float32)
    b_ids, b_wv, _ = scoring.bucket_postings_np(ids, wvals, np.zeros_like(ids), n, chunk)
    if int8:
        dq, ds = scoring.quantize_rows_int8_np(docs)
        got = scoring.hybrid_topk_buckets_int8(*_t(qflat, dq, ds, b_ids, b_wv), valid_n, K,
                                               chunk_size=chunk)
        want = jax_scoring.hybrid_topk_buckets_int8(*_j(qflat, dq, ds, b_ids, b_wv),
                                                    jnp.int32(valid_n), K, chunk_size=chunk)
    else:
        got = scoring.hybrid_topk_buckets(*_t(qflat, docs, b_ids, b_wv), valid_n, K,
                                          chunk_size=chunk)
        want = jax_scoring.hybrid_topk_buckets(*_j(qflat, docs, b_ids, b_wv),
                                               jnp.int32(valid_n), K, chunk_size=chunk)
    _agree(got, want)


def test_no_duplicate_docs_in_the_topk():
    """A doc can enter a chunk's union twice (its dense entry and its
    posting candidate); the dedup keeps one entry per doc."""
    q, W, docs, ids, vals, fidx, valid_n = _case(3)
    ids = (ids % 13).astype(np.int32)  # posting docs fill the top-k
    bk = scoring.bucket_postings_np(ids, vals, fidx, docs.shape[0], 256)
    got = scoring.fused_hybrid_topk_buckets_from_query(
        *_t(q, W), None, *_t(docs, *bk), valid_n, FD, K, chunk_size=256)
    for row in got[1].tolist():
        assert len(set(row)) == len(row)
    want = jax_scoring.fused_hybrid_topk_buckets_from_query(
        *_j(q, W), None, *_j(docs, *bk), jnp.int32(valid_n), FD, K, chunk_size=256)
    _agree(got, want)


def test_all_padding_rows_rank_as_dense():
    """Queries with no postings rank as the dense scan (the sparse field
    still takes softmax mass, so rankings compare, not scores)."""
    q, W, docs, ids, vals, fidx, valid_n = _case(4, fs=1)
    vals[:] = 0.0
    bk = scoring.bucket_postings_np(ids, vals, fidx, docs.shape[0], 256)
    _, hyb_i = scoring.fused_hybrid_topk_buckets_from_query(
        *_t(q, W), None, *_t(docs, *bk), valid_n, FD, K, chunk_size=256)
    _, den_i = scoring.fused_dense_topk_from_query(
        *_t(q, W), torch.tensor([1.0, 1.0, 1.0, 0.0]), torch.from_numpy(docs), valid_n, FD, K,
        chunk_size=256)
    assert torch.equal(hyb_i, den_i)


def test_buckets_for_another_scan_raise():
    q, W, docs, ids, vals, fidx, valid_n = _case(7)
    bk = scoring.bucket_postings_np(ids, vals, fidx, docs.shape[0], 512)
    with pytest.raises(ValueError, match="bucketed for 2 chunks but the scan has 4"):
        scoring.fused_hybrid_topk_buckets_from_query(
            *_t(q, W), None, *_t(docs, *bk), valid_n, FD, K, chunk_size=256)
