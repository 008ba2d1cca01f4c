"""The port's scoring ops against ``mfar_tpu.ops.scoring`` on the same inputs.

Inputs are made with numpy from a seed and handed to both packages.  Values
compare at rtol=1e-5 (f32 on both sides; only the summation order of the
matmuls differs).  Indices compare with ties allowed: where two scores tie,
either top-k may pick either index (``mfar_tpu/ops/scoring.py:211-215``), so
the check is that each returned index carries the returned score.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mfar_tpu.ops import scoring as ref
from mfar_tpu_torch.ops import scoring as port

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-5


def _rng(seed=0):
    return np.random.default_rng(seed)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _check_topk(got_s, got_i, want_s, scores_np):
    """Values equal the reference's; each index points at its own score."""
    got_s, got_i = np.asarray(got_s), np.asarray(got_i)
    np.testing.assert_allclose(got_s, np.asarray(want_s), rtol=RTOL, atol=ATOL)
    finite = np.isfinite(got_s)
    picked = np.take_along_axis(scores_np, np.where(finite, got_i, 0), axis=-1)
    np.testing.assert_allclose(picked[finite], got_s[finite], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("layout", ["EF", "1F", "F1", "F"])
@pytest.mark.parametrize("masked", [False, True])
def test_softmax_field_weights(layout, masked):
    rng = _rng(1)
    e, f, b = 16, 4, 3
    q = rng.normal(size=(b, e)).astype(np.float32)
    w = {
        "EF": rng.normal(size=(e, f)),
        "1F": rng.normal(size=(1, f)),
        "F1": rng.normal(size=(f, 1)),
        "F": rng.normal(size=(f,)),
    }[layout].astype(np.float32)
    mask = np.array([1, 0, 1, 1], np.float32) if masked else None
    want = ref.softmax_field_weights(
        jnp.asarray(w), jnp.asarray(q), None if mask is None else jnp.asarray(mask)
    )
    got = port.softmax_field_weights(_t(w), _t(q), None if mask is None else _t(mask))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-6)
    if masked:
        assert np.all(got.numpy()[:, 1] == 0)


def test_softmax_field_weights_needs_q_for_query_conditioned():
    with pytest.raises(ValueError, match="need q"):
        port.softmax_field_weights(torch.ones(16, 4))


def test_fold_queries():
    rng = _rng(2)
    q = rng.normal(size=(3, 8)).astype(np.float32)
    w = rng.random(size=(3, 5)).astype(np.float32)
    want = ref.fold_queries(jnp.asarray(q), jnp.asarray(w))
    got = port.fold_queries(_t(q), _t(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-6)


# (n, chunk, valid_n, k): one shot; a ragged tail chunk; valid_n < n masking
# rows in the last chunk; k > n (padded with -inf); k larger than the tail
@pytest.mark.parametrize("n,chunk,valid_n,k", [
    (40, 64, 40, 5),
    (100, 32, 100, 7),
    (100, 32, 90, 7),
    (6, 64, 6, 9),
    (70, 32, 70, 20),
])
def test_dense_topk_chunked(n, chunk, valid_n, k):
    rng = _rng(3)
    qflat = rng.normal(size=(4, 24)).astype(np.float32)
    docs = rng.normal(size=(n, 24)).astype(np.float32)
    want_s, _ = ref.dense_topk_chunked(
        jnp.asarray(qflat), jnp.asarray(docs), jnp.int32(valid_n), k=k, chunk_size=chunk
    )
    got_s, got_i = port.dense_topk_chunked(_t(qflat), _t(docs), valid_n, k=k, chunk_size=chunk)
    assert got_s.shape == (4, k) and got_i.shape == (4, k)
    scores = qflat @ docs.T
    scores[:, valid_n:] = -np.inf
    _check_topk(got_s.numpy(), got_i.numpy(), want_s, scores)
    assert np.all(got_i.numpy()[np.isfinite(got_s.numpy())] < valid_n)


@pytest.mark.parametrize("n,chunk,k", [(50, 64, 6), (90, 32, 6), (5, 64, 8)])
def test_per_field_topk_chunked_approx(n, chunk, k):
    rng = _rng(4)
    f, e, b = 3, 16, 2
    q = rng.normal(size=(b, e)).astype(np.float32)
    docs = rng.normal(size=(n, f * e)).astype(np.float32)
    want_s, _ = ref.per_field_topk_chunked_approx(
        jnp.asarray(q), jnp.asarray(docs), jnp.int32(n), f, k=k, chunk_size=chunk
    )
    got_s, got_i = port.per_field_topk_chunked_approx(
        _t(q), _t(docs), n, f, k=k, chunk_size=chunk, recall_target=0.95
    )
    assert got_s.shape == (b, f, k)
    per_field = np.einsum("be,nfe->bfn", q, docs.reshape(n, f, e))
    _check_topk(got_s.numpy(), got_i.numpy(), want_s, per_field)


@pytest.mark.parametrize("with_mask", [False, True])
def test_rerank_candidates(with_mask):
    rng = _rng(5)
    b, c, fd, fs, e = 3, 16, 2, 1, 8
    q = rng.normal(size=(b, e)).astype(np.float32)
    dense = rng.normal(size=(b, c, fd)).astype(np.float32)
    sparse = rng.random(size=(b, c, fs)).astype(np.float32)
    w = rng.normal(size=(e, fd + fs)).astype(np.float32)
    mask = np.array([1, 0, 1], np.float32) if with_mask else None
    valid = np.ones((b, c), bool)
    valid[0, 10:] = False
    valid[2, 3:] = False
    kw_ref = dict(mask=None if mask is None else jnp.asarray(mask), cand_valid=jnp.asarray(valid), k=5)
    want_s, want_i = ref.rerank_candidates(
        jnp.asarray(q), jnp.asarray(dense), jnp.asarray(sparse), jnp.asarray(w), **kw_ref
    )
    got_s, got_i = port.rerank_candidates(
        _t(q), _t(dense), _t(sparse), _t(w),
        mask=None if mask is None else _t(mask), cand_valid=_t(valid), k=5,
    )
    # the mask multiplies the SCORES; the weights are computed without it
    scores = np.concatenate([dense, sparse], -1) * (1 if mask is None else mask)
    total = np.einsum("bcf,bf->bc", scores, np.asarray(ref.softmax_field_weights(jnp.asarray(w), jnp.asarray(q))))
    total[~valid] = -np.inf
    _check_topk(got_s.numpy(), got_i.numpy(), want_s, total)
    np.testing.assert_array_equal(got_i.numpy()[0], np.asarray(want_i)[0])


def test_fused_dense_topk_from_query():
    rng = _rng(6)
    b, e, fd, n = 3, 8, 2, 60
    q = rng.normal(size=(b, e)).astype(np.float32)
    w = rng.normal(size=(e, fd)).astype(np.float32)
    docs = rng.normal(size=(n, fd * e)).astype(np.float32)
    mask = np.array([1, 0], np.float32)
    want_s, _ = ref.fused_dense_topk_from_query(
        jnp.asarray(q), jnp.asarray(w), jnp.asarray(mask), jnp.asarray(docs),
        jnp.int32(n), fd, 7, chunk_size=32,
    )
    got_s, got_i = port.fused_dense_topk_from_query(
        _t(q), _t(w), _t(mask), _t(docs), n, fd, 7, chunk_size=32
    )
    wts = np.asarray(ref.softmax_field_weights(jnp.asarray(w), jnp.asarray(q), jnp.asarray(mask)))
    qflat = (wts[:, :, None] * q[:, None, :]).reshape(b, -1)
    _check_topk(got_s.numpy(), got_i.numpy(), want_s, qflat @ docs.T)


def test_scores_f32_bf16_matches_upcast():
    rng = _rng(7)
    a = torch.from_numpy(rng.normal(size=(3, 16)).astype(np.float32)).bfloat16()
    b = torch.from_numpy(rng.normal(size=(5, 16)).astype(np.float32)).bfloat16()
    got = port.scores_f32(a, b)
    assert got.dtype == torch.float32
    # bf16 products are exact in f32: the reference is the f32 product
    torch.testing.assert_close(got, a.float() @ b.float().T, rtol=RTOL, atol=1e-6)


# Each function whose sums must not depend on the batch (rerank's stage-2
# dots of gathered rows, the hybrid postings sum, the bucketed op's runs,
# the host stream's postings): a row's inputs, of a width that varies from
# row to row, padded to the batch's widest as the engine pads them.
ROW_E, ROW_F, ROW_N = 24, 3, 50


def _row_stage2(rng, w):
    return dict(cand=(_t(rng.normal(size=(w, ROW_F, ROW_E)).astype(np.float32)), 0.0),
                q=_t(rng.normal(size=ROW_E).astype(np.float32)))


def _postings(rng, w):
    """Postings that hit a few documents many times (a third of the rows)
    or spread over the corpus, with their sparse field, values > 0."""
    hi = 4 if rng.random() < 1 / 3 else ROW_N
    return (_t(rng.integers(0, hi, size=w).astype(np.int32)),
            _t(rng.uniform(0.1, 3.0, size=w).astype(np.float32)),
            _t(rng.integers(0, 2, size=w).astype(np.int8)))


def _row_postings(rng, w):
    ids, vals, field = _postings(rng, w)
    return dict(ids=(ids, 0), vals=(vals, 0.0), field=(field, 0),
                q=_t(rng.normal(size=ROW_E).astype(np.float32)))


def _row_buckets(rng, w):
    ids, vals, _ = _postings(rng, w)
    return dict(ids=(torch.sort(ids).values, ROW_N), vals=(vals, 0.0),
                s=_t(rng.normal(size=ROW_N).astype(np.float32)))


def _row_stream(rng, w):
    ids, vals, _ = _postings(rng, w)
    return dict(ids=(ids, 0), vals=(vals, 0.0),
                q=_t(rng.normal(size=ROW_F * ROW_E).astype(np.float32)))


def _stack(rows, width):
    """The rows' inputs as batch tensors: a (tensor, pad) pair pads to
    ``width`` (at least the widest row) with its pad value."""
    width = max([width] + [len(t) for r in rows for t, _ in
                           (v for v in r.values() if isinstance(v, tuple))])
    out = {}
    for key, v in rows[0].items():
        if isinstance(v, tuple):
            out[key] = torch.stack([torch.cat([r[key][0], r[key][0].new_full(
                (width - len(r[key][0]), *r[key][0].shape[1:]), r[key][1])]) for r in rows])
        else:
            out[key] = torch.stack([r[key] for r in rows])
    return out


_W_ROW = _t(_rng(5).normal(size=(ROW_E, 3)).astype(np.float32))
_DOCS_ROW = _t(_rng(6).normal(size=(ROW_N, ROW_F * ROW_E)).astype(np.float32))

ROW_CASES = {
    "stage2": (_row_stage2, lambda x: (port.per_field_candidate_scores(x["q"], x["cand"]),)),
    "postings": (_row_postings, lambda x: port._fold_and_densify(
        x["q"], _W_ROW, None, ROW_N, 1, x["ids"], x["vals"], x["field"])),
    "buckets": (_row_buckets, lambda x: port._posting_candidates(
        x["s"], x["ids"], x["vals"], 0)),
    "host-stream": (_row_stream, lambda x: port.hybrid_topk_host_streamed(
        x["q"], _DOCS_ROW, 10, chunk_size=16, post_ids=x["ids"], post_wvals=x["vals"])),
}


@pytest.mark.parametrize("batch", [1, 7, 300])
@pytest.mark.parametrize("case", sorted(ROW_CASES))
def test_a_row_is_the_same_bits_in_any_batch(case, batch):
    """Each function that sums a query's scores in a fixed order gives a
    row the same bits alone (at its own width) as in a batch of ``batch``
    rows, padded wider (a batch of 1 by 57 entries) with other rows around
    it; its outputs past the row's own width are not compared."""
    make, call = ROW_CASES[case]
    rng = _rng(3)
    row = make(rng, 40)
    alone = call(_stack([row], 0))
    mates = [make(rng, int(w)) for w in rng.integers(1, 120, size=batch - 1)]
    at = (batch - 1) // 2
    batched = call(_stack(mates[:at] + [row] + mates[at:], 40 + 57 * (batch == 1)))
    for a, b in zip(alone, batched):
        assert torch.equal(b[at][: a.shape[1]] if a.dim() > 1 else b[at], a[0]), case
