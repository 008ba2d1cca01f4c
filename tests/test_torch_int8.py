"""The int8 corpus: the port's quantization, int8 scans and engine routes on
the CPU against the JAX package's, on the same inputs.

Quantization must agree bit for bit (values and scales), in the device
(torch) and the host (numpy) versions.  The scans take the same numpy
quantized corpus and queries in both packages and must give the same ids and
scores (rtol 2e-6: both compute exact int32 sums and the same f32 multiplies;
only the folded queries' softmax may differ in the last bit).  The engines
get the same dense matrix, mixer and query encoder (a seeded embedding
table, mean-pooled) and are compared with ties allowed at rtol 1e-4 / atol
1e-3 (``eval/compare.py``), routes by ``last_serve_path``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mfar_tpu.data.format import format_documents as jax_format_documents
from mfar_tpu.data.schema import resolve_fields as jax_resolve_fields
from mfar_tpu.data.synth import make_amazon_corpus, make_queries_and_qrels
from mfar_tpu.eval.retrieval import RetrievalEngine as JaxEngine
from mfar_tpu.models import SimpleVocabTokenizer as JaxTokenizer
from mfar_tpu.ops import scoring as jax_scoring
from mfar_tpu.sparse.bm25 import BM25Index as JaxBM25
from mfar_tpu_torch.data.format import format_documents
from mfar_tpu_torch.data.schema import resolve_fields
from mfar_tpu_torch.eval.compare import rankings_agree
from mfar_tpu_torch.eval.retrieval import RetrievalEngine
from mfar_tpu_torch.models.tokenizer import SimpleVocabTokenizer
from mfar_tpu_torch.ops import scoring
from mfar_tpu_torch.sparse.bm25 import BM25Index

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-3
E = 32
N_DOCS = 200
DENSE = "title_dense,description_dense"
SPARSE = "title_sparse,feature_sparse"
# every document's title holds "model" and its features "feature" and "kg":
# a batch of these queries has postings denser than half the corpus
DENSE_POSTINGS = ["model feature red lamp", "kg model feature weight", "model kg"]


def _agree(got, want):
    msg = rankings_agree(got, want, RTOL, ATOL)
    assert msg is None, msg


def _np(t):
    return np.asarray(t)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


# ----------------------------------------------------------------------
# quantization


def _rows(kind):
    rng = np.random.default_rng(11)
    x = rng.normal(size=(40, 48)).astype(np.float32)
    if kind == "edges":
        x[0] = 0.0  # the 1e-12 floor
        x[1] = np.linspace(-127, 127, 48) / 127.0 * 3.0  # values on .5 steps
        x[2, :4] = [0.5, 1.5, 2.5, 127.0]  # half to even
        x[2, 4:] = 0.0
        x[3] = 1e-30  # underflow towards the floor
        x[4] = -x[4] * 1e6
    return x


@pytest.mark.parametrize("kind", ["normal", "edges"])
@pytest.mark.parametrize("version", ["torch", "numpy"])
def test_quantization_is_bit_equal_to_jax(kind, version):
    x = _rows(kind)
    want_q, want_s = jax_scoring.quantize_rows_int8(jnp.asarray(x))
    np_q, np_s = jax_scoring.quantize_rows_int8_np(x)
    np.testing.assert_array_equal(_np(want_q), np_q)
    np.testing.assert_array_equal(_bits(want_s), _bits(np_s))
    if version == "torch":
        q, s = (t.numpy() for t in scoring.quantize_rows_int8(torch.from_numpy(x)))
    else:
        q, s = scoring.quantize_rows_int8_np(x)
    assert q.dtype == np.int8 and s.dtype == np.float32
    np.testing.assert_array_equal(q, np_q)
    np.testing.assert_array_equal(_bits(s), _bits(np_s))


@pytest.mark.parametrize("source", ["numpy", "tensor", "bf16 tensor"])
def test_quantization_in_slabs_equals_one_pass(source):
    """``quantize_rows_int8_into`` in slabs of 7 rows (ragged last slab)
    equals one whole-matrix pass; a bf16 tensor quantizes its exact f32
    values."""
    x = _rows("normal")
    src = {"numpy": x, "tensor": torch.from_numpy(x),
           "bf16 tensor": torch.from_numpy(x).bfloat16()}[source]
    want = x if source != "bf16 tensor" else src.float().numpy()
    q = torch.empty(x.shape, dtype=torch.int8)
    s = torch.empty(x.shape[0])
    scoring.quantize_rows_int8_into(src, q, s, rows=7)
    wq, ws = jax_scoring.quantize_rows_int8_np(want)
    np.testing.assert_array_equal(q.numpy(), wq)
    np.testing.assert_array_equal(_bits(s.numpy()), _bits(ws))


@pytest.mark.parametrize("m,c,depth", [(1, 8, 16), (17, 13, 24), (30, 1, 12), (5, 21, 1540)])
def test_int8_dot_is_exact_int32(m, c, depth):
    """One query row (a daemon batch of 1), row counts that are not a
    multiple of 8 and a depth that is not: the padding around
    ``torch._int_mm`` leaves the exact integer product."""
    rng = np.random.default_rng(m * 100 + c)
    a = rng.integers(-127, 128, size=(m, depth), dtype=np.int8)
    b = rng.integers(-127, 128, size=(c, depth), dtype=np.int8)
    got = scoring.int8_dot(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32 and got.shape == (m, c)
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ b.astype(np.int64).T)


# ----------------------------------------------------------------------
# the int8 scans against the JAX package's


def _scan_inputs(n, b=5, fe=64, seed=4, correlated=False):
    rng = np.random.default_rng(seed)
    if correlated:
        # near-identical positive rows: the int8 dots reach 127**2 * fe
        docs = (1.0 + 0.01 * rng.random(size=(n, fe))).astype(np.float32)
        q = (1.0 + 0.01 * rng.random(size=(b, fe))).astype(np.float32)
    else:
        docs = rng.normal(size=(n, fe)).astype(np.float32)
        q = rng.normal(size=(b, fe)).astype(np.float32)
    dq, ds = jax_scoring.quantize_rows_int8_np(docs)
    return q, dq, ds


@pytest.mark.parametrize("n,chunk,k", [(1000, 256, 40), (300, 512, 30), (520, 256, 7)])
def test_dense_scan_matches_jax(n, chunk, k):
    q, dq, ds = _scan_inputs(n)
    want = jax_scoring.dense_topk_chunked_int8(
        jnp.asarray(q), jnp.asarray(dq), jnp.asarray(ds), jnp.int32(n), k, chunk_size=chunk)
    got = scoring.dense_topk_chunked_int8(
        torch.from_numpy(q), torch.from_numpy(dq), torch.from_numpy(ds), n, k,
        chunk_size=chunk)
    np.testing.assert_array_equal(got[1].numpy(), _np(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), _np(want[0]))


def test_correlated_rows_past_f32_exactness_match_jax():
    """Dots of 127**2 * 1536 = 24.8M > 2**24: an f32 product of the int8
    values would round them; the exact int32 sums give JAX's scores bit for
    bit."""
    n, fe = 96, 1536
    q, dq, ds = _scan_inputs(n, b=3, fe=fe, correlated=True)
    q8 = jax_scoring.quantize_rows_int8_np(q)[0]
    exact = q8.astype(np.int64) @ dq.astype(np.int64).T
    assert exact.max() > 2 ** 24
    as_f32 = q8.astype(np.float32) @ dq.astype(np.float32).T
    assert not np.array_equal(as_f32.astype(np.int64), exact)  # f32 is not exact here
    want = jax_scoring.dense_topk_chunked_int8(
        jnp.asarray(q), jnp.asarray(dq), jnp.asarray(ds), jnp.int32(n), 20, chunk_size=64)
    got = scoring.dense_topk_chunked_int8(
        torch.from_numpy(q), torch.from_numpy(dq), torch.from_numpy(ds), n, 20, chunk_size=64)
    np.testing.assert_array_equal(got[0].numpy(), _np(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), _np(want[1]))


@pytest.mark.parametrize("n,chunk", [(1000, 256), (300, 512)])
def test_hybrid_scan_matches_jax(n, chunk):
    q, dq, ds = _scan_inputs(n, seed=8)
    rng = np.random.default_rng(9)
    comb = np.zeros((q.shape[0], n), np.float32)
    ids = rng.integers(0, n, size=(q.shape[0], 64))
    np.add.at(comb, (np.arange(q.shape[0])[:, None], ids), 3 * np.abs(rng.normal(size=ids.shape)))
    want = jax_scoring.hybrid_topk_chunked_int8(
        jnp.asarray(q), jnp.asarray(dq), jnp.asarray(ds), jnp.asarray(comb), jnp.int32(n),
        k=30, chunk_size=chunk)
    got = scoring.hybrid_topk_chunked_int8(
        torch.from_numpy(q), torch.from_numpy(dq), torch.from_numpy(ds),
        torch.from_numpy(comb), n, k=30, chunk_size=chunk)
    np.testing.assert_array_equal(got[1].numpy(), _np(want[1]))
    np.testing.assert_allclose(got[0].numpy(), _np(want[0]), rtol=2e-6)


def _fused_inputs(n, b=4, e=16, fd=2, fs=2, seed=5):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, e)).astype(np.float32)
    W = rng.normal(scale=0.3, size=(e, fd + fs)).astype(np.float32)
    docs = rng.normal(size=(n, fd * e)).astype(np.float32)
    dq, ds = jax_scoring.quantize_rows_int8_np(docs)
    ids = rng.integers(0, n, size=(b, 48)).astype(np.int32)
    vals = np.abs(rng.normal(size=(b, 48))).astype(np.float32)
    fidx = rng.integers(0, fs, size=(b, 48)).astype(np.int8)
    mask = np.array([1, 0, 1, 1], np.float32)
    return q, W, dq, ds, ids, vals, fidx, mask


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("fused", ["dense", "hybrid"])
def test_fused_from_query_matches_jax(fused, masked):
    n, fd = 300, 2
    q, W, dq, ds, ids, vals, fidx, mask = _fused_inputs(n)
    jm = jnp.asarray(mask) if masked else None
    pm = torch.from_numpy(mask) if masked else None
    t = torch.from_numpy
    if fused == "dense":
        want = jax_scoring.fused_dense_topk_from_query_int8(
            jnp.asarray(q), jnp.asarray(W), jm, jnp.asarray(dq), jnp.asarray(ds),
            jnp.int32(n), fd, 25, chunk_size=128)
        got = scoring.fused_dense_topk_from_query_int8(
            t(q), t(W), pm, t(dq), t(ds), n, fd, 25, chunk_size=128)
    else:
        want = jax_scoring.fused_hybrid_topk_postings_from_query_int8(
            jnp.asarray(q), jnp.asarray(W), jm, jnp.asarray(dq), jnp.asarray(ds),
            jnp.asarray(ids), jnp.asarray(vals), jnp.asarray(fidx), jnp.int32(n), fd, 25,
            chunk_size=128)
        got = scoring.fused_hybrid_topk_postings_from_query_int8(
            t(q), t(W), pm, t(dq), t(ds), t(ids), t(vals), t(fidx), n, fd, 25,
            chunk_size=128)
    np.testing.assert_array_equal(got[1].numpy(), _np(want[1]))
    np.testing.assert_allclose(got[0].numpy(), _np(want[0]), rtol=2e-6, atol=1e-6)


# ----------------------------------------------------------------------
# the engine's int8 routes against the JAX engine


def _indices(pkg_bm25, fmt, corpus_pairs, fields):
    return {fk: pkg_bm25.create(fmt(corpus_pairs, f.name, "amazon"), name=f.name,
                                backend="scipy")
            for fk, f in fields.items() if f.is_sparse}


@pytest.fixture(scope="module")
def world():
    corpus = make_amazon_corpus(N_DOCS)
    queries = list(make_queries_and_qrels(corpus, n_queries=10)[0].values())
    pairs = list(corpus.pairs())
    rng = np.random.default_rng(0)
    texts = [t for f in ("title", "description")
             for _, t in jax_format_documents(pairs, f, "amazon")]
    jtok = JaxTokenizer.build(texts + queries + DENSE_POSTINGS, max_length=32)
    ptok = SimpleVocabTokenizer.build(texts + queries + DENSE_POSTINGS, max_length=32)
    table = rng.normal(size=(jtok.vocab_size, E)).astype(np.float32)
    matrix = rng.normal(size=(N_DOCS, 2, E)).astype(np.float32)
    mixer = rng.normal(scale=0.3, size=(E, 4)).astype(np.float32)

    def jax_encode(ids, mask):
        m = jnp.asarray(mask, jnp.float32)[..., None]
        return (jnp.asarray(table)[ids] * m).sum(1) / m.sum(1)

    def port_encode(ids, mask):
        ids, m = torch.as_tensor(ids), torch.as_tensor(mask, dtype=torch.float32)[..., None]
        return (torch.from_numpy(table)[ids] * m).sum(1) / m.sum(1)

    def engines(fields, **port_over):
        jfi, pfi = jax_resolve_fields(fields, "amazon"), resolve_fields(fields, "amazon")
        w = mixer[:, : len(pfi)]
        common = dict(doc_keys=list(corpus.keys()), query_max_length=32, recall_k=10,
                      dense_matrix=matrix, quantize="int8")
        jeng = JaxEngine(**common, field_info=jfi, encode_fn=jax_encode, tokenizer=jtok,
                         mixer_params={"weight": jnp.asarray(w)},
                         sparse_indices=_indices(JaxBM25, jax_format_documents, pairs, jfi),
                         use_pallas_gather=False)
        peng = RetrievalEngine(**{**common, **port_over}, field_info=pfi,
                               encode_fn=port_encode, tokenizer=ptok,
                               mixer_params={"weight": w},
                               sparse_indices=_indices(BM25Index, format_documents, pairs,
                                                       pfi),
                               device="cpu")
        return jeng, peng

    return dict(queries=queries, matrix=matrix, engines=engines)


@pytest.mark.parametrize("fields,batch,mode,jax_route,port_route", [
    (DENSE, "queries", "exact", "singlechip-int8-dense", "singlechip-int8-dense"),
    (f"{DENSE},{SPARSE}", "queries", "exact", "singlechip-int8-hybrid-postings",
     "singlechip-int8-hybrid-postings"),
    (f"{DENSE},{SPARSE}", "dense", "exact", "singlechip-int8-hybrid-combined",
     "singlechip-int8-hybrid-combined"),
    (DENSE, "queries", "rerank", None, "singlechip-rerank-int8"),
    (f"{DENSE},{SPARSE}", "queries", "rerank", None, "singlechip-rerank-hybrid-int8"),
])
def test_engine_int8_routes_match_jax(world, fields, batch, mode, jax_route, port_route):
    jeng, peng = world["engines"](fields)
    assert not peng.use_gather_kernel and peng.docs_flat is None
    qs = world["queries"] if batch == "queries" else DENSE_POSTINGS
    want = jeng.retrieve(qs, top_k=10, mode=mode)
    got = peng.retrieve(qs, top_k=10, mode=mode)
    if jax_route:
        assert jeng.last_serve_path == jax_route
    assert peng.last_serve_path == port_route
    _agree(got, want)


def test_engine_quantizes_as_jax_does(world):
    """The corpus the engine holds is the JAX engine's, bit for bit, from a
    numpy matrix (quantized on the host) and from a tensor (quantized where
    it lies)."""
    jeng, peng = world["engines"](DENSE)
    np.testing.assert_array_equal(peng.docs_q.numpy(), _np(jeng.docs_q))
    np.testing.assert_array_equal(_bits(peng.doc_scales.numpy()), _bits(_np(jeng.doc_scales)))
    _, from_tensor = world["engines"](DENSE, dense_matrix=torch.from_numpy(world["matrix"]))
    assert torch.equal(from_tensor.docs_q, peng.docs_q)
    assert torch.equal(from_tensor.doc_scales, peng.doc_scales)


def test_engine_int8_with_k1_forced_raises(world):
    with pytest.raises(ValueError, match="K1"):
        world["engines"](DENSE, use_pallas_gather=True)


def test_retrieve_many_and_dispatch_over_int8(world):
    """The batching and the daemon's split serve the int8 route unchanged."""
    _, peng = world["engines"](DENSE)
    qs = world["queries"]
    want = peng.retrieve(qs, top_k=10)
    _agree(peng.retrieve_many(qs, top_k=10, batch_size=3), want)
    _agree(peng.finish(peng.dispatch(qs, top_k=10)), want)
    assert peng.last_serve_path == "singlechip-int8-dense"
