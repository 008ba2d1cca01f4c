"""Hybrid (dense + BM25) retrieval: the port's engine on the CPU against the
JAX engine, on the same inputs.

Both engines get the same numpy-seeded dense matrix, mixer weights and
queries, and BM25 indices built by each package's scipy backend over the
same formatted fields.  Queries are encoded by the same function in each
framework (a seeded embedding table, mean-pooled over the tokens of each
package's copy of one tokenizer), so the engines differ only in their
scoring.  Scores compare at rtol 1e-4 / atol 1e-3 with ties allowed
(``eval/compare.py``), routes by ``last_serve_path``.
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


def _indices(pkg_bm25, fmt, corpus_pairs, fields, pairs_of=None):
    out = {}
    for fk, f in fields.items():
        if f.is_sparse:
            pairs = fmt(corpus_pairs, f.name, "amazon")
            out[fk] = pkg_bm25.create(pairs_of(pairs) if pairs_of else pairs, name=f.name,
                                      backend="scipy")
    return out


@pytest.fixture(scope="module")
def world():
    corpus = make_amazon_corpus(N_DOCS)
    queries = list(make_queries_and_qrels(corpus, n_queries=10)[0].values())
    pairs = list(corpus.pairs())
    rng = np.random.default_rng(0)
    texts = [t for f in ("title", "description") for _, t in jax_format_documents(pairs, f, "amazon")]
    jtok = JaxTokenizer.build(texts + queries + DENSE_POSTINGS, max_length=32)
    ptok = SimpleVocabTokenizer.build(texts + queries + DENSE_POSTINGS, max_length=32)
    table = rng.normal(size=(jtok.vocab_size, E)).astype(np.float32)
    matrix = rng.normal(size=(N_DOCS, 2, E)).astype(np.float32)
    n_fields = 2 + len(SPARSE.split(","))
    mixer = rng.normal(scale=0.3, size=(E, n_fields)).astype(np.float32)

    def jax_encode(ids, mask):
        m = jnp.asarray(mask, jnp.float32)[..., None]
        return (jnp.asarray(table)[ids] * m).sum(1) / m.sum(1)

    def port_encode(ids, mask):
        ids, m = torch.as_tensor(ids), torch.as_tensor(mask, dtype=torch.float32)[..., None]
        return (torch.from_numpy(table)[ids] * m).sum(1) / m.sum(1)

    def kws(fields, with_dense=True, mixer_w=mixer, **over):
        jfi = jax_resolve_fields(fields, "amazon")
        pfi = resolve_fields(fields, "amazon")
        common = dict(doc_keys=list(corpus.keys()), query_max_length=32, recall_k=10)
        jkw = dict(common, field_info=jfi, encode_fn=jax_encode, tokenizer=jtok,
                   mixer_params={"weight": jnp.asarray(mixer_w)},
                   dense_matrix=matrix if with_dense else None,
                   sparse_indices=_indices(JaxBM25, jax_format_documents, pairs, jfi),
                   use_pallas_gather=False)
        pkw = dict(common, field_info=pfi, encode_fn=port_encode, tokenizer=ptok,
                   mixer_params={"weight": mixer_w},
                   dense_matrix=matrix if with_dense else None,
                   sparse_indices=_indices(BM25Index, format_documents, pairs, pfi),
                   device="cpu")
        jkw.update(over.get("jax", {}))
        pkw.update(over.get("port", {}))
        return jkw, pkw

    return dict(corpus=corpus, pairs=pairs, queries=queries, matrix=matrix, mixer=mixer,
                kws=kws)


@pytest.mark.parametrize("batch,route", [
    ("queries", "singlechip-hybrid-postings"),
    ("dense", "singlechip-hybrid-combined"),
])
def test_exact_routes_match_jax(world, batch, route):
    jkw, pkw = world["kws"](f"{DENSE},{SPARSE}")
    qs = world["queries"] if batch == "queries" else DENSE_POSTINGS
    jeng, peng = JaxEngine(**jkw), RetrievalEngine(**pkw)
    want = jeng.retrieve(qs, top_k=10, mode="exact")
    got = peng.retrieve(qs, top_k=10, mode="exact")
    assert peng.last_serve_path == jeng.last_serve_path == route
    _agree(got, want)


@pytest.mark.parametrize("gather", ["auto", False])
def test_rerank_with_sparse_stages_matches_jax(world, gather):
    """Stage 1b (per-field BM25 recall) and stage 2's sparse columns; the
    dense part through K1's wrapper (its plain version on the CPU) or the
    plain gather."""
    jkw, pkw = world["kws"](f"{DENSE},{SPARSE}", port={"use_pallas_gather": gather})
    want = JaxEngine(**jkw).retrieve(world["queries"], top_k=10, mode="rerank")
    peng = RetrievalEngine(**pkw)
    got = peng.retrieve(world["queries"], top_k=10, mode="rerank")
    assert peng.last_serve_path == ("singlechip-rerank-hybrid-k1" if gather else
                                    "singlechip-rerank-hybrid-plain")
    _agree(got, want)


@pytest.mark.parametrize("mode,route", [
    ("exact", "host-sparse-only"), ("rerank", "singlechip-rerank-sparse-only")])
def test_sparse_only_engine_matches_jax(world, mode, route):
    mixer = world["mixer"][:, :2]
    jkw, pkw = world["kws"](SPARSE, with_dense=False, mixer_w=mixer)
    jeng, peng = JaxEngine(**jkw), RetrievalEngine(**pkw)
    want = jeng.retrieve(world["queries"], top_k=10, mode=mode)
    got = peng.retrieve(world["queries"], top_k=10, mode=mode)
    assert peng.last_serve_path == route and not peng.has_dense
    if mode == "exact":
        assert jeng.last_serve_path == route
    _agree(got, want)


@pytest.mark.parametrize("masked", ["one_sparse", "all_sparse", "all_dense", "one_dense"])
@pytest.mark.parametrize("mode", ["exact", "rerank"])
def test_masks_match_jax(world, masked, mode):
    jkw, pkw = world["kws"](f"{DENSE},{SPARSE}")
    n = 4
    zero = {"one_sparse": [3], "all_sparse": [2, 3], "all_dense": [0, 1],
            "one_dense": [1]}[masked]
    mask = np.ones(n, np.float32)
    mask[zero] = 0.0
    jeng, peng = JaxEngine(**jkw), RetrievalEngine(**pkw)
    jeng.set_mask(mask)
    peng.set_mask(mask)
    got = peng.retrieve(world["queries"], top_k=10, mode=mode)
    _agree(got, jeng.retrieve(world["queries"], top_k=10, mode=mode))


def test_all_sparse_masked_equals_dense_only(world):
    """The masked hybrid engine scores as an engine without sparse fields
    whose mixer keeps the hybrid's softmax over all four fields."""
    _, pkw = world["kws"](f"{DENSE},{SPARSE}")
    mask = np.array([1, 1, 0, 0], np.float32)
    hybrid = RetrievalEngine(**pkw, mask=mask)
    got = hybrid.retrieve(world["queries"], top_k=10, mode="exact")
    q = hybrid.encode_queries(world["queries"])
    w = torch.softmax(q @ torch.from_numpy(world["mixer"]), -1)[:, :2]
    docs = torch.from_numpy(world["matrix"])
    total = torch.einsum("be,nfe,bf->bn", q, docs, w)
    top_s, top_i = torch.topk(total, 10)
    _agree(got, hybrid._to_keyed(top_s.numpy(), top_i.numpy()))


@pytest.mark.parametrize("mode", ["exact", "rerank"])
def test_misaligned_prebuilt_index_matches_jax(world, mode):
    """A prebuilt BM25 index over a shuffled subset of the corpus: absent
    docs score 0, and present ones score by key, in both packages."""
    rng = np.random.default_rng(3)
    keep = rng.permutation(N_DOCS)[:30]

    def subset(pairs):
        return [pairs[i] for i in keep]

    fields = f"{DENSE},title_sparse"
    jkw, pkw = world["kws"](fields)
    jkw["sparse_indices"] = _indices(JaxBM25, jax_format_documents, world["pairs"],
                                     jax_resolve_fields(fields, "amazon"), subset)
    pkw["sparse_indices"] = _indices(BM25Index, format_documents, world["pairs"],
                                     resolve_fields(fields, "amazon"), subset)
    mixer = world["mixer"][:, :3]
    jkw["mixer_params"] = {"weight": jnp.asarray(mixer)}
    pkw["mixer_params"] = {"weight": mixer}
    peng = RetrievalEngine(**pkw)
    assert peng._sparse_row_map["title_sparse"] is not None
    got = peng.retrieve(world["queries"], top_k=10, mode=mode)
    _agree(got, JaxEngine(**jkw).retrieve(world["queries"], top_k=10, mode=mode))


@pytest.mark.parametrize("mode", ["exact", "rerank"])
def test_retrieve_many_ragged_tail_matches_jax(world, mode):
    jkw, pkw = world["kws"](f"{DENSE},{SPARSE}")
    qs = world["queries"] + DENSE_POSTINGS[:1]  # 11 queries: batches of 4, 4 and 3
    want = JaxEngine(**jkw).retrieve_many(qs, top_k=10, mode=mode, batch_size=4)
    peng = RetrievalEngine(**pkw)
    got = peng.retrieve_many(qs, top_k=10, mode=mode, batch_size=4)
    assert len(got) == len(qs)
    _agree(got, want)
    # the same as one batch
    _agree(got, peng.retrieve(qs, top_k=10, mode=mode))


def test_engine_without_an_index_for_a_sparse_field_raises(world):
    _, pkw = world["kws"](f"{DENSE},{SPARSE}")
    pkw["sparse_indices"].pop("title_sparse")
    with pytest.raises(ValueError, match="title_sparse"):
        RetrievalEngine(**pkw)


def _ops_inputs(seed=0, b=3, n=50, fd=2, fs=2, e=8, m=40):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, e)).astype(np.float32)
    docs = rng.normal(size=(n, fd * e)).astype(np.float32)
    W = rng.normal(size=(e, fd + fs)).astype(np.float32)
    ids = rng.integers(0, n, size=(b, m)).astype(np.int32)
    ids[:, -5:] = 0  # padding: id 0, value 0
    vals = rng.uniform(0.1, 3.0, size=(b, m)).astype(np.float32)
    vals[:, -5:] = 0.0
    fidx = rng.integers(0, fs, size=(b, m)).astype(np.int8)
    comb = rng.uniform(0, 2, size=(b, n)).astype(np.float32)
    return q, docs, W, ids, vals, fidx, comb


@pytest.mark.parametrize("valid_n", [50, 37])
def test_hybrid_ops_match_jax_below_one_chunk(valid_n):
    """Chunk 16 < N = 50 (a ragged tail chunk), duplicate posting ids, and
    rows past ``valid_n`` out of the top-k."""
    q, docs, W, ids, vals, fidx, comb = _ops_inputs()
    k = 7
    js, ji = jax_scoring.hybrid_topk_chunked(
        jnp.asarray(q @ np.ones((8, 16), np.float32)), jnp.asarray(docs), jnp.asarray(comb),
        jnp.int32(valid_n), k=k, chunk_size=16)
    ps, pi = scoring.hybrid_topk_chunked(
        torch.from_numpy(q @ np.ones((8, 16), np.float32)), torch.from_numpy(docs),
        torch.from_numpy(comb), valid_n, k, chunk_size=16)
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=RTOL, atol=ATOL)
    assert int(pi.max()) < valid_n
    mask = np.array([1, 0, 1, 1], np.float32)
    for m in (None, mask):
        js, ji = jax_scoring.fused_hybrid_topk_postings_from_query(
            jnp.asarray(q), jnp.asarray(W), None if m is None else jnp.asarray(m),
            jnp.asarray(docs), jnp.asarray(ids), jnp.asarray(vals), jnp.asarray(fidx),
            jnp.int32(valid_n), 2, k, chunk_size=16)
        ps, pi = scoring.fused_hybrid_topk_postings_from_query(
            torch.from_numpy(q), torch.from_numpy(W), None if m is None else torch.from_numpy(m),
            torch.from_numpy(docs), torch.from_numpy(ids), torch.from_numpy(vals),
            torch.from_numpy(fidx), valid_n, 2, k, chunk_size=16)
        np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))


@pytest.mark.parametrize("masked", [False, True])
def test_fuse_and_mix_matches_jax(masked):
    q, docs, W, *_ = _ops_inputs(seed=1)
    mask = np.array([1, 0, 1, 1], np.float32) if masked else None
    docs4 = np.concatenate([docs, docs[:, :16]], axis=1)  # four fields of 8
    want = jax_scoring.fuse_and_mix(jnp.asarray(q), jnp.asarray(docs4), jnp.asarray(W),
                                    None if mask is None else jnp.asarray(mask))
    got = scoring.fuse_and_mix(torch.from_numpy(q), torch.from_numpy(docs4), torch.from_numpy(W),
                               None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
