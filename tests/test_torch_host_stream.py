"""The host-streamed corpus: the port's streamed scans and engine routes on
the CPU against the JAX package's, on the same inputs
(``tests/test_host_streamed_corpus.py`` without its mesh cases).

On the CPU the stream runs the same loop as on a card (two chunk buffers
taken in turns, staging copies for a memmap, a column block or a cast), with
no copy stream.  The scans must give the JAX package's ids, and scores at
rtol 2e-6 (f32 sums of the same products; the JAX stream pads its tail chunk
to a compiled shape); a ragged tail, ``k`` above the chunk size and above
the corpus, a memmap and a bf16 transfer are covered.  The engines get the
same dense matrix, mixer and query encoder (a seeded embedding table,
mean-pooled) and are compared with ties allowed at rtol 1e-4 / atol 1e-3
(``eval/compare.py``), routes by ``last_serve_path``.
"""

import json
import os

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
from mfar_tpu_torch.commands import encode_corpus as port_encode_corpus
from mfar_tpu_torch.commands import make_synth_data as port_msd
from mfar_tpu_torch.commands import mask_fields as port_mask_fields
from mfar_tpu_torch.commands import retrieve as port_retrieve
from mfar_tpu_torch.commands import train as port_train
from mfar_tpu_torch.data import trec
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


def _same(got, want, rtol=2e-6):
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=rtol, atol=1e-5)


def _inputs(n, b=5, fe=64, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, fe)).astype(np.float32),
            rng.normal(size=(b, fe)).astype(np.float32))


def _postings(n, b, seed=7, m=64):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n, size=(b, m)).astype(np.int32)
    wvals = (np.abs(rng.normal(size=(b, m))) * 3).astype(np.float32)
    comb = np.zeros((b, n), np.float32)
    np.add.at(comb, (np.arange(b)[:, None], ids), wvals)
    return ids, wvals, comb


# ----------------------------------------------------------------------
# the streamed scans


@pytest.mark.parametrize("n,chunk", [(1000, 256), (512, 512), (700, 1024), (1000, 333)])
def test_streamed_matches_jax_and_resident(n, chunk):
    docs, q = _inputs(n)
    want = jax_scoring.dense_topk_host_streamed(jnp.asarray(q), docs, 50, chunk_size=chunk)
    got = scoring.dense_topk_host_streamed(torch.from_numpy(q), docs, 50, chunk_size=chunk)
    _same(got, want)
    resident = scoring.dense_topk_chunked(torch.from_numpy(q), torch.from_numpy(docs), n, 50,
                                          chunk_size=chunk)
    _same(got, (resident[0].numpy(), resident[1].numpy()))


def test_streamed_k_exceeds_chunk():
    """k > chunk: the carry grows across chunks (the resident op refuses
    this case), checked against brute force and the JAX stream."""
    docs, q = _inputs(90, seed=3)
    got = scoring.dense_topk_host_streamed(torch.from_numpy(q), docs, 50, chunk_size=32)
    truth = q @ docs.T
    order = np.argsort(-truth, axis=1)[:, :50]
    np.testing.assert_array_equal(got[1].numpy(), order)
    np.testing.assert_allclose(got[0].numpy(), np.take_along_axis(truth, order, 1),
                               rtol=1e-5, atol=1e-5)
    _same(got, jax_scoring.dense_topk_host_streamed(jnp.asarray(q), docs, 50, chunk_size=32))


def test_streamed_memmap_with_bf16_transfer(tmp_path):
    """A read-only disk memmap streams chunk by chunk through the bf16
    staging cast, as the JAX stream's ``transfer_dtype``."""
    docs, q = _inputs(600, b=3, seed=1)
    mm = np.lib.format.open_memmap(str(tmp_path / "c.npy"), mode="w+", dtype=np.float32,
                                   shape=docs.shape)
    mm[:] = docs
    mm.flush()
    mm = np.load(str(tmp_path / "c.npy"), mmap_mode="r")
    want = jax_scoring.dense_topk_host_streamed(jnp.asarray(q), mm, 20, chunk_size=256,
                                                transfer_dtype=jnp.bfloat16)
    got = scoring.dense_topk_host_streamed(torch.from_numpy(q), mm, 20, chunk_size=256,
                                           transfer_dtype=torch.bfloat16)
    _same(got, want)


def test_streamed_bf16_in_ram_corpus_multiplies_in_f32(monkeypatch):
    """An in-RAM corpus cast once to bf16 against f32 queries: the JAX
    stream promotes to an f32 product; the port upcasts each chunk's rows a
    block at a time (blocks of 7 rows here) to the same product."""
    docs, q = _inputs(300, seed=2)
    bf = torch.from_numpy(docs).bfloat16()
    want = jax_scoring.dense_topk_host_streamed(
        jnp.asarray(q), bf.float().numpy().astype(jnp.bfloat16), 25, chunk_size=128)
    monkeypatch.setattr(scoring, "STREAM_UPCAST_ROWS", 7)
    got = scoring.dense_topk_host_streamed(torch.from_numpy(q), bf, 25, chunk_size=128)
    _same(got, want)


def test_k_exceeds_corpus():
    docs, q = _inputs(7, b=2, fe=16, seed=2)
    s, i = scoring.dense_topk_host_streamed(torch.from_numpy(q), docs, 10, chunk_size=4)
    assert s.shape == (2, 10) and torch.all(s[:, 7:] == float("-inf"))
    _same((s, i), jax_scoring.dense_topk_host_streamed(jnp.asarray(q), docs, 10, chunk_size=4))


@pytest.mark.parametrize("n,chunk", [(1000, 256), (300, 512)])
def test_streamed_int8_matches_jax_and_resident(n, chunk):
    docs, q = _inputs(n, seed=4)
    dq, ds = jax_scoring.quantize_rows_int8_np(docs)
    want = jax_scoring.dense_topk_host_streamed_int8(jnp.asarray(q), dq, ds, 40,
                                                     chunk_size=chunk)
    got = scoring.dense_topk_host_streamed_int8(torch.from_numpy(q), dq, ds, 40,
                                                chunk_size=chunk)
    _same(got, want)
    resident = scoring.dense_topk_chunked_int8(
        torch.from_numpy(q), torch.from_numpy(dq), torch.from_numpy(ds), n, 40, chunk_size=chunk)
    _same(got, (resident[0].numpy(), resident[1].numpy()))


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("form", ["postings", "combined"])
@pytest.mark.parametrize("n,chunk", [(1000, 256), (300, 512)])
def test_hybrid_streamed_matches_jax(n, chunk, form, int8):
    """Both sparse forms: the postings scattered per chunk (device-resident
    ids and weighted impacts), or the host's combined [B, N] tensor
    streamed by column blocks beside the rows."""
    docs, q = _inputs(n, b=4, seed=8)
    ids, wvals, comb = _postings(n, 4)
    jkw = (dict(post_ids=jnp.asarray(ids), post_wvals=jnp.asarray(wvals))
           if form == "postings" else dict(sparse_comb_host=comb))
    pkw = (dict(post_ids=torch.from_numpy(ids), post_wvals=torch.from_numpy(wvals))
           if form == "postings" else dict(sparse_comb_host=comb))
    if int8:
        dq, ds = jax_scoring.quantize_rows_int8_np(docs)
        want = jax_scoring.hybrid_topk_host_streamed_int8(
            jnp.asarray(q), dq, ds, 30, chunk_size=chunk, **jkw)
        got = scoring.hybrid_topk_host_streamed_int8(
            torch.from_numpy(q), dq, ds, 30, chunk_size=chunk, **pkw)
    else:
        want = jax_scoring.hybrid_topk_host_streamed(jnp.asarray(q), docs, 30,
                                                     chunk_size=chunk, **jkw)
        got = scoring.hybrid_topk_host_streamed(torch.from_numpy(q), docs, 30,
                                                chunk_size=chunk, **pkw)
    _same(got, want, rtol=1e-5)


def test_hybrid_stream_takes_exactly_one_sparse_form():
    docs, q = _inputs(40, b=2, fe=16)
    ids, wvals, comb = _postings(40, 2)
    with pytest.raises(ValueError, match="exactly one"):
        scoring.hybrid_topk_host_streamed(torch.from_numpy(q), docs, 5)
    with pytest.raises(ValueError, match="exactly one"):
        scoring.hybrid_topk_host_streamed(torch.from_numpy(q), docs, 5,
                                          post_ids=torch.from_numpy(ids),
                                          post_wvals=torch.from_numpy(wvals),
                                          sparse_comb_host=comb)


# ----------------------------------------------------------------------
# the engine's host-stream routes against the JAX engine


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

    def engines(fields, quantize=None, bf16=False):
        jfi, pfi = jax_resolve_fields(fields, "amazon"), resolve_fields(fields, "amazon")
        w = mixer[:, : len(pfi)]
        common = dict(doc_keys=list(corpus.keys()), query_max_length=32, recall_k=10,
                      dense_matrix=matrix, quantize=quantize, corpus_on_host=True)
        jeng = JaxEngine(**common, field_info=jfi, encode_fn=jax_encode, tokenizer=jtok,
                         mixer_params={"weight": jnp.asarray(w)},
                         sparse_indices=_indices(JaxBM25, jax_format_documents, pairs, jfi),
                         dense_dtype=jnp.bfloat16 if bf16 else None)
        peng = RetrievalEngine(**common, field_info=pfi, encode_fn=port_encode, tokenizer=ptok,
                               mixer_params={"weight": w},
                               sparse_indices=_indices(BM25Index, format_documents, pairs, pfi),
                               dense_dtype=torch.bfloat16 if bf16 else None, device="cpu")
        return jeng, peng

    return dict(queries=queries, engines=engines)


@pytest.mark.parametrize("fields,batch,quantize,bf16,route", [
    (DENSE, "queries", None, False, "host-stream-dense"),
    (DENSE, "queries", None, True, "host-stream-dense"),
    (DENSE, "queries", "int8", False, "host-stream-dense-int8"),
    (f"{DENSE},{SPARSE}", "queries", None, False, "host-stream-hybrid-postings"),
    (f"{DENSE},{SPARSE}", "dense", None, False, "host-stream-hybrid-combined"),
    (f"{DENSE},{SPARSE}", "queries", "int8", False, "host-stream-hybrid-int8-postings"),
    (f"{DENSE},{SPARSE}", "dense", "int8", False, "host-stream-hybrid-int8-combined"),
])
def test_engine_exact_routes_match_jax(world, fields, batch, quantize, bf16, route):
    jeng, peng = world["engines"](fields, quantize, bf16)
    assert not peng.use_gather_kernel and peng.docs_flat is None and peng.docs_q is None
    qs = world["queries"] if batch == "queries" else DENSE_POSTINGS
    want = jeng.retrieve(qs, top_k=10, mode="exact")
    got = peng.retrieve(qs, top_k=10, mode="exact")
    assert jeng.last_serve_path == peng.last_serve_path == route
    _agree(got, want)


@pytest.mark.parametrize("fields,quantize,route", [
    (DENSE, None, "host-stream-rerank-rows"),
    (DENSE, "int8", "host-stream-rerank-int8"),
    (f"{DENSE},{SPARSE}", None, "host-stream-rerank-hybrid-rows"),
    (f"{DENSE},{SPARSE}", "int8", "host-stream-rerank-hybrid-int8"),
])
def test_engine_rerank_matches_jax(world, fields, quantize, route):
    """Stage 1 recalls through one-hot folded queries over the stream;
    stage 2 gathers the candidates' rows on the host (dequantized there for
    int8)."""
    jeng, peng = world["engines"](fields, quantize)
    want = jeng.retrieve(world["queries"], top_k=10, mode="rerank")
    got = peng.retrieve(world["queries"], top_k=10, mode="rerank")
    assert peng.last_serve_path == route
    _agree(got, want)


def test_engine_host_corpus_refuses_k1(world):
    jfi = resolve_fields(DENSE, "amazon")
    with pytest.raises(ValueError, match="K1"):
        RetrievalEngine(field_info=jfi, doc_keys=[f"d{i}" for i in range(4)],
                        encode_fn=None, tokenizer=None, mixer_params={"weight": np.ones((1, 2))},
                        dense_matrix=np.ones((4, 2, 8), np.float32), corpus_on_host=True,
                        use_pallas_gather=True, device="cpu")


# ----------------------------------------------------------------------
# the retrieve command


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("host_stream_cli")
    d = str(root / "data")
    port_msd.main(["--out", d, "--dataset-name", "amazon", "--n-docs", "60", "--n-train", "6",
                   "--n-val", "6", "--seed", "3"])
    return root, d


def _run(root, d, name, extra):
    out = str(root / f"{name}.qres")
    port_retrieve.main(["--dataset-name", "amazon", "--data", d, "--out", out,
                        "--field-names", DENSE, "--model-name", "synthetic", "--top-k", "5",
                        "--device", "cpu", *extra])
    by_query = {}
    for r in trec.QRes.from_file(out):
        by_query.setdefault(r.query_id, []).append((r.doc_id, r.sim))
    return [by_query[q] for q in sorted(by_query)]


@pytest.mark.parametrize("corpus", ["in RAM, f32", "memmap .npy, bf16 transfer"])
def test_retrieve_corpus_on_host_cli(dataset, corpus, capsys):
    """``retrieve --corpus-on-host --device cpu`` ranks as the
    device-resident engine of the same dtype: an encoded f32 matrix, or an
    ``encode_corpus`` .npy read as a memmap and streamed in bf16."""
    root, d = dataset
    if corpus.startswith("in RAM"):
        extra = ["--dense-dtype", "f32"]
    else:
        npy = str(root / "dense.npy")
        port_encode_corpus.main(["--dataset-name", "amazon", "--data", d, "--field-names",
                                 DENSE, "--model-name", "synthetic", "--device", "cpu",
                                 "--out", npy])
        extra = ["--dense-index", npy]
    resident = _run(root, d, "resident", extra)
    capsys.readouterr()
    streamed = _run(root, d, "streamed", [*extra, "--corpus-on-host"])
    assert "[host-stream-dense]" in capsys.readouterr().out
    assert len(streamed) == 6 and all(len(h) == 5 for h in streamed)
    msg = rankings_agree(streamed, resident, RTOL, ATOL)
    assert msg is None, msg


def test_mask_fields_corpus_on_host_matches_resident(dataset):
    """``mask_fields --corpus-on-host`` (the trainer's test engine streams
    the corpus from host memory) writes the device-resident run's metrics."""
    root, d = dataset
    run = str(root / "run")
    common = ["--dataset-name", "amazon", "--data", d, "--field-names", DENSE,
              "--model-name", "synthetic", "--lexical-index", str(root / "no_idx"),
              "--device", "cpu"]
    port_train.main([*common, "--out", run, "--run-one-iteration", "--max-epochs", "1",
                     "--weights-lr", "0.1"])
    records = {}
    for name, extra in (("resident", []), ("streamed", ["--corpus-on-host"])):
        out = str(root / f"abl_{name}")
        port_mask_fields.main([*common, "--out", out, "--checkpoint-dir", run, "--debug",
                               "--recall-k", "20", *extra])
        with open(os.path.join(out, "results_dicts.jsonl")) as f:
            records[name] = [json.loads(line) for line in f]
    assert len(records["streamed"]) == len(records["resident"]) == 1
    got, want = records["streamed"][0], records["resident"][0]
    for key in want:
        if key not in ("masked_fields", "additional"):
            assert abs(float(got[key]) - float(want[key])) <= 1e-6, (key, got, want)
