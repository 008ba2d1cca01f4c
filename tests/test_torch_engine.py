"""The slice as a whole: the port's engine on the CPU against the JAX engine,
on the same corpus, encoder weights and mixer.

The world is ``tests/test_pallas_kernels.py``'s engine test: 48 synthetic
amazon docs, two dense fields, a tiny f32 encoder at hidden 128 and a
query-conditioned mixer; the T5 cases swap in a tiny T5 encoder projected
to 128.  The JAX rerank engine runs the Pallas K1 kernel
in interpret mode (``use_pallas_gather=True`` off a TPU); the port's rerank
engine goes through the K1 wrapper, whose CPU path is the plain version.

Tolerances: each package encodes the corpus and the queries itself, so the
encoder's f32 drift (atol 2e-4 on embeddings, as ``tests/test_encoder.py``)
reaches the scores (magnitude 10-100; the drift measured here is up to
1e-5 relative): scores compare at rtol=atol=1e-4, and keys may differ only
among candidates whose scores lie within that tolerance of each other.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mfar_tpu.data.format import format_documents
from mfar_tpu.data.schema import resolve_fields as jax_resolve_fields
from mfar_tpu.data.synth import make_amazon_corpus, make_queries_and_qrels
from mfar_tpu.eval import index_build as jax_index
from mfar_tpu.eval.retrieval import RetrievalEngine as JaxEngine
from mfar_tpu.models import Encoder as JaxEncoder
from mfar_tpu.models import EncoderConfig as JaxConfig
from mfar_tpu.models import SimpleVocabTokenizer as JaxTokenizer
from mfar_tpu.models.encoder import init_params
from mfar_tpu.models.t5_encoder import T5Config as JaxT5Config
from mfar_tpu.models.t5_encoder import T5Encoder as JaxT5Encoder
from mfar_tpu.models.t5_encoder import init_t5_params
from mfar_tpu_torch.data.format import format_documents as port_format_documents
from mfar_tpu_torch.data.schema import resolve_fields
from mfar_tpu_torch.data.types import Corpus
from mfar_tpu_torch.eval import index_build as port_index
from mfar_tpu_torch.eval.compare import rankings_agree
from mfar_tpu_torch.eval.retrieval import RetrievalEngine
from mfar_tpu_torch.models import T5Config, build_encoder
from mfar_tpu_torch.models.convert import encoder_state_from_jax, mixer_from_jax, t5_state_from_jax
from mfar_tpu_torch.models.encoder import Encoder, EncoderConfig
from mfar_tpu_torch.models.tokenizer import SimpleVocabTokenizer
from mfar_tpu_torch.sparse.bm25 import BM25Index

torch.set_num_threads(1)

RTOL = ATOL = 1e-4
HIDDEN = 128


@pytest.fixture(scope="module")
def world():
    corpus = make_amazon_corpus(48)
    queries, _ = make_queries_and_qrels(corpus, n_queries=6)
    fields = "title_dense,description_dense"
    jfi = jax_resolve_fields(fields, "amazon")
    texts = []
    for f in jfi.values():
        texts += [t for _, t in format_documents(corpus.pairs(), f.name, "amazon")]
    texts += list(queries.values())
    jtok = JaxTokenizer.build(texts, max_length=64)
    jcfg = JaxConfig.tiny(vocab_size=jtok.vocab_size, hidden_size=HIDDEN)
    params = jax.tree.map(np.asarray, init_params(jcfg))
    model = JaxEncoder(jcfg)

    @jax.jit
    def jax_encode(ids, mask):
        return model.apply({"params": params}, ids, mask)

    mixer = np.random.default_rng(0).normal(size=(HIDDEN, 2)).astype(np.float32)
    jax_matrix = jax_index.build_dense_corpus_matrix(jax_encode, jtok, corpus, jfi, batch_size=16)

    # the port: its own corpus/schema/tokenizer copies, carried weights
    pcorpus = Corpus.from_pairs(list(corpus.pairs()), "amazon")
    pfi = resolve_fields(fields, "amazon")
    ptok = SimpleVocabTokenizer.build(texts, max_length=64)
    pcfg = EncoderConfig.tiny(vocab_size=ptok.vocab_size, hidden_size=HIDDEN)
    penc = Encoder(pcfg)
    penc.load_state_dict(encoder_state_from_jax(params, pcfg))
    port_encode = port_index.make_encode_fn(penc, device="cpu")
    port_matrix = port_index.build_dense_corpus_matrix(
        port_encode, ptok, pcorpus, pfi, batch_size=16
    )
    jax_kw = dict(field_info=jfi, doc_keys=list(corpus.keys()), encode_fn=jax_encode,
                  tokenizer=jtok, mixer_params={"weight": jnp.asarray(mixer)},
                  dense_matrix=jax_matrix, query_max_length=64, recall_k=10)
    port_kw = dict(field_info=pfi, doc_keys=list(pcorpus.keys()), encode_fn=port_encode,
                   tokenizer=ptok, mixer_params=mixer_from_jax({"weight": mixer}),
                   dense_matrix=port_matrix, query_max_length=64, recall_k=10, device="cpu")
    return dict(queries=list(queries.values()), jax_matrix=jax_matrix,
                port_matrix=port_matrix, jax_kw=jax_kw, port_kw=port_kw,
                jax_corpus=corpus, port_corpus=pcorpus)


def test_dense_corpus_matrix_matches_jax(world):
    assert world["port_matrix"].shape == (48, 2, HIDDEN)
    np.testing.assert_allclose(world["port_matrix"], np.asarray(world["jax_matrix"]), atol=2e-4)


def test_dense_corpus_matrix_prefix_memmap_and_dtype_match_jax(world, tmp_path):
    """``prefix=True`` (field names in front of the texts) and an
    ``open_memmap`` write target, against the JAX build; ``dtype`` casts."""
    jkw, pkw = world["jax_kw"], world["port_kw"]
    want = np.asarray(jax_index.build_dense_corpus_matrix(
        jkw["encode_fn"], jkw["tokenizer"], world["jax_corpus"], jkw["field_info"],
        batch_size=16, prefix=True))
    out = np.lib.format.open_memmap(str(tmp_path / "m.npy"), mode="w+", dtype=np.float32,
                                    shape=(48, 2, HIDDEN))
    args = (pkw["encode_fn"], pkw["tokenizer"], world["port_corpus"], pkw["field_info"])
    got = port_index.build_dense_corpus_matrix(*args, batch_size=16, prefix=True, out=out)
    assert got is out
    np.testing.assert_allclose(np.asarray(out), want, atol=2e-4)
    assert not np.allclose(want, world["port_matrix"], atol=1e-2)  # the prefix counts
    half = port_index.build_dense_corpus_matrix(*args, batch_size=32, dtype=np.float16)
    assert half.dtype == np.float16
    np.testing.assert_allclose(half, world["port_matrix"], atol=2e-3)


def _agree(got, want):
    assert len(got) == len(want)
    msg = rankings_agree(got, want, RTOL, ATOL)
    assert msg is None, msg


@pytest.mark.parametrize("mode", ["rerank", "exact"])
def test_engine_matches_jax(world, mode):
    jax_engine = JaxEngine(use_pallas_gather=True, mode=mode, **world["jax_kw"])
    port_engine = RetrievalEngine(use_pallas_gather=True, mode=mode, **world["port_kw"])
    if mode == "rerank":
        assert jax_engine.docs_rows is not None  # the Pallas K1 route, interpreted
        assert port_engine.use_gather_kernel
    want = jax_engine.retrieve(world["queries"], top_k=5)
    got = port_engine.retrieve(world["queries"], top_k=5)
    _agree(got, want)
    assert port_engine.last_serve_path == (
        "singlechip-rerank-k1" if mode == "rerank" else "singlechip-dense"
    )


@pytest.mark.parametrize("mode", ["rerank", "exact"])
def test_retrieve_many_ragged_tail_matches_jax(world, mode):
    """6 queries at batch 4: the tail batch pads to 4 and is sliced back."""
    jax_engine = JaxEngine(mode=mode, use_pallas_gather=False, **world["jax_kw"])
    port_engine = RetrievalEngine(mode=mode, use_pallas_gather=False, **world["port_kw"])
    want = jax_engine.retrieve_many(world["queries"], top_k=7, batch_size=4)
    got = port_engine.retrieve_many(world["queries"], top_k=7, batch_size=4)
    assert len(got) == 6
    _agree(got, want)
    # per-batch retrieve gives the same lists as the pipelined batches
    _agree(got, port_engine.retrieve(world["queries"], top_k=7))


def test_gather_routes_agree_and_mask(world):
    """Stage 2 through the K1 wrapper and through the plain gather give one
    result; an ablation mask reaches both the same way as in JAX."""
    k1 = RetrievalEngine(mode="rerank", use_pallas_gather=True, **world["port_kw"])
    plain = RetrievalEngine(mode="rerank", use_pallas_gather=False, **world["port_kw"])
    _agree(k1.retrieve(world["queries"], top_k=5), plain.retrieve(world["queries"], top_k=5))
    jax_engine = JaxEngine(mode="rerank", use_pallas_gather=False, **world["jax_kw"])
    mask = np.array([1.0, 0.0], np.float32)
    for eng in (k1, jax_engine):
        eng.set_mask(mask)
    _agree(k1.retrieve(world["queries"], top_k=5), jax_engine.retrieve(world["queries"], top_k=5))
    np.testing.assert_allclose(
        k1.field_weight_report(world["queries"]),
        np.asarray(jax_engine.field_weight_report(world["queries"])), rtol=1e-5, atol=1e-6,
    )


def test_dispatch_finish_and_bf16_corpus(world):
    eng = RetrievalEngine(mode="rerank", dense_dtype=torch.bfloat16, **world["port_kw"])
    assert eng.docs_flat.dtype == torch.bfloat16
    h = eng.dispatch(world["queries"], top_k=5)
    got = eng.finish(h)
    assert [len(x) for x in got] == [5] * 6
    exact = eng.finish(eng.dispatch(world["queries"], top_k=5, mode="exact"))
    assert eng.last_serve_path == "singlechip-dense"
    assert all(np.isfinite(s) for hits in exact for _, s in hits)


def test_forced_gather_needs_a_corpus_the_kernel_reads(world):
    """use_pallas_gather=True on a corpus K1 cannot read raises at
    construction (f16 is neither of its two types); "auto" on such a CPU
    corpus takes the plain gather (on a CUDA corpus it raises, see
    tests/test_torch_card.py)."""
    with pytest.raises(ValueError, match="K1 gather"):
        RetrievalEngine(mode="rerank", use_pallas_gather=True, dense_dtype=torch.float16,
                        **world["port_kw"])
    f16 = RetrievalEngine(mode="rerank", dense_dtype=torch.float16, **world["port_kw"])
    assert not f16.use_gather_kernel
    f16.retrieve(world["queries"][:2], top_k=3)
    assert f16.last_serve_path == "singlechip-rerank-plain"


@pytest.mark.parametrize("serve", ["retrieve", "retrieve_many", "dispatch"])
def test_exact_engine_reranks_through_k1(world, serve):
    """The gate does not key on the engine's default mode: an engine built
    for exact mode that serves a rerank request goes through K1."""
    eng = RetrievalEngine(mode="exact", **world["port_kw"])
    assert eng.use_gather_kernel
    qs = world["queries"]
    if serve == "retrieve":
        got = eng.retrieve(qs, top_k=5, mode="rerank")
    elif serve == "retrieve_many":
        got = eng.retrieve_many(qs, top_k=5, mode="rerank", batch_size=4)
    else:
        got = eng.finish(eng.dispatch(qs, top_k=5, mode="rerank"))
    assert eng.last_serve_path == "singlechip-rerank-k1"
    _agree(got, RetrievalEngine(mode="rerank", **world["port_kw"]).retrieve(qs, top_k=5))


@pytest.fixture
def world_of_one(tmp_path):
    """A gloo world of this one process and a mesh over it, torn down after
    the test."""
    import torch.distributed as dist

    from mfar_tpu_torch.parallel.mesh import make_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'init'}", world_size=1,
                            rank=0)
    try:
        yield make_mesh()
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("mode", ["exact", "rerank"])
@pytest.mark.parametrize("kw,routes", [
    (dict(quantize="int8"), ("mesh-int8-dense", "mesh-rerank-int8")),
    (dict(corpus_on_host=True), ("host-stream-dense-mesh", "host-stream-rerank-rows-mesh")),
    (dict(quantize="int8", corpus_on_host=True),
     ("host-stream-dense-int8-mesh", "host-stream-rerank-int8-mesh")),
], ids=["int8", "host", "host-int8"])
def test_int8_and_host_corpora_serve_on_a_mesh(world, world_of_one, kw, routes, mode):
    """An int8 or host-streamed corpus on a mesh (it raised until ROADMAP
    A15c) builds and serves in a gloo world of one on the CPU, with the
    one-device engine's results on the same corpus."""
    qs = world["queries"]
    eng = RetrievalEngine(**{**world["port_kw"], **kw, "mesh": world_of_one})
    got = eng.retrieve(qs, top_k=5, mode=mode)
    assert eng.last_serve_path == routes[mode == "rerank"]
    _agree(got, RetrievalEngine(**{**world["port_kw"], **kw}).retrieve(qs, top_k=5, mode=mode))


def test_sparse_fields_are_served(world):
    """A declared sparse field with its BM25 index joins the dense fields
    (once ROADMAP A8's one-device half, it raised): exact mode takes the
    postings route, and with the sparse field masked the scores are the
    dense engine's with the same mixer columns."""
    corpus = world["port_corpus"]
    fields = resolve_fields("title_dense,description_dense,title_sparse", "amazon")
    index = BM25Index.create(port_format_documents(corpus.pairs(), "title", "amazon"),
                             backend="scipy")
    mixer = np.random.default_rng(1).normal(size=(HIDDEN, 3)).astype(np.float32)
    eng = RetrievalEngine(**{**world["port_kw"], "field_info": fields,
                             "mixer_params": {"weight": mixer},
                             "sparse_indices": {"title_sparse": index}})
    qs = world["queries"]
    hits = eng.retrieve(qs, top_k=5)
    assert eng.last_serve_path == "singlechip-hybrid-postings"
    assert [len(h) for h in hits] == [5] * len(qs)
    eng.set_mask(np.array([1, 1, 0], np.float32))
    masked = eng.retrieve(qs, top_k=5)
    q = eng.encode_queries(qs)
    w = torch.softmax(q @ torch.from_numpy(mixer), -1)[:, :2]
    docs = torch.as_tensor(world["port_matrix"])
    top_s, top_i = torch.topk(torch.einsum("be,nfe,bf->bn", q, docs, w), 5)
    _agree(masked, eng._to_keyed(top_s.numpy(), top_i.numpy()))


@pytest.mark.parametrize("ext", [".npz", ".npy"])
def test_dense_matrix_files_cross_packages(world, tmp_path, ext):
    keys = world["port_kw"]["doc_keys"]
    m = world["port_matrix"]
    # port writes, JAX reads
    p1 = port_index.save_dense_matrix(str(tmp_path / f"port{ext}"), m, keys)
    got, got_keys = jax_index.load_dense_matrix(p1)
    np.testing.assert_array_equal(np.asarray(got), m)
    assert list(got_keys) == keys
    # JAX writes, port reads
    p2 = jax_index.save_dense_matrix(str(tmp_path / f"jax{ext}"), np.asarray(world["jax_matrix"]), keys)
    got, got_keys = port_index.load_dense_matrix(p2)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(world["jax_matrix"]))
    assert list(got_keys) == keys
    # and a memory-mapped .npy serves straight into the engine
    if ext == ".npy":
        eng = RetrievalEngine(**{**world["port_kw"], "dense_matrix": got})
        assert len(eng.retrieve(world["queries"][:2], top_k=3)[0]) == 3


@pytest.fixture(scope="module")
def t5_world(world):
    """The same corpus, tokenizers and mixer through a tiny GTR-shaped T5
    encoder (d_model 32, projected to 128) whose weights both packages
    carry."""
    jkw, pkw = world["jax_kw"], world["port_kw"]
    dims = dict(vocab_size=pkw["tokenizer"].vocab_size, projection_dim=HIDDEN)
    jcfg = JaxT5Config.tiny(**dims)
    params = init_t5_params(jcfg, seed=3)
    model = JaxT5Encoder(jcfg)
    jax_encode = jax.jit(lambda ids, mask: model.apply({"params": params}, ids, mask))
    penc = build_encoder(T5Config.tiny(**dims))
    penc.load_state_dict(t5_state_from_jax(jax.tree.map(np.asarray, params)))
    port_encode = port_index.make_encode_fn(penc, device="cpu")
    jax_matrix = jax_index.build_dense_corpus_matrix(
        jax_encode, jkw["tokenizer"], world["jax_corpus"], jkw["field_info"], batch_size=16)
    port_matrix = port_index.build_dense_corpus_matrix(
        port_encode, pkw["tokenizer"], world["port_corpus"], pkw["field_info"], batch_size=16)
    np.testing.assert_allclose(port_matrix, np.asarray(jax_matrix), atol=2e-4)
    return (dict(jkw, encode_fn=jax_encode, dense_matrix=jax_matrix),
            dict(pkw, encode_fn=port_encode, dense_matrix=port_matrix))


@pytest.mark.parametrize("mode", ["rerank", "exact"])
def test_t5_engine_matches_jax(world, t5_world, mode):
    jax_kw, port_kw = t5_world
    want = JaxEngine(use_pallas_gather=True, mode=mode, **jax_kw).retrieve(
        world["queries"], top_k=5)
    engine = RetrievalEngine(use_pallas_gather=True, mode=mode, **port_kw)
    _agree(engine.retrieve(world["queries"], top_k=5), want)
    assert engine.last_serve_path == (
        "singlechip-rerank-k1" if mode == "rerank" else "singlechip-dense")
