"""K1x, the cross-row schedule of the rerank gather (``pallas_cross_row``,
``--pallas-cross-row``), on the CPU against the JAX package with the same
flag.

The JAX side runs its Pallas kernel in interpret mode with
``cross_row_prefetch=True``: its engine does so off a TPU whenever it holds
the row-DMA view (``use_pallas_gather=True`` and E % 128 == 0, so E = 128
here).  The port's wrapper takes the plain version for CPU tensors whatever
the schedule, so these tests hold the semantics of the flag: the op's
values, which route serves, what is refused, and that the results are
JAX's.  The CUDA kernel itself is held against K1 and the plain version on
the card (``tests/test_torch_card.py``, ``chip_smoke.py``'s k1 phase).

Inputs are made from a seed with numpy and handed to both packages; queries
are encoded by the same function in each (a seeded embedding table,
mean-pooled), as in ``tests/test_torch_hybrid.py``; the commands run the
JAX synthetic encoder's weights in both packages.

Tolerances: the op at rtol = atol = 1e-5 (f32 sums of the same products in
different orders, as ``tests/test_torch_gather.py``); engines and commands
at rtol 1e-4 / atol 1e-3 with ties allowed (``eval/compare.py``), as
``tests/test_torch_hybrid.py``.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mfar_tpu.commands import make_synth_data as jax_msd
from mfar_tpu.commands import retrieve as jax_retrieve
from mfar_tpu.data.format import format_documents as jax_format_documents
from mfar_tpu.data.schema import resolve_fields as jax_resolve_fields
from mfar_tpu.data.synth import make_amazon_corpus, make_queries_and_qrels
from mfar_tpu.eval.retrieval import RetrievalEngine as JaxEngine
from mfar_tpu.models import SimpleVocabTokenizer as JaxTokenizer
from mfar_tpu.models.registry import prepare_model as jax_prepare_model
from mfar_tpu.ops.pallas_kernels import gather_per_field_scores_pallas
from mfar_tpu.sparse.bm25 import BM25Index as JaxBM25
from mfar_tpu_torch.commands import retrieve as port_retrieve
from mfar_tpu_torch.commands import serve as port_serve
from mfar_tpu_torch.data import trec
from mfar_tpu_torch.data.format import format_documents
from mfar_tpu_torch.data.schema import resolve_fields
from mfar_tpu_torch.eval import retrieval
from mfar_tpu_torch.eval.compare import rankings_agree
from mfar_tpu_torch.eval.retrieval import RetrievalEngine
from mfar_tpu_torch.models import registry
from mfar_tpu_torch.models.convert import encoder_state_from_jax
from mfar_tpu_torch.models.tokenizer import SimpleVocabTokenizer
from mfar_tpu_torch.ops.gather_scores import gather_per_field_scores
from mfar_tpu_torch.sparse.bm25 import BM25Index

torch.set_num_threads(1)

OP_RTOL = OP_ATOL = 1e-5
RTOL, ATOL = 1e-4, 1e-3
E = 128
N_DOCS = 120
DENSE = "title_dense,description_dense"
SPARSE = "title_sparse,feature_sparse"
MODEL = "synthetic:4096:128"  # E = 128: the JAX engine builds its row-DMA view


def _agree(got, want):
    msg = rankings_agree(got, want, RTOL, ATOL)
    assert msg is None, msg


# -- the op -----------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n_tiles", [1, 2, 3])  # odd counts stress the slot parity
def test_op_matches_jax_cross_row_prefetch(dtype, n_tiles):
    """``cross_row=True`` against JAX's kernel with ``cross_row_prefetch=True``
    (interpret mode) on C = 8 * n_tiles candidates a row; an odd N pads the
    bf16 pair view on the JAX side.  The row-local schedule gives the same
    values, and CPU calls count no launch."""
    b, n, f = 3, 67, 3
    rng = np.random.default_rng(n_tiles)
    q = rng.normal(size=(b, E)).astype(np.float32)
    docs = rng.normal(size=(n, f * E)).astype(np.float32)
    ids = rng.integers(0, n, size=(b, 8 * n_tiles)).astype(np.int64)
    ids[0, :3] = 0  # the first row, repeated
    ids[1, :] = 5  # one query's candidates all one row
    ids[-1, -1] = n - 1  # the last row, beside the pad of the pair view
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want = gather_per_field_scores_pallas(
        jnp.asarray(q), jnp.asarray(docs).astype(jdt), jnp.asarray(ids, jnp.int32), f,
        interpret=True, cross_row_prefetch=True)
    launches = (gather_per_field_scores.launches, gather_per_field_scores.cross_row_launches)
    args = (torch.from_numpy(q), torch.from_numpy(docs).to(tdt), torch.from_numpy(ids), f)
    got = gather_per_field_scores(*args, cross_row=True).numpy()
    assert got.shape == (b, 8 * n_tiles, f) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), rtol=OP_RTOL, atol=OP_ATOL)
    np.testing.assert_array_equal(got, gather_per_field_scores(*args).numpy())
    assert (gather_per_field_scores.launches,
            gather_per_field_scores.cross_row_launches) == launches


# -- the engine -------------------------------------------------------------


@pytest.fixture(scope="module")
def world():
    corpus = make_amazon_corpus(N_DOCS)
    queries = list(make_queries_and_qrels(corpus, n_queries=8)[0].values())
    pairs = list(corpus.pairs())
    rng = np.random.default_rng(0)
    texts = [t for f in ("title", "description")
             for _, t in jax_format_documents(pairs, f, "amazon")]
    jtok = JaxTokenizer.build(texts + queries, max_length=32)
    ptok = SimpleVocabTokenizer.build(texts + queries, max_length=32)
    table = rng.normal(size=(jtok.vocab_size, E)).astype(np.float32)
    matrix = rng.normal(size=(N_DOCS, 2, E)).astype(np.float32)
    mixer = rng.normal(scale=0.3, size=(E, 4)).astype(np.float32)

    def jax_encode(ids, mask):
        m = jnp.asarray(mask, jnp.float32)[..., None]
        return (jnp.asarray(table)[ids] * m).sum(1) / m.sum(1)

    def port_encode(ids, mask):
        ids, m = torch.as_tensor(ids), torch.as_tensor(mask, dtype=torch.float32)[..., None]
        return (torch.from_numpy(table)[ids] * m).sum(1) / m.sum(1)

    def indices(bm25, fmt, fi):
        return {fk: bm25.create(fmt(pairs, f.name, "amazon"), name=f.name, backend="scipy")
                for fk, f in fi.items() if f.is_sparse}

    def kws(hybrid=False, **over):
        """The JAX and port engines' arguments on one corpus, matrix, mixer
        and encoder; ``over`` applies to both, ``jax``/``port`` to one."""
        fields = f"{DENSE},{SPARSE}" if hybrid else DENSE
        jfi = jax_resolve_fields(fields, "amazon")
        pfi = resolve_fields(fields, "amazon")
        w = mixer if hybrid else mixer[:, :2]
        common = dict(doc_keys=list(corpus.keys()), query_max_length=32, recall_k=10,
                      dense_matrix=matrix, mode="rerank")
        jkw = dict(common, field_info=jfi, encode_fn=jax_encode, tokenizer=jtok,
                   mixer_params={"weight": jnp.asarray(w)},
                   sparse_indices=indices(JaxBM25, jax_format_documents, jfi))
        pkw = dict(common, field_info=pfi, encode_fn=port_encode, tokenizer=ptok,
                   mixer_params={"weight": w},
                   sparse_indices=indices(BM25Index, format_documents, pfi), device="cpu")
        both = {k: v for k, v in over.items() if k not in ("jax", "port")}
        jkw.update(both, **over.get("jax", {}))
        pkw.update(both, **over.get("port", {}))
        return jkw, pkw

    return dict(queries=queries, kws=kws)


@pytest.fixture
def schedules(monkeypatch):
    """The ``cross_row`` argument of every stage-2 gather the engine calls."""
    seen = []

    def spy(*args, cross_row=False, **kw):
        seen.append(cross_row)
        return gather_per_field_scores(*args, cross_row=cross_row, **kw)

    monkeypatch.setattr(retrieval, "gather_per_field_scores", spy)
    return seen


@pytest.mark.parametrize("case", ["dense", "dense-bf16", "hybrid"])
def test_engine_rerank_through_k1x_matches_jax(world, schedules, case):
    """``use_pallas_gather=True, pallas_cross_row=True``: the JAX engine
    holds the row-DMA view and runs its kernel's cross-row schedule
    (interpreted); the port serves ``singlechip-rerank[-hybrid]-k1x``, asks
    the gather for K1x, and gives JAX's rankings, and the same lists as its
    K1 route."""
    hybrid = case == "hybrid"
    over = dict(use_pallas_gather=True)
    if case == "dense-bf16":
        over.update(jax=dict(dense_dtype=jnp.bfloat16), port=dict(dense_dtype=torch.bfloat16))
    jkw, pkw = world["kws"](hybrid, **over)
    qs = world["queries"]
    jax_engine = JaxEngine(pallas_cross_row=True, **jkw)
    assert jax_engine.docs_rows is not None and jax_engine.pallas_cross_row
    engine = RetrievalEngine(pallas_cross_row=True, **pkw)
    got = engine.retrieve_many(qs, top_k=5, batch_size=4)
    assert engine.last_serve_path == f"singlechip-rerank-{'hybrid-' if hybrid else ''}k1x"
    assert schedules == [True, True]
    _agree(got, jax_engine.retrieve_many(qs, top_k=5, batch_size=4))
    k1 = RetrievalEngine(**pkw)
    assert k1.retrieve_many(qs, top_k=5, batch_size=4) == got
    assert k1.last_serve_path == f"singlechip-rerank-{'hybrid-' if hybrid else ''}k1"
    assert schedules == [True, True, False, False]


def test_cross_row_without_the_gather_raises(world, tmp_path):
    """The flag schedules the K1 gather: with the gather off the engine
    raises before any work (JAX asserts, mfar_tpu/eval/retrieval.py:159-162),
    and the commands refuse it before they read the corpus."""
    jkw, pkw = world["kws"](use_pallas_gather=False)
    with pytest.raises(AssertionError, match="use_pallas_gather"):
        JaxEngine(pallas_cross_row=True, **jkw)
    with pytest.raises(ValueError, match="without use_pallas_gather"):
        RetrievalEngine(pallas_cross_row=True, **pkw)
    with pytest.raises(ValueError, match="without use_pallas_gather"):
        port_retrieve.main(["--dataset-name", "amazon", "--data", str(tmp_path / "absent"),
                            "--out", str(tmp_path / "r.qres"), "--model-name", "synthetic",
                            "--use-pallas-gather", "off", "--pallas-cross-row",
                            "--device", "cpu"])


@pytest.mark.parametrize("case,over,mode,route", [
    ("int8", dict(quantize="int8"), "rerank", "singlechip-rerank-int8"),
    ("host", dict(corpus_on_host=True), "rerank", "host-stream-rerank-rows"),
    ("host-int8", dict(quantize="int8", corpus_on_host=True), "rerank",
     "host-stream-rerank-int8"),
    ("exact", dict(use_pallas_gather=True), "exact", "singlechip-dense"),
    ("f16", dict(jax=dict(dense_dtype=jnp.float16), port=dict(dense_dtype=torch.float16)),
     "rerank", "singlechip-rerank-plain"),
], ids=lambda v: v if isinstance(v, str) else "")
def test_flag_is_a_no_op_where_jax_ignores_it(world, schedules, case, over, mode, route):
    """An int8 or host-streamed corpus (JAX turns its gather off,
    mfar_tpu/eval/retrieval.py:169, :299-303), exact mode, and a corpus K1
    cannot read (f16, "auto" on the CPU): the flag changes neither the route
    nor the results, which are JAX's with the flag."""
    jkw, pkw = world["kws"](**over)
    qs = world["queries"]
    engine = RetrievalEngine(pallas_cross_row=True, **pkw)
    got = engine.retrieve(qs, top_k=5, mode=mode)
    assert engine.last_serve_path == route
    assert True not in schedules
    without = RetrievalEngine(**pkw)
    assert without.retrieve(qs, top_k=5, mode=mode) == got
    assert without.last_serve_path == route
    _agree(got, JaxEngine(pallas_cross_row=True, **jkw).retrieve(qs, top_k=5, mode=mode))


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


@pytest.mark.parametrize("hybrid", [False, True], ids=["dense", "hybrid"])
def test_mesh_rerank_ignores_the_flag(world, world_of_one, schedules, hybrid):
    """On a mesh (JAX's mesh branches come before its Pallas branch,
    mfar_tpu/eval/retrieval.py:1265-1281) "auto" with the flag serves
    ``mesh-rerank[-hybrid]``, as without it, with the one-device K1x
    engine's rankings; a forced gather on a mesh is refused, flag or not."""
    _, pkw = world["kws"](hybrid)
    qs = world["queries"]
    route = "mesh-rerank" + ("-hybrid" if hybrid else "")
    engine = RetrievalEngine(pallas_cross_row=True, mesh=world_of_one, **pkw)
    got = engine.retrieve(qs, top_k=5)
    assert engine.last_serve_path == route and schedules == []
    without = RetrievalEngine(mesh=world_of_one, **pkw)
    assert without.retrieve(qs, top_k=5) == got and without.last_serve_path == route
    _agree(got, RetrievalEngine(pallas_cross_row=True, **pkw).retrieve(qs, top_k=5))
    with pytest.raises(ValueError, match="not composed with the mesh"):
        RetrievalEngine(pallas_cross_row=True, mesh=world_of_one,
                        **{**pkw, "use_pallas_gather": True})


# -- the commands -----------------------------------------------------------


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cross_row") / "data")
    jax_msd.main(["--out", d, "--dataset-name", "amazon", "--n-docs", "60", "--n-train", "12",
                  "--n-val", "6", "--seed", "3"])
    return d


@pytest.fixture(scope="module")
def jax_params():
    """JAX's synthetic encoder parameters by model id, made once."""
    return {}


@pytest.fixture
def jax_weights(monkeypatch, jax_params):
    """The port's commands load the JAX synthetic encoder's weights, so both
    packages' commands encode alike."""
    real = registry.prepare_model

    def prepare(model_id, **kw):
        config, _, tok = real(model_id, **kw)
        if model_id not in jax_params:
            _, params, _ = jax_prepare_model(model_id, normalize=kw.get("normalize", False),
                                             corpus_texts=kw["corpus_texts"])
            jax_params[model_id] = jax.tree.map(np.asarray, params)
        return config, encoder_state_from_jax(jax_params[model_id], config), tok

    monkeypatch.setattr(registry, "prepare_model", prepare)


FLAGS = ["--dataset-name", "amazon", "--field-names", DENSE, "--model-name", MODEL,
         "--mode", "rerank", "--mesh", "off", "--use-pallas-gather", "on", "--recall-k", "20",
         "--top-k", "5"]


def _run(path):
    """A TREC run file as {query id: [(doc id, score), ...]}."""
    by_query = {}
    for r in trec.QRes.from_file(path):
        by_query.setdefault(r.query_id, []).append((r.doc_id, r.sim))
    return by_query


@pytest.fixture(scope="module")
def jax_run(dataset, tmp_path_factory):
    """JAX's ``retrieve --pallas-cross-row`` on the dataset: its kernel's
    cross-row schedule, interpreted."""
    out = str(tmp_path_factory.mktemp("jax_run") / "jax.qres")
    jax_retrieve.main([*FLAGS, "--data", dataset, "--out", out, "--pallas-cross-row"])
    return _run(out)


def test_retrieve_command_matches_jax(dataset, jax_run, tmp_path, jax_weights, schedules):
    """``retrieve --pallas-cross-row --mode rerank --use-pallas-gather on``
    writes JAX's run through K1x's schedule, and the port's run without the
    flag (K1's) is the same file."""
    out = {name: str(tmp_path / f"{name}.qres") for name in ("k1x", "k1")}
    port_retrieve.main([*FLAGS, "--data", dataset, "--out", out["k1x"], "--pallas-cross-row",
                        "--device", "cpu"])
    assert schedules and set(schedules) == {True}
    port_retrieve.main([*FLAGS, "--data", dataset, "--out", out["k1"], "--device", "cpu"])
    assert False in schedules
    got = _run(out["k1x"])
    assert sorted(got) == sorted(jax_run) and len(got) == 6
    assert all(len(hits) == 5 for hits in got.values())
    _agree([got[q] for q in sorted(got)], [jax_run[q] for q in sorted(got)])
    assert open(out["k1x"]).read() == open(out["k1"]).read()


def test_serve_daemon_takes_the_flag(dataset, jax_run, tmp_path, jax_weights, schedules):
    """``serve --pallas-cross-row`` builds its engine through
    ``build_engine``: the daemon answers the test queries over HTTP through
    K1x's schedule, with JAX's ``retrieve --pallas-cross-row`` rankings."""
    out = str(tmp_path / "smoke.json")
    port_serve.main([*FLAGS, "--data", dataset, "--pallas-cross-row", "--max-batch", "4",
                     "--port", "0", "--smoke-out", out, "--device", "cpu"])
    assert schedules and set(schedules) == {True}
    with open(out) as f:
        smoke = json.load(f)
    assert smoke["stats"]["errors"] == 0 and sorted(smoke["qids"]) == sorted(jax_run)
    got = [[(k, score) for k, score in hits] for hits in smoke["results"]]
    _agree(got, [jax_run[q] for q in smoke["qids"]])
