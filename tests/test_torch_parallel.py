"""Serving over several ranks: the port's mesh (``mfar_tpu_torch.parallel``)
against the JAX package's mesh on the same numpy inputs.

The port side runs as gloo worlds of W = 2 and W = 4 CPU processes
(``tests/torch_mesh_worker.py``), started together once for the module;
each rank runs every check and returns its results through a file.  The
JAX side is the JAX package's mesh on the first W of the suite's 8 virtual
CPU devices.  The corpus has 203 rows, which divide neither 2 nor 4, so
every shard geometry has a padded tail.

Checks: every route of ``parallel/topk.py`` on a flat mesh (data = W) and a
sliced one (replica = 2, corpus over (replica, data), and a corpus per
slice with the replicas splitting the batch), against a full scan of the
corpus in numpy; the index build split over the ranks, against JAX's; the
engine's exact (dense, hybrid postings, hybrid combined) and rerank (dense,
hybrid) routes with ``last_serve_path``, over the flat mesh and with
``corpus_per_slice`` and ``n_replica = 2``, against the JAX mesh engine.  Scores compare at rtol
1e-4 / atol 1e-3 with ties allowed (``eval/compare.py``); every rank's
results equal rank 0's.  The pure helpers run in this process.
"""

import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mfar_tpu.data.format import format_documents as jax_format_documents
from mfar_tpu.data.schema import resolve_fields as jax_resolve_fields
from mfar_tpu.data.synth import make_amazon_corpus, make_queries_and_qrels
from mfar_tpu.eval import index_build as jax_index
from mfar_tpu.eval.retrieval import RetrievalEngine as JaxEngine
from mfar_tpu.models import Encoder as JaxEncoder
from mfar_tpu.models import EncoderConfig as JaxConfig
from mfar_tpu.models import SimpleVocabTokenizer as JaxTokenizer
from mfar_tpu.models.encoder import init_params
from mfar_tpu.parallel import mesh as jax_mesh
from mfar_tpu.parallel import topk as jax_topk
from mfar_tpu.sparse.bm25 import BM25Index as JaxBM25
from mfar_tpu_torch.eval.compare import rankings_agree
from mfar_tpu_torch.models.convert import encoder_state_from_jax
from mfar_tpu_torch.models.encoder import EncoderConfig
from mfar_tpu_torch.parallel import mesh as port_mesh
from mfar_tpu_torch.parallel import topk as port_topk

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_mesh_worker.py")
RTOL, ATOL = 1e-4, 1e-3
WORLDS = (2, 4)
N_DOCS, HIDDEN = 203, 128
B, N, F, E, K, C, CHUNK = 4, 203, 2, 16, 7, 9, 16
DENSE = "title_dense,description_dense"
HYBRID = DENSE + ",title_sparse,feature_sparse"
# every document's title holds "model" and its features "feature" and "kg":
# these queries' postings are denser than half the corpus (the combined route)
DENSE_POSTINGS = ["model feature red lamp", "kg model feature weight", "model kg"]


def _route_inputs():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(B, E)).astype(np.float32)
    docs = rng.normal(size=(N, F * E)).astype(np.float32)
    w = rng.normal(size=(E, F)).astype(np.float32)
    wh = rng.normal(size=(E, F + 2)).astype(np.float32)
    logits = q @ w
    weights = np.exp(logits - logits.max(-1, keepdims=True))
    weights /= weights.sum(-1, keepdims=True)
    qflat = (weights[:, :, None] * q[:, None, :]).reshape(B, F * E).astype(np.float32)
    return dict(
        q=q, docs=docs, W=w, Wh=wh, mask=np.ones(F, np.float32),
        maskh=np.array([1, 1, 1, 0], np.float32), qflat=qflat,
        sparse=rng.gamma(1.0, size=(B, N)).astype(np.float32),
        ids=rng.integers(0, N, size=(B, 24)).astype(np.int64),
        vals=rng.gamma(2.0, size=(B, 24)).astype(np.float32),
        fidx=rng.integers(0, 2, size=(B, 24)).astype(np.int8),
        cand=rng.integers(0, N, size=(B, C)).astype(np.int64),
    )


def _topk(scores, k=K):
    idx = np.argsort(-scores, axis=-1, kind="stable")[..., :k]
    return np.take_along_axis(scores, idx, axis=-1), idx


def _reference_routes(r):
    """Each route's result on one device, in numpy: a full scan of the
    whole corpus and an exact top-k."""
    q, docs = r["q"].astype(np.float64), r["docs"].astype(np.float64)
    d3 = docs.reshape(N, F, E)

    def weights(w, mask):
        logits = q @ w
        e = np.exp(logits - logits.max(-1, keepdims=True))
        return e / e.sum(-1, keepdims=True) * mask

    def folded(w):
        return np.einsum("bf,be,nfe->bn", w[:, :F], q, d3)

    wh = weights(r["Wh"], r["maskh"])
    post = np.zeros((B, N))
    for b in range(B):
        np.add.at(post[b], r["ids"][b], r["vals"][b] * wh[b, F + r["fidx"][b].astype(int)])
    per_field = np.einsum("be,nfe->bfn", q, d3)
    cand = np.einsum("be,bcfe->bcf", q, d3[r["cand"]])
    out = {
        "dense": _topk(r["qflat"] @ docs.T),
        "hybrid": _topk(r["qflat"] @ docs.T + r["sparse"]),
        "fused_dense": _topk(folded(weights(r["W"], r["mask"]))),
        "fused_hybrid": _topk(folded(wh) + post),
        "per_field": _topk(per_field),
        "cand": cand,
    }
    out["slice_fused_dense"], out["slice_cand"] = out["fused_dense"], cand
    return out


def _keyed(scores, ids):
    """[..., k] (scores, ids) -> per-row [(id, score)] lists without -inf."""
    s = np.asarray(scores).reshape(-1, np.shape(scores)[-1])
    i = np.asarray(ids).reshape(-1, np.shape(ids)[-1])
    return [[(str(int(d)), float(v)) for d, v in zip(ir, sr) if np.isfinite(v)]
            for sr, ir in zip(s, i)]


def _agree(got, want):
    msg = rankings_agree(got, want, RTOL, ATOL)
    assert msg is None, msg


ENGINE_CASES = [
    # name, fields, queries, mode, port route, JAX route (None: JAX names no rerank route)
    ("dense_exact", DENSE, "queries", "exact", "mesh-dense", "mesh-dense"),
    ("dense_rerank", DENSE, "queries", "rerank", "mesh-rerank", None),
    ("hybrid_postings", HYBRID, "queries", "exact", "mesh-hybrid-postings",
     "mesh-hybrid-postings"),
    ("hybrid_combined", HYBRID, "dense", "exact", "mesh-hybrid-combined",
     "mesh-hybrid-combined"),
    ("hybrid_rerank", HYBRID, "queries", "rerank", "mesh-rerank-hybrid", None),
    ("slice_postings", HYBRID, "queries", "exact", "mesh-hybrid-postings",
     "mesh-hybrid-postings"),
    ("slice_rerank", HYBRID, "queries", "rerank", "mesh-rerank-hybrid", None),
]


def _jax_engines(w, spec, corpus, pairs, encode, tok, matrix):
    """The JAX mesh engines on the first W virtual devices, one per (fields,
    corpus layout), shared by the cases that use them (each new engine
    compiles its routes anew): {case name: (results, route)}."""
    engines, out = {}, {}
    for name, fields, qs, mode, *_ in ENGINE_CASES:
        per_slice = name.startswith("slice")
        if (fields, per_slice) not in engines:
            jm = jax_mesh.make_mesh(n_replica=2 if per_slice else 1, devices=jax.devices()[:w])
            jfi = jax_resolve_fields(fields, "amazon")
            mixer = spec["mixer_dense" if fields == DENSE else "mixer_hybrid"]
            sparse = {fk: JaxBM25.create(jax_format_documents(pairs, f.name, "amazon"),
                                         name=f.name, backend="scipy")
                      for fk, f in jfi.items() if f.is_sparse}
            engines[(fields, per_slice)] = JaxEngine(
                field_info=jfi, doc_keys=list(corpus.keys()), encode_fn=encode, tokenizer=tok,
                mixer_params={"weight": jnp.asarray(mixer)}, dense_matrix=matrix,
                sparse_indices=sparse, query_max_length=64, recall_k=10, mesh=jm,
                corpus_per_slice=per_slice, use_pallas_gather=False)
        jeng = engines[(fields, per_slice)]
        # one JAX batch (each new batch shape compiles); the ranks serve two
        got = jeng.retrieve_many(spec["queries"] if qs == "queries" else DENSE_POSTINGS,
                                 top_k=10, mode=mode, batch_size=8)
        out[name] = (got, jeng.last_serve_path)
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both gloo worlds, started together, and the JAX side's inputs."""
    root = tmp_path_factory.mktemp("mesh")
    corpus = make_amazon_corpus(N_DOCS)
    queries = list(make_queries_and_qrels(corpus, n_queries=8)[0].values())
    pairs = list(corpus.pairs())
    texts = [t for f in ("title", "description") for _, t in jax_format_documents(pairs, f, "amazon")]
    texts += queries + DENSE_POSTINGS
    jtok = JaxTokenizer.build(texts, max_length=64)
    jcfg = JaxConfig.tiny(vocab_size=jtok.vocab_size, hidden_size=HIDDEN, num_layers=2,
                          num_heads=2, intermediate_size=256)
    params = jax.tree.map(np.asarray, init_params(jcfg))
    pcfg = EncoderConfig.tiny(vocab_size=jtok.vocab_size, hidden_size=HIDDEN, num_layers=2,
                              num_heads=2, intermediate_size=256)
    rng = np.random.default_rng(1)
    spec = dict(
        routes=_route_inputs(), k=K, num_fields=F, chunk=CHUNK, n_docs=N_DOCS,
        vocab_texts=texts, queries=queries, dense_postings=DENSE_POSTINGS,
        encoder_config={f: getattr(pcfg, f) for f in pcfg.__dataclass_fields__},
        encoder_state=encoder_state_from_jax(params, pcfg), dense=DENSE, hybrid=HYBRID,
        mixer_dense=rng.normal(scale=0.3, size=(HIDDEN, 2)).astype(np.float32),
        mixer_hybrid=rng.normal(scale=0.3, size=(HIDDEN, 4)).astype(np.float32),
    )
    torch.save(spec, str(root / "spec.pt"))
    procs = {}
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    for w in WORLDS:
        out = root / f"w{w}"
        out.mkdir()
        procs[w] = [subprocess.Popen(
            [sys.executable, WORKER, str(r), str(w), str(root / f"init{w}"),
             str(root / "spec.pt"), str(out)],
            env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(w)]

    # the JAX side while the ranks run
    @jax.jit
    def jax_encode(ids, mask):
        return JaxEncoder(jcfg).apply({"params": params}, ids, mask)

    jax_matrix = np.asarray(jax_index.build_dense_corpus_matrix(
        jax_encode, jtok, corpus, jax_resolve_fields(DENSE, "amazon"), batch_size=16))
    # the worlds' JAX engines in two threads: their time is XLA's compiles,
    # which release the GIL
    with ThreadPoolExecutor(len(WORLDS)) as ex:
        runs = {w: ex.submit(_jax_engines, w, spec, corpus, pairs, jax_encode, jtok, jax_matrix)
                for w in WORLDS}
    jax_engine = {(w, name): res for w, run in runs.items() for name, res in run.result().items()}
    logs = {}
    for w, ps in procs.items():
        for r, p in enumerate(ps):
            try:
                logs[(w, r)] = p.communicate(timeout=120)[0]
            except subprocess.TimeoutExpired:
                for q in (q for qs in procs.values() for q in qs):
                    q.kill()
                pytest.fail(f"rank {r} of {w} timed out:\n{p.communicate()[0][-3000:]}")
            assert p.returncode == 0, f"rank {r} of {w} failed:\n{logs[(w, r)][-4000:]}"
    results = {w: [torch.load(str(root / f"w{w}" / f"rank{r}.pt"), weights_only=False)
                   for r in range(w)] for w in WORLDS}
    return dict(results=results, spec=spec, jax_matrix=jax_matrix, jax_engine=jax_engine)


def test_every_rank_agrees_and_loads_no_jax(worlds):
    for w, ranks in worlds["results"].items():
        assert ranks[0]["shapes"] == ({"replica": 1, "data": w, "model": 1},
                                      {"replica": 2, "data": w // 2, "model": 1})
        for r, res in enumerate(ranks):
            assert not [m for m in res["modules"] if m.split(".")[0] in ("jax", "mfar_tpu")]
            for key, val in res.items():
                if key.startswith(("flat/", "sliced/")):
                    for a, b in zip(val if isinstance(val, tuple) else (val,),
                                    ranks[0][key] if isinstance(val, tuple) else (ranks[0][key],)):
                        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=f"{key} rank {r}")
                elif key.startswith("engine/"):
                    assert val == ranks[0][key], (key, r)


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("tag", ["flat", "sliced"])
def test_routes_match_a_full_scan(worlds, w, tag):
    """Every route at W ranks, on a flat and a sliced mesh, against the same
    function on one device (numpy, f64): each shard's local top-k and the
    merge give the whole corpus's top-k, postings scatter on the shard that
    owns their row, and stage 2 sums each candidate's one nonzero shard."""
    want = _reference_routes(worlds["spec"]["routes"])
    got = worlds["results"][w][0]
    names = {k.split("/")[1] for k in got if k.startswith(f"{tag}/")}
    assert names == set(want) - ({"slice_fused_dense", "slice_cand"} if tag == "flat" else set())
    for name in names:
        port, ref = got[f"{tag}/{name}"], want[name]
        if "cand" in name:
            np.testing.assert_allclose(port.numpy(), ref, rtol=RTOL, atol=ATOL, err_msg=name)
        else:
            assert port[0].shape == ref[0].shape, name
            _agree(_keyed(*port), _keyed(*ref))


@pytest.mark.parametrize("w", WORLDS)
def test_index_build_over_ranks_matches_jax(worlds, w):
    got = worlds["results"][w][0]["matrix"]
    assert got.shape == (N_DOCS, 2, HIDDEN)
    np.testing.assert_allclose(got, worlds["jax_matrix"], atol=2e-4)


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("name,fields,qs,mode,route,jax_route", ENGINE_CASES,
                         ids=[c[0] for c in ENGINE_CASES])
def test_engine_matches_the_jax_mesh_engine(worlds, w, name, fields, qs, mode, route,
                                            jax_route):
    want, want_path = worlds["jax_engine"][(w, name)]
    got, path = worlds["results"][w][0][f"engine/{name}"]
    assert path == route
    if jax_route is not None:
        assert want_path == jax_route
    _agree(got, want)


# -- the pure helpers, in this process ---------------------------------


def test_pad_rows_matches_jax():
    x = np.arange(15, dtype=np.float32).reshape(5, 3)
    for multiple in (1, 2, 4, 5):
        got, want = port_mesh.pad_rows(x, multiple), jax_mesh.pad_rows(x, multiple)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1] == 5


@pytest.mark.parametrize("n_shards,n,k,chunk", [(2, 204, 7, 16), (4, 204, 100, 16),
                                                (4, 8, 5, 131072), (1, 203, 7, 64)])
def test_shard_geometry_matches_jax(n_shards, n, k, chunk):
    class FakeMesh:
        shape = {"data": n_shards}

    want = jax_topk._shard_geometry(FakeMesh(), n, k, chunk, "data")
    assert (n_shards, *port_topk._shard_geometry(n_shards, n, k, chunk)) == want
    with pytest.raises(ValueError, match="pad rows first"):
        port_topk._shard_geometry(n_shards + 1, (n_shards + 1) * 3 + 1, k, chunk)


def test_merge_pads_with_neg_inf():
    cs = torch.tensor([[1.0, 5.0, 3.0], [2.0, float("-inf"), 0.5]])
    ci = torch.tensor([[10, 11, 12], [20, 21, 22]])
    s, i = port_topk.merge_topk_lists(cs, ci, 5)
    assert s.shape == i.shape == (2, 5)
    torch.testing.assert_close(s[0, :3], torch.tensor([5.0, 3.0, 1.0]))
    assert i[0, :3].tolist() == [11, 12, 10] and i[1, :2].tolist() == [20, 22]
    assert torch.isneginf(s[:, 3:]).all() and (i[:, 3:] == 0).all()
    s3, i3 = port_topk.merge_topk_lists(cs[:, None].expand(2, 3, 3), ci[:, None].expand(2, 3, 3), 2)
    assert s3.shape == (2, 3, 2) and i3[0, 0].tolist() == [11, 12]


def test_mesh_from_flag_is_none_for_one_process():
    assert not torch.distributed.is_initialized()
    for flag in ("auto", "off"):
        assert port_mesh.mesh_from_flag(flag, n_model=2, n_replica=2) is None


def test_a_forced_k1_gather_refuses_a_mesh():
    """K1 reads one device's whole corpus: ``use_pallas_gather=True`` with a
    mesh raises, as the JAX engine asserts (``"auto"`` resolves it off)."""
    from types import SimpleNamespace

    from mfar_tpu_torch.data.schema import resolve_fields
    from mfar_tpu_torch.eval.retrieval import RetrievalEngine

    mesh = SimpleNamespace(shape={"replica": 1, "data": 2, "model": 1})
    with pytest.raises(ValueError, match="not composed with the mesh"):
        RetrievalEngine(resolve_fields(DENSE, "amazon"), ["a", "b"], None, None,
                        {"weight": np.ones((1, 2), np.float32)},
                        dense_matrix=np.zeros((2, 2, 8), np.float32), mesh=mesh,
                        use_pallas_gather=True, device="cpu")
