"""The serving daemon: the port's MicroBatcher and RetrievalServer on the CPU
against the JAX package's, over engines with the same weights.

The world is ``tests/test_server.py``'s: 40 synthetic amazon docs, the
fields ``title_dense,title_sparse``, a tiny f32 encoder and a
query-conditioned mixer; the port's engine carries the JAX encoder's and
mixer's weights (``encoder_state_from_jax``, ``mixer_from_jax``).  Each
package's server answers the same HTTP requests; the answers are compared
with ties allowed at rtol = atol = 1e-4 (each package encodes the queries
itself: the encoder's f32 drift, as in ``tests/test_torch_engine.py``).
Every server binds port 0, every HTTP call has a timeout, and every server
shuts down in ``finally``.
"""

import argparse
import json
import socket
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mfar_tpu.commands import make_synth_data as jax_msd
from mfar_tpu.commands import serve as jax_serve_cmd
from mfar_tpu.data.format import format_documents as jax_format_documents
from mfar_tpu.data.schema import resolve_fields as jax_resolve_fields
from mfar_tpu.data.synth import make_amazon_corpus, make_queries_and_qrels
from mfar_tpu.eval.index_build import build_dense_corpus_matrix as jax_build_matrix
from mfar_tpu.eval.index_build import build_sparse_indices as jax_sparse_indices
from mfar_tpu.eval.retrieval import RetrievalEngine as JaxEngine
from mfar_tpu.models import Encoder as JaxEncoder
from mfar_tpu.models import EncoderConfig as JaxConfig
from mfar_tpu.models import SimpleVocabTokenizer as JaxTokenizer
from mfar_tpu.models.encoder import init_params
from mfar_tpu.serve import RetrievalServer as JaxServer
from mfar_tpu_torch.commands import make_synth_data as port_msd
from mfar_tpu_torch.commands import serve as port_serve_cmd
from mfar_tpu_torch.commands.common import requested_mesh
from mfar_tpu_torch.data.schema import resolve_fields
from mfar_tpu_torch.data.types import Corpus
from mfar_tpu_torch.eval.compare import rankings_agree
from mfar_tpu_torch.eval.index_build import build_dense_corpus_matrix, build_sparse_indices
from mfar_tpu_torch.eval.index_build import make_encode_fn
from mfar_tpu_torch.eval.retrieval import RetrievalEngine
from mfar_tpu_torch.models.convert import encoder_state_from_jax, mixer_from_jax
from mfar_tpu_torch.models.encoder import Encoder, EncoderConfig
from mfar_tpu_torch.models.tokenizer import SimpleVocabTokenizer
from mfar_tpu_torch.serve import MicroBatcher, RetrievalServer, _Pending

torch.set_num_threads(1)

RTOL = ATOL = 1e-4
FIELDS = "title_dense,title_sparse"
TIMEOUT = 60


def _agree(got, want):
    msg = rankings_agree([[tuple(h) for h in r] for r in got],
                         [[tuple(h) for h in r] for r in want], RTOL, ATOL)
    assert msg is None, msg


@pytest.fixture(scope="module")
def world():
    corpus = make_amazon_corpus(40)
    queries = list(make_queries_and_qrels(corpus, n_queries=12)[0].values())
    jfi = jax_resolve_fields(FIELDS, "amazon")
    texts = []
    for f in jfi.values():
        texts += [t for _, t in jax_format_documents(corpus.pairs(), f.name, "amazon")]
    texts += queries + ["warmup"]
    jtok = JaxTokenizer.build(texts, max_length=64)
    jcfg = JaxConfig.tiny(vocab_size=jtok.vocab_size)
    params = jax.tree.map(np.asarray, init_params(jcfg))
    model = JaxEncoder(jcfg)

    @jax.jit
    def jax_encode(ids, mask):
        return model.apply({"params": params}, ids, mask)

    mixer = np.random.default_rng(0).normal(size=(jcfg.hidden_size, 2)).astype(np.float32)
    dense = {k: f for k, f in jfi.items() if f.is_dense}
    jax_engine = JaxEngine(
        field_info=jfi, doc_keys=list(corpus.keys()), encode_fn=jax_encode, tokenizer=jtok,
        mixer_params={"weight": jnp.asarray(mixer)},
        dense_matrix=jax_build_matrix(jax_encode, jtok, corpus, dense),
        sparse_indices=jax_sparse_indices(corpus, jfi), query_max_length=64)

    pcorpus = Corpus.from_pairs(list(corpus.pairs()), "amazon")
    pfi = resolve_fields(FIELDS, "amazon")
    ptok = SimpleVocabTokenizer.build(texts, max_length=64)
    pcfg = EncoderConfig.tiny(vocab_size=ptok.vocab_size)
    enc = Encoder(pcfg)
    enc.load_state_dict(encoder_state_from_jax(params, pcfg))
    encode = make_encode_fn(enc, device="cpu")
    pdense = {k: f for k, f in pfi.items() if f.is_dense}
    engine = RetrievalEngine(
        field_info=pfi, doc_keys=list(pcorpus.keys()), encode_fn=encode, tokenizer=ptok,
        mixer_params=mixer_from_jax({"weight": mixer}),
        dense_matrix=build_dense_corpus_matrix(encode, ptok, pcorpus, pdense),
        sparse_indices=build_sparse_indices(pcorpus, pfi), query_max_length=64, device="cpu")
    return dict(engine=engine, jax_engine=jax_engine, queries=queries)


def _post(base, payload, timeout=TIMEOUT):
    data = payload if isinstance(payload, bytes) else json.dumps(payload).encode()
    req = urllib.request.Request(base + "/retrieve", data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=TIMEOUT) as r:
        return json.loads(r.read())


def _status(base, payload=None, path="/retrieve"):
    """The HTTP status of a request that fails."""
    with pytest.raises(urllib.error.HTTPError) as ei:
        if payload is None:
            _get(base, path)
        else:
            req = urllib.request.Request(base + path, data=payload)
            urllib.request.urlopen(req, timeout=TIMEOUT)
    return ei.value.code


def test_http_answers_and_keys_match_jax(world):
    """Both daemons answer the same requests alike; ``/healthz`` and
    ``/stats`` carry the JAX daemon's keys."""
    qs = world["queries"]
    requests = [{"queries": qs[:3], "top_k": 4}, {"queries": qs[3:8]}, {"queries": [qs[8]]}]
    answers, health, stats = {}, {}, {}
    servers = {"jax": JaxServer(world["jax_engine"], port=0, max_batch=8, max_wait_ms=1.0,
                                top_k=5),
               "port": RetrievalServer(world["engine"], port=0, max_batch=8, max_wait_ms=1.0,
                                       top_k=5)}
    try:
        for name, srv in servers.items():
            srv.start_background()
            base = f"http://{srv.host}:{srv.port}"
            answers[name] = [_post(base, r)["results"] for r in requests]
            health[name] = _get(base, "/healthz")
            stats[name] = _get(base, "/stats")
    finally:
        for srv in servers.values():
            srv.shutdown()
    for got, want in zip(answers["port"], answers["jax"]):
        _agree(got, want)
    assert [len(h) for h in answers["port"][0]] == [4, 4, 4]
    assert set(health["port"]) == set(health["jax"])
    assert health["port"]["backend"] == "cpu" == health["jax"]["backend"]
    assert health["port"]["n_devices"] == torch.cuda.device_count()
    assert health["port"]["n_docs"] == 40
    assert set(stats["port"]) == set(stats["jax"])
    assert set(stats["port"]["phase_s"]) == set(stats["jax"]["phase_s"])
    for key in ("requests", "queries", "errors", "served_top_k", "max_batch", "pipeline_depth"):
        assert stats["port"][key] == stats["jax"][key], key


def test_port_stays_closed_until_warm(world):
    """No socket listens through construction and warmup; after start the
    port accepts."""
    srv = RetrievalServer(world["engine"], port=0, max_batch=4, top_k=5)
    try:
        assert srv.port is None
        assert srv.warmup(world["queries"][:2]) > 0
        assert srv.port is None
        srv.start_background()
        with socket.create_connection((srv.host, srv.port), timeout=5):
            pass
    finally:
        srv.shutdown()


def test_a_burst_of_connections_is_accepted(world):
    """48 clients connecting at the same moment are all answered (a listen
    backlog of socketserver's default 5 resets most of them)."""
    srv = RetrievalServer(world["engine"], port=0, max_batch=64, max_wait_ms=20.0, top_k=5)
    errors, answers = [], []
    barrier = threading.Barrier(48)

    def client(i):
        try:
            barrier.wait(timeout=TIMEOUT)
            base = f"http://{srv.host}:{srv.port}"
            answers.append(_post(base, {"queries": [world["queries"][i % 12]]}))
        except Exception as e:  # noqa: BLE001 -- collected and asserted below
            errors.append(repr(e))

    try:
        srv.start_background()
        threads = [threading.Thread(target=client, args=(i,)) for i in range(48)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
            assert not t.is_alive()
    finally:
        srv.shutdown()
    assert not errors, errors[:3]
    assert len(answers) == 48 and all(len(a["results"][0]) == 5 for a in answers)


class _Recorder:
    """The port's engine behind a log of the batches it was handed."""

    def __init__(self, engine):
        self.engine = engine
        self.n_docs = engine.n_docs
        self.device = engine.device
        self.batches = []

    def dispatch(self, queries, top_k=100, mode=None):
        self.batches.append(len(queries))
        return self.engine.dispatch(queries, top_k=top_k, mode=mode)

    def finish(self, handle):
        return self.engine.finish(handle)

    def retrieve(self, queries, top_k=100, mode=None):
        return self.engine.retrieve(queries, top_k=top_k, mode=mode)

    def retrieve_many(self, queries, top_k=100, mode=None, batch_size=256):
        self.batches.append(("many", len(queries), batch_size))
        return self.engine.retrieve_many(queries, top_k=top_k, mode=mode, batch_size=batch_size)


def test_batches_carry_only_real_queries(world):
    """A lone request is dispatched alone (no padding queries), its top_k
    sliced from the served depth; ``padded`` and ``mean_batch_fill`` count
    the room left against max_batch, as the JAX daemon reports them."""
    rec = _Recorder(world["engine"])
    b = MicroBatcher(rec, max_batch=8, max_wait_ms=1.0, top_k=5).start()
    try:
        out = b.submit([world["queries"][0]], top_k=3)
        assert len(out) == 1 and len(out[0]) == 3
        assert rec.batches == [1]
        st = b.stats()
        assert st["padded"] == 7 and st["queries"] == 1 and st["mean_batch_fill"] == 0.125
        _agree(out, [h[:3] for h in world["engine"].retrieve(world["queries"][:1], top_k=5)])
    finally:
        b.stop()


def test_concurrent_requests_coalesce_and_match_engine(world):
    eng, qs = world["engine"], world["queries"]
    b = MicroBatcher(eng, max_batch=8, max_wait_ms=200.0, top_k=5).start()
    try:
        results = [None] * 4

        def call(i):
            results[i] = b.submit([qs[2 * i], qs[2 * i + 1]])

        threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
            assert not t.is_alive()
        _agree([hit for r in results for hit in r], eng.retrieve(qs[:8], top_k=5))
        st = b.stats()
        assert st["queries"] == 8 and st["requests"] == 4 and st["batches"] >= 1
    finally:
        b.stop()


def test_a_daemon_answer_is_the_request_alone(world):
    """Requests coalesced into batches of up to 64 queries are answered
    with the same bits as ``engine.retrieve`` on each request alone: the
    engine's answer for a query does not depend on its batch."""
    eng, qs = world["engine"], world["queries"]
    rec = _Recorder(eng)
    b = MicroBatcher(rec, max_batch=64, max_wait_ms=200.0, top_k=5).start()
    requests = [[qs[(5 * i + j) % len(qs)] for j in range(8)] for i in range(6)]
    results = [None] * len(requests)

    def call(i):
        results[i] = b.submit(requests[i])

    try:
        threads = [threading.Thread(target=call, args=(i,)) for i in range(len(requests))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
            assert not t.is_alive()
    finally:
        b.stop()
    assert max(rec.batches) > 8  # some requests shared a batch
    for request, got in zip(requests, results):
        assert got == eng.retrieve(request, top_k=5)


def test_oversized_request_goes_through_retrieve_many(world):
    rec = _Recorder(world["engine"])
    b = MicroBatcher(rec, max_batch=4, max_wait_ms=1.0, top_k=5).start()
    try:
        out = b.submit(world["queries"][:10])
        assert rec.batches == [("many", 10, 4)]
        _agree(out, world["engine"].retrieve_many(world["queries"][:10], top_k=5,
                                                  batch_size=4))
        assert b.stats()["padded"] == 0
    finally:
        b.stop()


def test_overflowing_request_is_carried(world):
    """A request that would push a batch past max_batch opens the next
    batch instead of splitting."""
    b = MicroBatcher(world["engine"], max_batch=4, max_wait_ms=50.0, top_k=5)
    big, small = _Pending(["a", "b", "c"], None), _Pending(["d", "e"], None)
    b._q.put(big)
    b._q.put(small)
    assert b._collect() == [big] and b._carry is small
    assert b._collect() == [small] and b._carry is None


class _SplitLogEngine:
    """Engine stub with the dispatch/finish split, logging the call order."""

    n_docs = 10

    def __init__(self):
        self.log = []

    def dispatch(self, queries, top_k=100, mode=None):
        self.log.append(("dispatch", queries[0]))
        return (list(queries), top_k)

    def finish(self, handle):
        queries, top_k = handle
        self.log.append(("finish", queries[0]))
        return [[("d0", 1.0)][:top_k] for _ in queries]

    def retrieve(self, queries, top_k=100, mode=None):
        return self.finish(self.dispatch(queries, top_k, mode))


@pytest.mark.parametrize("depth", [1, 2])
def test_pipelined_dispatch(depth):
    """With a backlog, batch i+1 is dispatched before batch i is finished
    at depth 2, and after it at depth 1; an idle queue drains what is in
    flight."""
    eng = _SplitLogEngine()
    b = MicroBatcher(eng, max_batch=2, max_wait_ms=5.0, top_k=1, pipeline_depth=depth)
    items = [_Pending([f"q{i}a", f"q{i}b"], None) for i in range(3)]
    for it in items:
        b._q.put(it)
    b.start()
    try:
        for it in items:
            assert it.done.wait(30), "micro-batch never delivered"
            assert it.error is None and len(it.results) == 2
        log = eng.log
        ahead = log.index(("dispatch", "q1a")) < log.index(("finish", "q0a"))
        assert ahead == (depth == 2), log
        assert sum(1 for kind, _ in log if kind == "finish") == 3
        assert b.stats()["pipeline_depth"] == depth
    finally:
        b.stop()


class _FailingEngine(_SplitLogEngine):
    device = torch.device("cpu")

    def dispatch(self, queries, top_k=100, mode=None):
        raise RuntimeError("engine failed")


def test_bad_requests_and_engine_errors(world):
    """400 for a malformed body, 500 for an engine error, 404 for an
    unknown path; the server keeps answering."""
    b = MicroBatcher(world["engine"], max_batch=4, top_k=5)
    for queries, top_k in (([], None), (["q"], -1), (["q"], "10"), (["q"], 50)):
        with pytest.raises(ValueError):
            b.submit(queries, top_k=top_k)
    srv = RetrievalServer(world["engine"], port=0, max_batch=4, max_wait_ms=1.0, top_k=5)
    bad = RetrievalServer(_FailingEngine(), port=0, max_batch=4, max_wait_ms=1.0, top_k=5)
    try:
        srv.start_background()
        base = f"http://{srv.host}:{srv.port}"
        assert _status(base, b"{}") == 400
        assert _status(base, b"not json") == 400
        assert _status(base, json.dumps({"queries": []}).encode()) == 400
        assert _status(base, json.dumps({"queries": ["q"], "top_k": 99}).encode()) == 400
        assert _status(base, path="/nope") == 404
        assert len(_post(base, {"queries": ["shiny model"]})["results"][0]) == 5
        bad.start_background()
        assert _status(f"http://{bad.host}:{bad.port}", b'{"queries": ["q"]}') == 500
        assert bad.batcher.stats()["errors"] == 1
    finally:
        srv.shutdown()
        bad.shutdown()


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve_cli")
    dirs = {}
    for name, cmd in (("jax", jax_msd), ("port", port_msd)):
        dirs[name] = str(root / name)
        cmd.main(["--out", dirs[name], "--n-docs", "24", "--n-train", "4", "--n-val", "4"])
    return root, dirs


@pytest.mark.parametrize("mode", ["exact", "rerank"])
def test_serve_smoke_out_matches_the_jax_command(datasets, mode, capsys):
    """``serve --smoke-out --device cpu`` drives warmup, the port, an HTTP
    POST of the test queries, ``/stats`` and shutdown, and writes the JSON
    keys the JAX command writes; it logs as ``[serve]``."""
    root, dirs = datasets
    out = {}
    for name, cmd in (("jax", jax_serve_cmd), ("port", port_serve_cmd)):
        out[name] = str(root / f"smoke_{name}_{mode}.json")
        argv = ["--dataset-name", "amazon", "--data", dirs[name], "--field-names",
                "title_dense,title_sparse", "--model-name", "synthetic", "--mesh", "off",
                "--mode", mode, "--top-k", "5", "--max-batch", "4", "--port", "0",
                "--smoke-out", out[name]]
        capsys.readouterr()
        cmd.main(argv + (["--device", "cpu"] if name == "port" else []))
    printed = capsys.readouterr().out
    assert "[serve] listening" in printed and "[serve] smoke" in printed
    assert "[retrieve]" not in printed
    smoke = {name: json.load(open(path)) for name, path in out.items()}
    assert set(smoke["port"]) == set(smoke["jax"]) == {"qids", "results", "stats"}
    assert set(smoke["port"]["stats"]) == set(smoke["jax"]["stats"])
    assert smoke["port"]["qids"] == smoke["jax"]["qids"]
    assert all(len(hits) == 5 for hits in smoke["port"]["results"])
    assert smoke["port"]["stats"]["queries"] == len(smoke["port"]["qids"])
    assert smoke["port"]["stats"]["errors"] == 0


def test_serve_multihost_force_raises_a15(datasets, monkeypatch):
    """``--multihost force`` without the MFAR_* triple and ``pod`` without
    torchrun's environment exit before any work (serving over several
    processes, once A15, runs in tests/test_torch_multihost.py)."""
    _, dirs = datasets
    for var in ("MFAR_COORDINATOR", "MFAR_NUM_PROCESSES", "MFAR_PROCESS_ID", "RANK",
                "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    for value, match in (("force", "MFAR_COORDINATOR"), ("pod", "torchrun")):
        with pytest.raises(SystemExit, match=match):
            port_serve_cmd.main(["--dataset-name", "amazon", "--data", dirs["port"],
                                 "--model-name", "synthetic", "--multihost", value,
                                 "--device", "cpu"])


def test_serve_labels_its_lines(monkeypatch, capsys):
    """``build_engine``'s mesh note prints the command's label: ``[serve]``
    from the daemon, not ``[retrieve]``."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    args = argparse.Namespace(mesh="auto", device="cuda", n_model=1, n_replica=1)
    assert requested_mesh(args, "serve") is None
    printed = capsys.readouterr().out
    assert "[serve] --mesh auto: 2 visible cards" in printed and "[retrieve]" not in printed
