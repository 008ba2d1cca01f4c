"""The port's commands over two processes (one gloo rank each, on the CPU):
``retrieve``, ``serve --smoke-out``, ``encode_corpus``, ``mask_fields``
and ``train`` (then ``train --resume``), each started as a pair with ``MFAR_COORDINATOR=file://...`` (so that
parallel test workers never share a port) and ``--multihost force``, all
pairs at once, once for the module.

The dataset has 61 documents (rows that do not divide 2), the model is the
JAX package's synthetic encoder carried into a port checkpoint
(``models/convert.py``), and the reference is the JAX engine on a mesh of 2
of the suite's virtual CPU devices over the same weights: the two-process
``retrieve`` run file and ``serve`` answers hold to its ranking at rtol 1e-4
/ atol 1e-3, ties allowed.  Only rank 0 writes; rank 0 names the route
(``[mesh-hybrid-postings]``); the follower leaves on the stop message; the
two-rank ``encode_corpus`` equals the one-process file and the two-rank
``mask_fields`` the one-process metrics; the two-rank ``train`` run's
metrics hold to one process's within the JAX package's two-process
tolerance, and so do those of ``train --n-model 2`` (the encoder sharded
over the two ranks), whose checkpoints resume in one process.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mfar_tpu.commands.common import corpus_texts_for_vocab as jax_vocab_texts
from mfar_tpu.commands.common import load_corpus as jax_load_corpus
from mfar_tpu.data import trec as jax_trec
from mfar_tpu.data.schema import resolve_fields as jax_resolve_fields
from mfar_tpu.eval.index_build import build_dense_corpus_matrix as jax_build_matrix
from mfar_tpu.eval.index_build import build_sparse_indices as jax_sparse_indices
from mfar_tpu.eval.index_build import make_encode_fn as jax_make_encode_fn
from mfar_tpu.eval.retrieval import RetrievalEngine as JaxEngine
from mfar_tpu.models import build_encoder as jax_build_encoder
from mfar_tpu.models.registry import prepare_model as jax_prepare_model
from mfar_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mfar_tpu_torch.commands import create_sparse_index, encode_corpus, make_synth_data
from mfar_tpu_torch.commands import mask_fields
from mfar_tpu_torch.commands import train as train_cmd
from mfar_tpu_torch.data import trec
from mfar_tpu_torch.data.schema import resolve_fields
from mfar_tpu_torch.eval.compare import rankings_agree
from mfar_tpu_torch.eval.index_build import load_dense_matrix
from mfar_tpu_torch.models.convert import model_state_from_jax
from mfar_tpu_torch.models.registry import prepare_model
from mfar_tpu_torch.train.checkpoint import CheckpointManager
from mfar_tpu_torch.train.model import MFARModel
from mfar_tpu_torch.train.optim import make_optimizer
from mfar_tpu_torch.train.train_step import init_state

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-3
FIELDS = "title_dense,title_sparse"


def _flags(d):
    return ["--dataset-name", "amazon", "--data", d["data"], "--field-names", FIELDS,
            "--model-name", "synthetic", "--checkpoint-dir", d["run"], "--device", "cpu"]


# the JAX reference engine keeps the corpus in f32
ENGINE = ["--dense-dtype", "f32", "--top-k", "10"]


def _commands(d, tmp):
    """Each command's argv per rank (rank 1's outputs go to their own paths,
    which must stay unwritten)."""
    engine = _flags(d) + ["--lexical-index", d["idx"], *ENGINE]
    return {
        "retrieve": lambda r: ["mfar_tpu_torch.commands.retrieve", *engine, "--batch-size", "8",
                               "--out", str(tmp / f"run{r}.qres"), "--multihost", "force"],
        "serve": lambda r: ["mfar_tpu_torch.commands.serve", *engine, "--mode", "rerank",
                            "--recall-k", "20", "--max-batch", "8", "--port", "0",
                            "--smoke-out", str(tmp / f"smoke{r}.json"), "--multihost", "force"],
        "encode": lambda r: ["mfar_tpu_torch.commands.encode_corpus", *_flags(d),
                             "--batch-size", "8", "--out", str(tmp / f"enc{r}.npz")],
        "mask": lambda r: ["mfar_tpu_torch.commands.mask_fields", *_flags(d), "--lexical-index",
                           d["idx"], "--out", str(tmp / f"mask{r}"), "--debug",
                           "--recall-k", "20", "--dev-max-length", "64",
                           "--multihost", "force"],
        "train": lambda r: ["mfar_tpu_torch.commands.train", *_train_flags(d),
                            "--out", str(tmp / f"train{r}"), "--multihost", "force"],
        "tp": lambda r: ["mfar_tpu_torch.commands.train", *_train_flags(d, "--n-model", "2"),
                         "--out", str(tmp / f"tp{r}"), "--multihost", "force"],
    }


def _train_flags(d, *extra):
    """The train command's flags (those of the JAX package's two-process
    test, dropout 0: each rank draws its own masks)."""
    return ["--dataset-name", "amazon", "--data", d["data"], "--lexical-index", d["idx"],
            "--field-names", FIELDS, "--model-name", "synthetic", "--weights-lr", "0.1",
            "--train-batch-size", "4", "--max-epochs", "2", "--trec-val-freq", "1",
            "--recall-k", "10", "--dev-batch-size", "8", "--hidden-dropout", "0",
            "--attention-dropout", "0", "--device", "cpu", *extra]


def _start(name, argv, tmp, env, world=2):
    """The ranks of one command, joined through ``file://``."""
    return [subprocess.Popen(
        [sys.executable, "-c", "import torch; torch.set_num_threads(1); import runpy, sys; "
         "sys.argv = sys.argv[1:]; runpy.run_module(sys.argv[0], run_name='__main__')",
         *argv(r)],
        env=dict(env, MFAR_COORDINATOR=f"file://{tmp / f'init_{name}'}",
                 MFAR_NUM_PROCESSES=str(world), MFAR_PROCESS_ID=str(r)),
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


def _wait(procs, logs):
    for name, pair in procs.items():
        for r, p in enumerate(pair):
            try:
                logs[(name, r)] = p.communicate(timeout=120)[0]
            except subprocess.TimeoutExpired:
                for q in (q for qs in procs.values() for q in qs):
                    q.kill()
                pytest.fail(f"{name} rank {r} timed out:\n{p.communicate()[0][-3000:]}")
            assert p.returncode == 0, f"{name} rank {r} failed:\n{logs[(name, r)][-4000:]}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mh")
    d = {k: str(tmp / k) for k in ("data", "idx", "run")}
    make_synth_data.main(["--out", d["data"], "--dataset-name", "amazon", "--n-docs", "61",
                          "--n-train", "8", "--n-val", "8", "--seed", "3"])
    create_sparse_index.main(["--data-path", d["data"], "--dataset-name", "amazon",
                              "--output-path", d["idx"]])
    # the JAX synthetic encoder and a mixer, in a port checkpoint
    corpus = jax_load_corpus(d["data"], "amazon")
    jfi = jax_resolve_fields(FIELDS, "amazon")
    jcfg, jparams, jtok = jax_prepare_model("synthetic",
                                            corpus_texts=jax_vocab_texts(corpus, jfi))
    mixer = np.random.default_rng(4).normal(scale=0.5, size=(jcfg.hidden_size, len(jfi)))
    mixer = mixer.astype(np.float32)
    pfi = resolve_fields(FIELDS, "amazon")
    pcfg, _, _ = prepare_model("synthetic", corpus_texts=jax_vocab_texts(corpus, jfi))
    pstate = init_state(MFARModel(encoder_config=pcfg, num_fields=len(pfi)),
                        make_optimizer(encoder_lr=1e-4, weights_lr=1e-1), device="cpu")
    pstate.model.load_state_dict(model_state_from_jax(jax.tree.map(
        np.asarray, {"encoder": jparams, "mixer": {"weight": mixer}})))
    ckpt = CheckpointManager(d["run"])
    ckpt.save(0, pstate, {"valid_loss": 1.0}, field_info=pfi, config={})
    ckpt.write_best_txt()

    env = {k: v for k, v in os.environ.items() if not k.startswith("MFAR_")}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = {name: _start(name, argv, tmp, env) for name, argv in _commands(d, tmp).items()}
    # three ranks and a batch of 4: the data axis shrinks to 2, rank 2 sits idle
    procs["idle"] = _start("idle", lambda r: [
        "mfar_tpu_torch.commands.train", *_train_flags(d, "--run-one-iteration"), "--out",
        str(tmp / f"idle{r}"), "--multihost", "force"], tmp, env, world=3)
    # the train command in one process, while the ranks run
    train_cmd.main([*_train_flags(d), "--out", str(tmp / "train_one")])
    # the JAX engine on a mesh of 2 virtual devices over the same weights,
    # while the ranks run
    encoder = jax_build_encoder(jcfg)
    jmesh = jax_make_mesh(devices=jax.devices()[:2])
    encode = jax_make_encode_fn(encoder, jparams, mesh=jmesh)
    matrix = jax_build_matrix(encode, jtok, corpus, {k: f for k, f in jfi.items() if f.is_dense})
    jeng = JaxEngine(field_info=jfi, doc_keys=list(corpus.keys()), encode_fn=encode,
                     tokenizer=jtok, mixer_params={"weight": jnp.asarray(mixer)},
                     dense_matrix=matrix, sparse_indices=jax_sparse_indices(corpus, jfi),
                     recall_k=20, mesh=jmesh)
    queries = jax_trec.read_queries(os.path.join(d["data"], "test.queries"))
    want = {mode: dict(zip(queries, jeng.retrieve_many(list(queries.values()), top_k=10,
                                                       mode=mode, batch_size=8)))
            for mode in ("exact", "rerank")}
    logs = {}
    _wait(procs, logs)
    # --resume from rank 0's checkpoints: a third epoch, on two ranks and on one
    resume = ["--resume", "--max-epochs", "3"]
    procs = {"resume": _start("resume", lambda r: [
        "mfar_tpu_torch.commands.train", *_train_flags(d, *resume), "--out",
        str(tmp / f"train{r}"), "--multihost", "force"], tmp, env)}
    train_cmd.main([*_train_flags(d, *resume), "--out", str(tmp / "train_one")])
    # the tensor-parallel run's checkpoints, resumed in one process
    train_cmd.main([*_train_flags(d, *resume), "--out", str(tmp / "tp0")])
    _wait(procs, logs)
    return dict(tmp=tmp, d=d, logs=logs, want=want, jax_route=jeng.last_serve_path)


def _qres_ranking(path):
    out = {}
    for r in trec.QRes.from_file(path):
        out.setdefault(r.query_id, []).append((r.doc_id, float(r.sim)))
    return out


def _agree(got: dict, want: dict):
    assert got.keys() == want.keys()
    msg = rankings_agree([got[q] for q in want], [want[q] for q in want], RTOL, ATOL)
    assert msg is None, msg


def test_two_process_retrieve_matches_the_jax_mesh(runs):
    tmp, logs = runs["tmp"], runs["logs"]
    assert not os.path.exists(tmp / "run1.qres")  # rank 0 owns file I/O
    assert "[mesh-hybrid-postings]" in logs[("retrieve", 0)]
    assert runs["jax_route"] == "mesh-hybrid-postings"
    assert "[retrieve] multihost: process 1/2" in logs[("retrieve", 1)]
    _agree(_qres_ranking(str(tmp / "run0.qres")), runs["want"]["exact"])


def test_two_process_serve_smoke_matches_the_jax_mesh(runs):
    tmp, logs = runs["tmp"], runs["logs"]
    assert not os.path.exists(tmp / "smoke1.json")
    assert "[serve] follower 1 done" in logs[("serve", 1)]
    smoke = json.load(open(tmp / "smoke0.json"))
    assert smoke["stats"]["errors"] == 0
    assert smoke["stats"]["queries"] == len(smoke["qids"])
    got = {q: [(k, s) for k, s in hits] for q, hits in zip(smoke["qids"], smoke["results"])}
    _agree(got, runs["want"]["rerank"])


def test_two_rank_encode_and_mask_fields_equal_one_process(runs, tmp_path):
    tmp, d = runs["tmp"], runs["d"]
    assert not os.path.exists(tmp / "enc1.npz") and not os.path.exists(tmp / "mask1")
    argv = _commands(d, tmp_path)
    encode_corpus.main(argv["encode"](0)[1:])
    one, keys = load_dense_matrix(str(tmp_path / "enc0.npz"))
    two, keys2 = load_dense_matrix(str(tmp / "enc0.npz"))
    assert keys == keys2 and one.shape == two.shape == (61, 1, one.shape[-1])
    np.testing.assert_allclose(two, one, rtol=0, atol=1e-5)
    mask_fields.main([a for a in argv["mask"](0)[1:] if a not in ("--multihost", "force")])

    def records(out):
        with open(os.path.join(out, "results_dicts.jsonl")) as f:
            return [json.loads(line) for line in f]

    assert records(str(tmp / "mask0")) == records(str(tmp_path / "mask0"))


def _epochs(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [r for r in rows if r.get("event") == "metrics" and "train_loss" in r]


def test_two_process_train_matches_one_process(runs):
    """The train command over two ranks (rank 0 writes; both restore the
    best checkpoint before the test) against one process: per-epoch losses
    and dev ndcg@10 within the JAX package's two-process tolerance, 2e-3 +
    1e-3 |x| (``tests/test_multihost.py``), the two first epochs and the
    third, resumed from rank 0's checkpoint."""
    tmp, logs = runs["tmp"], runs["logs"]
    assert not os.path.exists(tmp / "train1")  # rank 1 writes nothing
    for r in range(2):
        assert f"[train] multihost: process {r}/2" in logs[("train", r)]
        assert "Resumed from checkpoint 1 (epoch 2)" in logs[("resume", r)]
        for name in ("train", "resume"):
            assert f"[train] rank {r}: restored the best checkpoint" in logs[(name, r)]
    assert "[train] mesh: {'replica': 1, 'data': 2, 'model': 1} over 2/2 ranks (gloo)" in \
        logs[("train", 0)]
    two, one = _epochs(str(tmp / "train0")), _epochs(str(tmp / "train_one"))
    assert len(two) == len(one) == 3
    for got, want in zip(two, one):
        for key in ("train_loss", "valid_loss", "dev_ndcg_cut_10"):
            assert abs(got[key] - want[key]) <= 2e-3 + 1e-3 * abs(want[key]), (key, got, want)
    assert sorted(os.listdir(tmp / "train0" / "checkpoints")) == ["0", "1", "2"]
    with open(tmp / "train0" / "results_dicts.jsonl") as f:
        got = [json.loads(line) for line in f]
    with open(tmp / "train_one" / "results_dicts.jsonl") as f:
        want = [json.loads(line) for line in f]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for key in ("ndcg_cut_10", "recall_10", "recip_rank"):
            assert abs(float(g[key]) - float(w[key])) <= 2e-3 + 1e-3 * float(w[key]), key


def test_a_batch_that_does_not_divide_the_ranks_leaves_one_idle(runs):
    """Three ranks, a train batch of 4: the mesh's data axis shrinks to 2,
    as the JAX command shrinks it on one slice; rank 2 exits at once, and
    the two others train."""
    tmp, logs = runs["tmp"], runs["logs"]
    assert ("[train] mesh: {'replica': 1, 'data': 2, 'model': 1} over 2/3 ranks (gloo) "
            "(1 ranks idle: batch 4)") in logs[("idle", 0)]
    assert "[train] rank 2 is idle (1 ranks idle: batch 4)" in logs[("idle", 2)]
    assert "Starting training" not in logs[("idle", 2)]
    assert len(_epochs(str(tmp / "idle0"))) == 1
    assert not os.path.exists(tmp / "idle1") and not os.path.exists(tmp / "idle2")


def test_two_process_tensor_parallel_train_matches_one_process(runs):
    """``train --n-model 2`` over two ranks: the JAX command's mesh line,
    per-epoch losses and dev
    ndcg@10 within the two-process tolerance of one process's; rank 0's
    checkpoints in one process's layout, the third epoch resumed from them
    in one process (``--n-model 1``) within it too."""
    tmp, logs = runs["tmp"], runs["logs"]
    assert not os.path.exists(tmp / "tp1")
    assert "[train] mesh: {'replica': 1, 'data': 1, 'model': 2} over 2/2 ranks (gloo)" in \
        logs[("tp", 0)]
    two, one = _epochs(str(tmp / "tp0")), _epochs(str(tmp / "train_one"))
    assert len(two) == len(one) == 3
    for got, want in zip(two, one):
        for key in ("train_loss", "valid_loss", "dev_ndcg_cut_10"):
            assert abs(got[key] - want[key]) <= 2e-3 + 1e-3 * abs(want[key]), (key, got, want)
    tp, single = CheckpointManager(str(tmp / "tp0")), CheckpointManager(str(tmp / "train_one"))
    for step in (1, 2):
        a, b = tp.read(step), single.read(step)
        assert {k: v.shape for k, v in a["model"].items()} == \
            {k: v.shape for k, v in b["model"].items()}
        assert {i: {k: getattr(v, "shape", v) for k, v in e.items() if k != "step"}
                for i, e in a["optimizer"]["state"].items()} == \
            {i: {k: getattr(v, "shape", v) for k, v in e.items() if k != "step"}
             for i, e in b["optimizer"]["state"].items()}
