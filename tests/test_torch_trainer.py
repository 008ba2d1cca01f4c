"""The port's trainer end to end on the CPU at a tiny size (the counterpart
of ``tests/test_trainer.py`` with dense fields), the train command's output
layout against the JAX command's, and the training data pipeline's copies
against the JAX package's: BM25, the negative sampler and
``ContrastiveDataset``, batch for batch on one seed."""

import json
import os

import numpy as np
import pytest
import torch

from mfar_tpu.commands import train as jax_train_cmd
from mfar_tpu.data.negative_sampler import IndexNegativeSampler as JaxSampler
from mfar_tpu.data.schema import resolve_fields as jax_resolve_fields
from mfar_tpu.data.types import Corpus as JaxCorpus
from mfar_tpu.models import SimpleVocabTokenizer as JaxTokenizer
from mfar_tpu.sparse.bm25 import BM25Index as JaxBM25
from mfar_tpu.train.data_pipeline import ContrastiveDataset as JaxDataset
from mfar_tpu.train.sparse_cache import read_sparse_scores as jax_read_sparse_scores
from mfar_tpu_torch.commands import create_sparse_index as create_index_cmd
from mfar_tpu_torch.commands import encode_corpus as encode_cmd
from mfar_tpu_torch.commands import precompute_sparse_scores as precompute_cmd
from mfar_tpu_torch.commands import retrieve as retrieve_cmd
from mfar_tpu_torch.commands import train as train_cmd
from mfar_tpu_torch.data import trec
from mfar_tpu_torch.data.format import format_documents
from mfar_tpu_torch.data.negative_sampler import IndexNegativeSampler
from mfar_tpu_torch.data.schema import resolve_fields
from mfar_tpu_torch.data.types import Corpus
from mfar_tpu_torch.models.encoder import EncoderConfig
from mfar_tpu_torch.models.registry import save_gtr_dir
from mfar_tpu_torch.models.t5_encoder import T5Config, init_t5_encoder
from mfar_tpu_torch.models.tokenizer import SimpleVocabTokenizer
from mfar_tpu_torch.sparse.bm25 import BM25Index
from mfar_tpu_torch.train.checkpoint import CheckpointManager, read_best_dir
from mfar_tpu_torch.train.data_pipeline import ContrastiveDataset
from mfar_tpu_torch.train.model import MFARModel
from mfar_tpu_torch.train.optim import make_optimizer
from mfar_tpu_torch.train.sparse_cache import read_sparse_scores
from mfar_tpu_torch.train.train_step import init_state, train_step
from mfar_tpu_torch.train.trainer import Trainer, TrainerConfig
from synth import make_amazon_corpus, write_dataset_dir

torch.set_num_threads(1)

FIELDS = "title_dense,description_dense"


def _datasets(data_dir, field_info, tok, corpus, sampler):
    def ds(split):
        return ContrastiveDataset(
            trec.read_queries(os.path.join(data_dir, f"{split}.queries")), corpus,
            trec.QRels.from_file(os.path.join(data_dir, f"{split}.qrels")), sampler,
            field_info, tok, query_max_length=64)

    return ds("train"), ds("val")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    data_dir = str(tmp_path_factory.mktemp("data"))
    out_dir = str(tmp_path_factory.mktemp("out"))
    write_dataset_dir(data_dir, make_amazon_corpus(40), n_train=12, n_val=4)
    field_info = resolve_fields(FIELDS, "amazon")
    corpus = Corpus.from_pairs(list(trec.read_corpus(os.path.join(data_dir, "corpus"))), "amazon")
    texts = [t for f in field_info.values()
             for _, t in format_documents(corpus.pairs(), f.name, "amazon")]
    queries = [*trec.read_queries(os.path.join(data_dir, "train.queries")).values(),
               *trec.read_queries(os.path.join(data_dir, "val.queries")).values()]
    tok = SimpleVocabTokenizer.build(texts + queries, max_length=64)
    sampler = IndexNegativeSampler(
        BM25Index.create(format_documents(corpus.pairs(), "single", "amazon")), 10, 5, 1)
    train_ds, val_ds = _datasets(data_dir, field_info, tok, corpus, sampler)
    model = MFARModel(EncoderConfig.tiny(vocab_size=tok.vocab_size, hidden_size=32, num_layers=2,
                                         num_heads=2, hidden_dropout=0.0, attention_dropout=0.0),
                      num_fields=len(field_info), temperature=0.05)
    opt = make_optimizer(encoder_lr=2e-3, weights_lr=1e-1)
    cfg = TrainerConfig(out_dir=out_dir, max_epochs=4, patience=10, trec_val_freq=2,
                        train_batch_size=6, dev_batch_size=8, index_batch_size=16,
                        query_max_length=64, recall_k=20, seed=7)
    trainer = Trainer(
        tokenizer=tok, field_info=field_info, corpus=corpus, train_dataset=train_ds,
        val_dataset=val_ds, dev_queries=trec.read_queries(os.path.join(data_dir, "val.queries")),
        dev_qrels_path=os.path.join(data_dir, "val.qrels"), config=cfg,
        additional_queries=trec.read_queries(os.path.join(data_dir, "test.queries")),
        additional_qrels_path=os.path.join(data_dir, "test.qrels"))
    state = init_state(model, opt, seed=0, device="cpu")
    return dict(trainer=trainer, state=state, opt=opt, cfg=model.encoder_config, out=out_dir,
                data=data_dir, nf=len(field_info))


def test_fit_reduces_loss_and_checkpoints(setup):
    t = setup["trainer"]
    state = t.fit(setup["state"])
    setup["state_after"] = state
    with open(os.path.join(setup["out"], "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    epochs = [r for r in records if r.get("event") == "metrics" and "train_loss" in r]
    assert len(epochs) == 4 and state.step == 4 * 2  # 12 train queries, batch 6
    assert epochs[-1]["train_loss"] < epochs[0]["train_loss"]
    assert any("dev_ndcg_cut_10" in r for r in epochs)
    assert all(0 <= r["padding_pct"] < 100 for r in epochs)
    best_dir = read_best_dir(setup["out"])
    assert os.path.isfile(os.path.join(best_dir, "state.pt"))
    with open(os.path.join(best_dir, "meta.json")) as f:
        meta = json.load(f)
    assert list(meta["field_info"]) == list(resolve_fields(FIELDS, "amazon"))
    assert meta["generator"].startswith("torch.Generator") and meta["config"]["seed"] == 7


def test_resume_restores_state_exactly(setup):
    """A fresh state restored from the latest checkpoint equals the trained
    one -- parameters, optimizer moments, step, generator -- and the next
    step from either gives the same result."""
    t, state = setup["trainer"], setup["state_after"]
    fresh = init_state(MFARModel(setup["cfg"], num_fields=setup["nf"], temperature=0.05),
                       setup["opt"], seed=123, device="cpu")
    restored = t.ckpt.restore(t.ckpt.latest_step(), fresh)
    assert restored.step == state.step
    assert torch.equal(restored.generator.get_state(), state.generator.get_state())
    for (name, a), b in zip(state.model.state_dict().items(),
                            restored.model.state_dict().values()):
        assert torch.equal(a, b), name
    batch = next(t.train_dataset.epoch_batches(6, seed=99))
    batch = {k: v for k, v in batch.items() if k != "meta"}
    _, m_a = train_step(state, batch)
    _, m_b = train_step(restored, batch)
    assert m_a["loss"].item() == m_b["loss"].item()
    for a, b in zip(state.model.parameters(), restored.model.parameters()):
        assert torch.equal(a, b)


def test_test_and_mask_fields(setup):
    t, state = setup["trainer"], setup["state_after"]
    out = t.test(state, verbose=False)
    assert "dev" in out and "additional" in out
    assert 0.0 <= out["dev"]["ndcg_cut_10"] <= 1.0
    masked = list(t.field_info)[1]
    t.mask_field([1])
    assert t.masked_fields_string == masked
    t.test(state, verbose=False)
    t.clear_mask()
    with open(os.path.join(setup["out"], "results_dicts.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert {line["masked_fields"] for line in lines} == {"", masked}


def test_trainer_refuses_a_mesh(setup, tmp_path):
    """``fit`` trains on a mesh (data-parallel training, once refused as
    A15b): on a world of one gloo rank it runs the steps of one device,
    writes the checkpoints and restores the latest through
    ``restore_broadcast``.  It still refuses a batch that does not divide
    the batch shards, with the JAX trainer's message (a mesh with a model
    axis trains since A15d: ``tests/test_torch_train_mesh.py``)."""
    from types import SimpleNamespace

    import torch.distributed as dist

    from mfar_tpu_torch.parallel.mesh import make_mesh

    t = setup["trainer"]

    def trainer(mesh, batch=6):
        cfg = TrainerConfig(out_dir=str(tmp_path), max_epochs=2, train_batch_size=batch,
                            dev_batch_size=8, index_batch_size=16, query_max_length=64,
                            recall_k=20, seed=7)
        return Trainer(t.tokenizer, t.field_info, t.corpus, t.train_dataset, t.val_dataset,
                       t.dev_queries, t.dev_qrels_path, cfg, mesh=mesh)

    def fresh():
        return init_state(MFARModel(setup["cfg"], num_fields=setup["nf"], temperature=0.05),
                          setup["opt"], seed=0, device="cpu")

    with pytest.raises(ValueError, match=r"train_batch_size 5 must divide over the 2 batch "
                                         r"shards of mesh \{'replica': 1, 'data': 2"):
        trainer(SimpleNamespace(shape={"replica": 1, "data": 2, "model": 1},
                                size=lambda axes: 2), batch=5).fit(fresh())
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'init'}", world_size=1,
                            rank=0)
    try:
        mesh_trainer = trainer(make_mesh())
        state = mesh_trainer.fit(fresh())
        assert state.step == 2 * 2  # 12 train queries, batch 6
        latest = mesh_trainer.ckpt_step_broadcast("latest")
        assert latest == 1
        restored = mesh_trainer.restore_broadcast(latest, fresh())
        assert restored.step == state.step
        for a, b in zip(state.model.state_dict().values(), restored.model.state_dict().values()):
            assert torch.equal(a, b)
    finally:
        dist.destroy_process_group()


# ----------------------------------------------------------------------
# the data pipeline's copies against the JAX package's


@pytest.fixture(scope="module")
def pipelines(setup):
    data_dir = setup["data"]
    pairs = list(trec.read_corpus(os.path.join(data_dir, "corpus")))
    field_info = resolve_fields(FIELDS, "amazon")
    out = {}
    for name, corpus_cls, tok_cls, bm25, sampler_cls, ds_cls in (
        ("jax", JaxCorpus, JaxTokenizer, JaxBM25, JaxSampler, JaxDataset),
        ("port", Corpus, SimpleVocabTokenizer, BM25Index, IndexNegativeSampler,
         ContrastiveDataset),
    ):
        corpus = corpus_cls.from_pairs(pairs, "amazon")
        texts = [t for f in field_info.values()
                 for _, t in format_documents(corpus.pairs(), f.name, "amazon")]
        index = bm25.create(format_documents(corpus.pairs(), "single", "amazon"), backend="scipy")
        ds = ds_cls(trec.read_queries(os.path.join(data_dir, "train.queries")), corpus,
                    trec.QRels.from_file(os.path.join(data_dir, "train.qrels")),
                    sampler_cls(index, 10, 5, 2), field_info,
                    tok_cls.build(texts, max_length=64), query_max_length=64)
        out[name] = (index, ds)
    return out


def test_bm25_copy_scores_and_persists_as_jax(pipelines, tmp_path):
    (jidx, _), (pidx, _) = pipelines["jax"], pipelines["port"]
    queries = ["red lamp", "a blue table that folds", "zzz unknown words", "shoe"]
    np.testing.assert_allclose(pidx.get_scores_batch(queries), jidx.get_scores_batch(queries),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(pidx.score_batch(queries, ["d0", "nope", pidx.keys[3]]),
                               jidx.score_batch(queries, ["d0", "nope", jidx.keys[3]]),
                               rtol=1e-6, atol=1e-6)
    for q in queries:
        assert [k for k, _ in pidx.retrieve(q, 5)] == [k for k, _ in jidx.retrieve(q, 5)]
    pidx.save(str(tmp_path / "port"))
    jidx.save(str(tmp_path / "jax"))
    for path in ("port", "jax"):
        loaded = BM25Index.load(str(tmp_path / path))
        np.testing.assert_allclose(loaded.get_scores_batch(queries),
                                   jidx.get_scores_batch(queries), rtol=1e-6, atol=1e-6)
    assert JaxBM25.load(str(tmp_path / "port")).keys == pidx.keys
    # the native backend (once it raised) scores as the JAX package's scipy
    nat = BM25Index.create([(k, " ".join(k)) for k in pidx.keys] + [("x", "red lamp")],
                           backend="native")
    ref = JaxBM25.create([(k, " ".join(k)) for k in pidx.keys] + [("x", "red lamp")],
                         backend="scipy")
    assert nat.native is not None
    np.testing.assert_allclose(nat.get_scores_batch(queries), ref.get_scores_batch(queries),
                               rtol=1e-5, atol=1e-6)


def test_sampler_and_dataset_batches_match_jax(pipelines):
    """The same seed gives the JAX package's negatives and batches, token for
    token (two epochs' first batches)."""
    (_, jds), (_, pds) = pipelines["jax"], pipelines["port"]
    for qtext in ("red lamp", "blue table"):
        pos = {"d1"}
        assert pds.neg_sampler.sample(qtext, pos, np.random.default_rng(3)) == \
            jds.neg_sampler.sample(qtext, pos, np.random.default_rng(3))
    for seed in (7, 8):
        jb = next(jds.epoch_batches(6, seed=seed))
        pb = next(pds.epoch_batches(6, seed=seed))
        assert pb["meta"] == jb["meta"] and set(pb) == set(jb)
        for name in ("input_ids", "attention_mask"):
            np.testing.assert_array_equal(pb["query"][name], jb["query"][name])
            for side in ("pos", "neg"):
                for fk in jb[side]:
                    np.testing.assert_array_equal(pb[side][fk][name], jb[side][fk][name])


HYBRID = "title_dense,title_sparse"


@pytest.fixture(scope="module")
def hybrid_datasets(setup, pipelines, tmp_path_factory):
    """Each package's ``ContrastiveDataset`` over ``title_dense,title_sparse``
    with its own scipy BM25 index of the title field, on the live path (no
    cache) and on the cache path (``precompute_sparse_scores``' files, read
    by each package's own loader)."""
    data_dir = setup["data"]
    root = tmp_path_factory.mktemp("hybrid")
    idx, scores = str(root / "idx"), str(root / "scores")
    create_index_cmd.main(["--data-path", data_dir, "--dataset-name", "amazon",
                           "--output-path", idx, "--fields-str", "single_sparse"])
    precompute_cmd.main(["--data-path", data_dir, "--dataset-name", "amazon",
                         "--corpus-path", data_dir, "--output-path", scores, "--index-path", idx,
                         "--fields-str", "title_sparse", "--n-retrieve", "5"])
    pairs = list(trec.read_corpus(os.path.join(data_dir, "corpus")))
    queries = trec.read_queries(os.path.join(data_dir, "train.queries"))
    qrels = trec.QRels.from_file(os.path.join(data_dir, "train.qrels"))
    out = {}
    for name, corpus_cls, tok_cls, bm25, sampler_cls, ds_cls, fields, read in (
        ("jax", JaxCorpus, JaxTokenizer, JaxBM25, JaxSampler, JaxDataset, jax_resolve_fields,
         jax_read_sparse_scores),
        ("port", Corpus, SimpleVocabTokenizer, BM25Index, IndexNegativeSampler,
         ContrastiveDataset, resolve_fields, read_sparse_scores),
    ):
        field_info = fields(HYBRID, "amazon")
        corpus = corpus_cls.from_pairs(pairs, "amazon")
        title = format_documents(corpus.pairs(), field_info["title_sparse"].name, "amazon")
        sparse = {"title_sparse": bm25.create(title, backend="scipy")}
        tok = tok_cls.build([t for _, t in title], max_length=64)
        for path, cache in (("live", None), ("cache", read(scores, field_info))):
            out[name, path] = ds_cls(
                queries, corpus, qrels, sampler_cls(pipelines[name][0], 10, 5, 2), field_info,
                tok, query_max_length=64, sparse_score_cache=cache, sparse_indices=sparse)
    return out


@pytest.mark.parametrize("path", ["live", "cache"])
def test_hybrid_batches_match_jax(hybrid_datasets, path):
    """Hybrid batches carry the JAX package's BM25 scores: ``sparse_pos``
    [B, B, 1] and ``sparse_neg`` [B, B*Nn, 1] (negatives doc-major) equal
    JAX's on the live path (each index scores the batch) and on the cache
    path (qid lookups into the precomputed scores), tokens and negatives
    too.  The two paths differ (the cache holds only the candidate pool, in
    float16), so each test reads the path it names."""
    for seed in (7, 8):
        jb = next(hybrid_datasets["jax", path].epoch_batches(6, seed=seed))
        pb = next(hybrid_datasets["port", path].epoch_batches(6, seed=seed))
        assert pb["meta"] == jb["meta"] and set(pb) == set(jb)
        assert pb["sparse_pos"].shape == (6, 6, 1) and pb["sparse_neg"].shape == (6, 12, 1)
        assert np.count_nonzero(pb["sparse_pos"]) and np.count_nonzero(pb["sparse_neg"])
        for key in ("sparse_pos", "sparse_neg"):
            np.testing.assert_allclose(pb[key], jb[key], rtol=1e-6, atol=1e-6, err_msg=key)
        np.testing.assert_array_equal(pb["query"]["input_ids"], jb["query"]["input_ids"])
        for side in ("pos", "neg"):
            np.testing.assert_array_equal(pb[side]["title_dense"]["input_ids"],
                                          jb[side]["title_dense"]["input_ids"])
    other = "cache" if path == "live" else "live"
    ob = next(hybrid_datasets["port", other].epoch_batches(6, seed=8))
    assert ob["meta"] == pb["meta"]
    assert not np.array_equal(ob["sparse_neg"], pb["sparse_neg"])


# ----------------------------------------------------------------------
# the train command


def _train_args(data_dir, out, *extra):
    return ["--dataset-name", "amazon", "--data", data_dir, "--out", out,
            "--lexical-index", os.path.join(out, "idx"), "--field-names", FIELDS,
            "--model-name", "synthetic", "--weights-lr", "0.1", "--train-batch-size", "4",
            "--max-epochs", "1", "--run-one-iteration", "--recall-k", "10",
            "--dev-batch-size", "8", *extra]


def _layout(out):
    top = sorted(f for f in os.listdir(out) if f != "idx")
    steps = sorted(os.listdir(os.path.join(out, "checkpoints")))
    return top, steps


def test_train_cli_writes_the_jax_layout_and_serves(setup, tmp_path):
    """``--device cpu --run-one-iteration`` writes what the JAX command
    writes (metrics, checkpoints/<epoch>/ with meta.json, best.txt, the dev
    run, results); ``retrieve`` and ``encode_corpus --checkpoint-dir`` read
    its best checkpoint; ``--resume`` refuses another ``--prng`` and
    otherwise continues with the next epoch."""
    data_dir = setup["data"]
    port_out, jax_out = str(tmp_path / "port"), str(tmp_path / "jax")
    train_cmd.main(_train_args(data_dir, port_out, "--device", "cpu"))
    jax_train_cmd.main(_train_args(data_dir, jax_out, "--mesh", "off"))
    assert _layout(port_out) == _layout(jax_out)
    for out in (port_out, jax_out):
        with open(os.path.join(out, "checkpoints", "0", "meta.json")) as f:
            meta = json.load(f)
        assert {"field_info", "config", "metrics"} <= set(meta)
    assert os.path.isfile(os.path.join(port_out, "checkpoints", "0", "state.pt"))

    run = str(tmp_path / "run.qres")
    retrieve_cmd.main(["--dataset-name", "amazon", "--data", data_dir, "--out", run,
                       "--field-names", FIELDS, "--model-name", "synthetic",
                       "--partition", "val", "--recall-k", "10", "--top-k", "5",
                       "--device", "cpu", "--checkpoint-dir", port_out])
    assert len(trec.QRes.from_file(run)) == 4 * 5
    index = str(tmp_path / "index.npz")
    encode_cmd.main(["--dataset-name", "amazon", "--data", data_dir, "--out", index,
                     "--field-names", FIELDS, "--model-name", "synthetic", "--device", "cpu",
                     "--checkpoint-dir", port_out])
    assert np.load(index, allow_pickle=True)["matrix"].shape == (40, 2, 64)

    with pytest.raises(SystemExit, match="prng"):
        train_cmd.main(_train_args(data_dir, port_out, "--device", "cpu", "--resume",
                                   "--prng", "threefry"))
    # --resume continues after the latest checkpoint: epoch 1 of 2
    train_cmd.main([*_train_args(data_dir, port_out, "--device", "cpu", "--resume"), "--max-epochs",
                    "2"])
    assert sorted(os.listdir(os.path.join(port_out, "checkpoints"))) == ["0", "1"]
    with open(os.path.join(port_out, "checkpoints", "1", "meta.json")) as f:
        assert json.load(f)["config"]["max_epochs"] == 2


@pytest.mark.parametrize("extra,error,match", [
    # tensor parallelism trains since A15d: on one process --n-model 2
    # exits as the JAX command does on one device
    (["--n-model", "2"], SystemExit, r"--n-model 2 x --n-replica 1 needs at least that many "
                                     r"devices \(have 1\)"),
    # several processes train now (once A15b): without its environment,
    # --multihost force exits as the other commands do
    (["--multihost", "force"], SystemExit, "MFAR_COORDINATOR"),
], ids=["extra0-A15", "extra1-A15"])
def test_train_cli_refuses_what_is_not_ported(setup, tmp_path, extra, error, match):
    with pytest.raises(error, match=match):
        train_cmd.main(_train_args(setup["data"], str(tmp_path / "o"), "--device", "cpu", *extra))
    assert not os.path.exists(tmp_path / "o")  # refused before any work


@pytest.mark.parametrize("n_replica,batch", [(3, 16), (2, 6)])
def test_train_mesh_shape_exits_as_jax(setup, tmp_path, n_replica, batch):
    """Mesh shapes that cannot divide exit with the JAX command's message
    (the JAX command on the suite's 8 virtual devices, the port on 8
    ranks)."""
    from mfar_tpu_torch.commands.train import train_mesh_shape

    with pytest.raises(SystemExit) as port:
        train_mesh_shape(8, n_replica, batch)
    with pytest.raises(SystemExit) as want:
        jax_train_cmd.main(_train_args(setup["data"], str(tmp_path / "jax"), "--n-replica",
                                       str(n_replica), "--train-batch-size", str(batch)))
    assert str(port.value) == str(want.value)


# (devices, n_model, n_replica, batch)
N_MODEL_GRID = [(8, 2, 1, 4), (8, 2, 1, 6), (8, 4, 1, 16), (8, 8, 1, 4), (4, 2, 1, 4),
                (6, 4, 1, 4), (2, 2, 1, 4), (8, 2, 2, 4), (1, 2, 1, 4), (8, 3, 2, 4),
                (8, 2, 2, 6)]


@pytest.mark.parametrize("devices,n_model,n_replica,batch", N_MODEL_GRID)
def test_train_mesh_shape_with_n_model_matches_jax(setup, tmp_path, monkeypatch, capsys,
                                                   devices, n_model, n_replica, batch):
    """The mesh the JAX command sizes over ``devices`` of the virtual
    devices (its printed mesh line; the command stopped right after it) or
    the message it exits with, against ``train_mesh_shape`` over as many
    ranks."""
    import jax

    from mfar_tpu_torch.commands.train import train_mesh_shape

    class Sized(Exception):
        pass

    every = jax.devices()
    monkeypatch.setattr(jax, "devices", lambda *a: every[:devices])
    monkeypatch.setattr(jax_train_cmd, "TrainerConfig", lambda **kw: (_ for _ in ()).throw(Sized))
    args = _train_args(setup["data"], str(tmp_path / "jax"), "--n-model", str(n_model),
                       "--n-replica", str(n_replica), "--train-batch-size", str(batch))
    try:
        jax_train_cmd.main(args)
    except SystemExit as want:
        with pytest.raises(SystemExit) as port:
            train_mesh_shape(devices, n_replica, batch, n_model)
        assert str(port.value) == str(want)
        return
    except Sized:
        pass
    line = next(ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[train] mesh"))
    n_data, used = train_mesh_shape(devices, n_replica, batch, n_model)
    assert line.startswith(f"[train] mesh: {{'replica': {n_replica}, 'data': {n_data}, "
                           f"'model': {n_model}}} over {used}/{devices} devices"), line


def test_train_mesh_shape_shrinks_the_data_axis():
    """On one slice the data axis shrinks until the batch divides (JAX's
    rule): 8 ranks and a batch of 6 train on 6, of 12 on 6, of 16 on 8."""
    from mfar_tpu_torch.commands.train import train_mesh_shape

    assert train_mesh_shape(8, 1, 6) == (6, 6)
    assert train_mesh_shape(8, 1, 12) == (6, 6)
    assert train_mesh_shape(8, 1, 16) == (8, 8)
    assert train_mesh_shape(8, 2, 16) == (4, 8)
    assert train_mesh_shape(3, 1, 4) == (2, 2)


def test_train_cli_trains_sparse_fields(setup, tmp_path, capsys):
    """Sparse fields (once they raised) train with the precomputed scores
    of ``--sparse-scores-path``, and the run serves hybrid retrieval; the
    output layout is the JAX command's on the same flags."""
    data_dir = setup["data"]
    idx, scores = str(tmp_path / "idx"), str(tmp_path / "scores")
    create_index_cmd.main(["--data-path", data_dir, "--dataset-name", "amazon",
                           "--output-path", idx, "--fields-str", "title_sparse,single_sparse"])
    precompute_cmd.main(["--data-path", data_dir, "--dataset-name", "amazon",
                         "--corpus-path", data_dir, "--output-path", scores, "--index-path", idx,
                         "--fields-str", "title_sparse", "--n-retrieve", "10"])
    fields = "title_dense,title_sparse"
    port_out, jax_out = str(tmp_path / "port"), str(tmp_path / "jax")
    common = ["--field-names", fields, "--lexical-index", idx, "--sparse-scores-path", scores]
    train_cmd.main([*_train_args(data_dir, port_out, "--device", "cpu"), *common])
    assert "Read sparse scores" in capsys.readouterr().out
    jax_train_cmd.main([*_train_args(data_dir, jax_out, "--mesh", "off"), *common])
    assert _layout(port_out) == _layout(jax_out)
    with open(os.path.join(port_out, "results_dicts.jsonl")) as f:
        assert len(f.readlines()) == 1
    run = str(tmp_path / "run.qres")
    retrieve_cmd.main(["--dataset-name", "amazon", "--data", data_dir, "--out", run,
                       "--field-names", fields, "--model-name", "synthetic", "--partition",
                       "val", "--top-k", "5", "--lexical-index", idx, "--device", "cpu",
                       "--checkpoint-dir", port_out])
    assert "singlechip-hybrid" in capsys.readouterr().out
    assert len(trec.QRes.from_file(run)) == 4 * 5


def _gtr_dir(setup, path):
    """A tiny sentence-transformers GTR directory over the corpus's words."""
    texts = [t for _, p in trec.read_corpus(os.path.join(setup["data"], "corpus"))
             for t in json.dumps(p).lower().split()]
    words = sorted({w.strip('",.:{}[]') for w in texts} - {""})
    cfg = T5Config.tiny(vocab_size=len(words) + 64, projection_dim=24)
    save_gtr_dir(path, cfg, init_t5_encoder(cfg, seed=3).state_dict(), words)
    return cfg


def test_t5_train_cli_then_retrieve(setup, tmp_path):
    """``train --run-one-iteration`` on a GTR directory trains the encoder
    with Adafactor (its state in the checkpoint beside the head's AdamW),
    ``--resume`` restores it, and ``retrieve --checkpoint-dir`` serves the
    trained encoder and mixer."""
    gtr, out = str(tmp_path / "gtr"), str(tmp_path / "out")
    _gtr_dir(setup, gtr)
    args = [*_train_args(setup["data"], out, "--device", "cpu", "--precision", "32",
                         "--hidden-dropout", "0.0", "--attention-dropout", "0.0",
                         "--softmax-dtype", "bf16")]
    args[args.index("synthetic")] = gtr
    train_cmd.main(args)
    payload = torch.load(os.path.join(out, "checkpoints", "0", "state.pt"), weights_only=True)
    assert set(payload["optimizer"]) == {"encoder", "head"}
    leaves = payload["optimizer"]["encoder"]["state"]
    assert leaves and all(s["step"] == 1 for s in leaves.values())
    assert payload["model"]["mixer.weight"].shape == (24, 2)
    train_cmd.main([*args, "--resume", "--max-epochs", "2"])
    assert sorted(os.listdir(os.path.join(out, "checkpoints"))) == ["0", "1"]

    run = str(tmp_path / "run.qres")
    retrieve_cmd.main(["--dataset-name", "amazon", "--data", setup["data"], "--out", run,
                       "--field-names", FIELDS, "--model-name", gtr, "--partition", "val",
                       "--recall-k", "10", "--top-k", "5", "--device", "cpu",
                       "--checkpoint-dir", out, "--mode", "rerank"])
    assert len(trec.QRes.from_file(run)) == 4 * 5


def test_t5_adafactor_checkpoint_round_trip(setup, tmp_path):
    """A T5 MFARModel with Adafactor: two steps, a checkpoint, a fresh state
    restored from it; the next step from either is equal (within 1e-6)."""
    t = setup["trainer"]
    cfg = T5Config.tiny(vocab_size=t.tokenizer.vocab_size, projection_dim=24, dropout=0.1)
    opt = make_optimizer(encoder_lr=1e-3, weights_lr=1e-1, use_adafactor=True)

    def fresh(seed):
        return init_state(MFARModel(cfg, num_fields=setup["nf"], temperature=0.05), opt,
                          seed=seed, device="cpu")

    state = fresh(0)
    batches = [{k: v for k, v in b.items() if k != "meta"}
               for b in t.train_dataset.epoch_batches(6, seed=5)]
    for b in batches[:2]:
        state, _ = train_step(state, b)
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(0, state, {"valid_loss": 1.0})
    restored = ckpt.restore(0, fresh(9))
    assert restored.step == state.step == 2
    _, m_a = train_step(state, batches[0])
    _, m_b = train_step(restored, batches[0])
    assert abs(m_a["loss"].item() - m_b["loss"].item()) <= 1e-6
    for a, b in zip(state.model.parameters(), restored.model.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
