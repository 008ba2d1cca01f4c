"""The port's offline tools and commands against the JAX package's, on the
CPU: ``make_synth_data`` and ``create_sparse_index`` byte for byte,
``precompute_sparse_scores``' files, ``mask_fields``' per-mask metrics on
the same weights, a safetensors BERT directory (C1) and the JAX
``retrieve`` command's flag set (C2)."""

import argparse
import filecmp
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mfar_tpu.commands import create_sparse_index as jax_csi
from mfar_tpu.commands import make_synth_data as jax_msd
from mfar_tpu.commands import precompute_sparse_scores as jax_pss
from mfar_tpu.commands import retrieve as jax_retrieve
from mfar_tpu.commands.common import corpus_texts_for_vocab as jax_vocab_texts
from mfar_tpu.commands.common import load_corpus as jax_load_corpus
from mfar_tpu.data import trec as jax_trec
from mfar_tpu.data.negative_sampler import IndexNegativeSampler as JaxSampler
from mfar_tpu.data.schema import resolve_fields as jax_resolve_fields
from mfar_tpu.eval.index_build import build_sparse_indices as jax_sparse_indices
from mfar_tpu.models import build_encoder as jax_build_encoder
from mfar_tpu.models.registry import prepare_model as jax_prepare_model
from mfar_tpu.sparse.bm25 import BM25Index as JaxBM25
from mfar_tpu.train.data_pipeline import ContrastiveDataset as JaxDataset
from mfar_tpu.train.model import MFARModel as JaxModel
from mfar_tpu.train.optim import make_optimizer as jax_make_optimizer
from mfar_tpu.train.train_step import init_state as jax_init_state
from mfar_tpu.train.trainer import Trainer as JaxTrainer
from mfar_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from mfar_tpu.utils.logging import MetricsLogger as JaxLogger
from mfar_tpu_torch.commands import create_sparse_index as port_csi
from mfar_tpu_torch.commands import make_synth_data as port_msd
from mfar_tpu_torch.commands import mask_fields as port_mask_fields
from mfar_tpu_torch.commands import precompute_sparse_scores as port_pss
from mfar_tpu_torch.commands import retrieve as port_retrieve
from mfar_tpu_torch.commands.common import requested_mesh
from mfar_tpu_torch.data import trec
from mfar_tpu_torch.data.schema import resolve_fields
from mfar_tpu_torch.eval.compare import rankings_agree
from mfar_tpu_torch.eval.index_build import make_encode_fn
from mfar_tpu_torch.models.convert import model_state_from_jax
from mfar_tpu_torch.models.encoder import Encoder
from mfar_tpu_torch.models.registry import prepare_model
from mfar_tpu_torch.train.checkpoint import CheckpointManager
from mfar_tpu_torch.train.model import MFARModel
from mfar_tpu_torch.train.optim import make_optimizer
from mfar_tpu_torch.train.train_step import init_state
from mfar_tpu_torch.utils.jsonutil import remove_irregularities
from mfar_tpu.utils.jsonutil import remove_irregularities as jax_remove_irregularities

torch.set_num_threads(1)

FIELDS = "title_dense,description_dense,title_sparse,description_sparse"


def _same_tree(a, b):
    """Every file under ``a`` has a byte-equal twin under ``b``, and back."""
    files_a = sorted(os.path.relpath(os.path.join(r, f), a)
                     for r, _, fs in os.walk(a) for f in fs)
    files_b = sorted(os.path.relpath(os.path.join(r, f), b)
                     for r, _, fs in os.walk(b) for f in fs)
    assert files_a == files_b and files_a
    for rel in files_a:
        assert filecmp.cmp(os.path.join(a, rel), os.path.join(b, rel), shallow=False), rel


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """One dataset directory per package, from each make_synth_data."""
    root = tmp_path_factory.mktemp("tools")
    dirs = {}
    for name, cmd in (("jax", jax_msd), ("port", port_msd)):
        d = str(root / f"data_{name}")
        cmd.main(["--out", d, "--dataset-name", "amazon", "--n-docs", "60", "--n-train", "12",
                  "--n-val", "6", "--seed", "3"])
        dirs[name] = d
    return root, dirs


@pytest.mark.parametrize("dataset", ["mag", "prime", "whatsthatbook"])
def test_make_synth_data_matches_jax_byte_for_byte(tmp_path, dataset):
    for name, cmd in (("jax", jax_msd), ("port", port_msd)):
        cmd.main(["--out", str(tmp_path / name), "--dataset-name", dataset, "--n-docs", "40",
                  "--n-train", "8", "--n-val", "4", "--seed", "5"])
    _same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))


def test_make_synth_data_amazon_and_jsonutil(data):
    _, dirs = data
    _same_tree(dirs["jax"], dirs["port"])
    raw = {"a": ["x\ty\n", {"b": " z\u001f"}], "n": np.bool_(True), "k": 3}
    assert remove_irregularities(raw) == jax_remove_irregularities(raw)
    with pytest.raises(ValueError):
        remove_irregularities({"bad": object()})


def test_create_sparse_index_matches_jax_byte_for_byte(data):
    root, dirs = data
    for name, cmd in (("jax", jax_csi), ("port", port_csi)):
        cmd.main(["--data-path", dirs["jax"], "--dataset-name", "amazon",
                  "--output-path", str(root / f"idx_{name}")])
    _same_tree(str(root / "idx_jax"), str(root / "idx_port"))
    assert os.path.exists(str(root / "idx_port" / "title_sparse_sparse_index" / "native.bin"))


def test_precompute_sparse_scores_matches_jax(data):
    root, dirs = data
    idx = str(root / "idx_pss")
    port_csi.main(["--data-path", dirs["jax"], "--dataset-name", "amazon", "--output-path", idx])
    for name, cmd in (("jax", jax_pss), ("port", port_pss)):
        cmd.main(["--data-path", dirs["jax"], "--dataset-name", "amazon",
                  "--corpus-path", dirs["jax"], "--output-path", str(root / f"sc_{name}"),
                  "--index-path", idx, "--n-retrieve", "20"])
    names = sorted(os.listdir(root / "sc_jax"))
    assert names == sorted(os.listdir(root / "sc_port")) and len(names) == 2 * 9
    for f in names:
        np.testing.assert_array_equal(np.load(root / "sc_port" / f), np.load(root / "sc_jax" / f))


def test_mask_fields_metrics_match_jax(data, tmp_path):
    """The JAX trainer's sweep (``mask_field`` + ``test``) against the
    port's ``mask_fields`` command over a port checkpoint holding the same
    weights: the same configurations, each with the same metrics."""
    _, dirs = data
    d = dirs["jax"]
    jfi = jax_resolve_fields(FIELDS, "amazon")
    corpus = jax_load_corpus(d, "amazon")
    jcfg, jparams, jtok = jax_prepare_model("synthetic", corpus_texts=jax_vocab_texts(corpus, jfi))
    model = JaxModel(encoder_config=jcfg, num_fields=len(jfi))
    opt = jax_make_optimizer(encoder_lr=1e-4, weights_lr=1e-1)
    state = jax_init_state(model, opt, seed=0)
    mixer = np.random.default_rng(4).normal(scale=0.5, size=(jcfg.hidden_size, len(jfi)))
    state = state._replace(params={**state.params, "encoder": jparams,
                                   "mixer": {"weight": jnp.asarray(mixer, jnp.float32)}})
    val = jax_trec.read_queries(os.path.join(d, "val.queries"))
    qrels = os.path.join(d, "val.qrels")
    sampler = JaxSampler(JaxBM25.create([(k, k) for k in corpus.keys()], backend="scipy"))
    ds = JaxDataset(val, corpus, jax_trec.QRels.from_file(qrels), sampler, jfi, jtok)
    jax_out = str(tmp_path / "jax")
    trainer = JaxTrainer(
        model=model, optimizer=opt, tokenizer=jtok, field_info=jfi, corpus=corpus,
        train_dataset=ds, val_dataset=ds, dev_queries=val, dev_qrels_path=qrels,
        config=JaxTrainerConfig(out_dir=jax_out, recall_k=20, query_max_length=64),
        sparse_indices=jax_sparse_indices(corpus, jfi), logger=JaxLogger(jax_out))
    fields = list(jfi.values())
    sweep = [None, *[[i] for i in range(len(fields))],
             [i for i, f in enumerate(fields) if f.is_sparse],
             [i for i, f in enumerate(fields) if f.is_dense],
             *[[i for i, f in enumerate(fields) if f.name == n]
               for n in sorted({f.name for f in fields})]]
    for masked in sweep:
        if masked is not None:
            trainer.mask_field(masked)
        trainer.test(state, verbose=False)

    # the same weights in a port checkpoint, then the port's command
    pfi = resolve_fields(FIELDS, "amazon")
    pcfg, _, _ = prepare_model("synthetic", corpus_texts=jax_vocab_texts(corpus, jfi))
    pstate = init_state(MFARModel(encoder_config=pcfg, num_fields=len(pfi)),
                        make_optimizer(encoder_lr=1e-4, weights_lr=1e-1), device="cpu")
    pstate.model.load_state_dict(model_state_from_jax(
        jax.tree.map(np.asarray, state.params)))
    run = str(tmp_path / "run")
    ckpt = CheckpointManager(run)
    ckpt.save(0, pstate, {"valid_loss": 1.0}, field_info=pfi, config={})
    ckpt.write_best_txt()
    port_out = str(tmp_path / "port")
    port_mask_fields.main(["--dataset-name", "amazon", "--data", d, "--field-names", FIELDS,
                           "--lexical-index", str(tmp_path / "no_idx"), "--out", port_out,
                           "--checkpoint-dir", run, "--model-name", "synthetic",
                           "--recall-k", "20", "--dev-max-length", "64", "--device", "cpu"])

    def records(out):
        with open(os.path.join(out, "results_dicts.jsonl")) as f:
            return [json.loads(line) for line in f]

    got, want = records(port_out), records(jax_out)
    assert [r["masked_fields"] for r in got] == [r["masked_fields"] for r in want]
    assert len(got) == len(sweep) == 9
    for g, w in zip(got, want):
        for k in w:
            if k not in ("masked_fields", "additional"):
                assert abs(float(g[k]) - float(w[k])) <= 1e-3, (g["masked_fields"], k, g, w)


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    """A 2-layer BertModel saved by ``save_pretrained`` (safetensors only)
    with a WordPiece tokenizer.json."""
    from tokenizers import Tokenizer
    from tokenizers.models import WordPiece
    from tokenizers.pre_tokenizers import Whitespace
    from transformers import BertConfig, BertModel

    d = str(tmp_path_factory.mktemp("hf_st"))
    cfg = BertConfig(vocab_size=64, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                     intermediate_size=64, max_position_embeddings=64, type_vocab_size=2)
    torch.manual_seed(0)
    BertModel(cfg).eval().save_pretrained(d)
    vocab = {"[PAD]": 0, "[UNK]": 1}
    for w in ["the", "red", "lamp", "glows", "blue", "book", "folds", "a"]:
        vocab[w] = len(vocab)
    tok = Tokenizer(WordPiece(vocab=vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = Whitespace()
    tok.save(os.path.join(d, "tokenizer.json"))
    return d


def test_safetensors_bert_dir_loads_as_in_jax(hf_dir):
    """C1: a directory holding only ``model.safetensors`` loads, to the JAX
    package's embeddings."""
    assert "model.safetensors" in os.listdir(hf_dir)
    assert "pytorch_model.bin" not in os.listdir(hf_dir)
    texts = ["the red lamp glows", "a blue book folds"]
    jcfg, jparams, jtok = jax_prepare_model(hf_dir, dtype=jnp.float32)
    toks = jtok.encode_batch(texts, 16)
    want = np.asarray(jax_build_encoder(jcfg).apply(
        {"params": jparams}, jnp.asarray(toks["input_ids"]), jnp.asarray(toks["attention_mask"])))
    cfg, state, tok = prepare_model(hf_dir, dtype=torch.float32)
    assert cfg.num_layers == 2 and tok.vocab_size == jtok.vocab_size
    enc = Encoder(cfg)
    enc.load_state_dict(state)
    ptoks = tok.encode_batch(texts, 16)
    np.testing.assert_array_equal(ptoks["input_ids"], toks["input_ids"])
    got = make_encode_fn(enc, device="cpu")(ptoks["input_ids"], ptoks["attention_mask"])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


class _Parsed(Exception):
    pass


def _parser_of(main, monkeypatch):
    """The ArgumentParser a command's ``main`` builds (captured at
    ``parse_args``, before any work)."""
    seen = {}

    def capture(self, args=None, namespace=None):
        seen["parser"] = self
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Parsed):
        main([])
    monkeypatch.undo()
    return seen["parser"]


def _value_for(action):
    if action.choices:
        return str(next(c for c in action.choices if c is not None))
    if action.type is int:
        return "3"
    return "x"


def test_retrieve_accepts_the_jax_flag_set(monkeypatch):
    """C2: every option of the JAX ``retrieve`` parses in the port's, to the
    same destination and value."""
    jp = _parser_of(jax_retrieve.main, monkeypatch)
    pp = _parser_of(port_retrieve.main, monkeypatch)
    argv = []
    for action in jp._actions:
        if not action.option_strings or action.dest == "help":
            continue
        flag = action.option_strings[-1]
        if action.nargs == 0:
            argv.append(flag)
        else:
            argv += [flag, _value_for(action)]
    want = vars(jp.parse_args(argv))
    got = vars(pp.parse_args(argv))
    assert {k: got[k] for k in want} == want
    assert {"lexical_index", "quantize", "pallas_cross_row", "corpus_on_host", "mesh",
            "n_model", "n_replica", "corpus_per_slice", "multihost"} <= set(got)


@pytest.mark.parametrize("extra,err,item", [
    (["--multihost", "force"], SystemExit, "MFAR_COORDINATOR"),
    (["--multihost", "pod"], SystemExit, "torchrun"),
])
def test_retrieve_refuses_unported_engine_flags(data, tmp_path, monkeypatch, extra, err, item):
    """The multi-process modes without their launcher's environment (the
    mesh itself runs in tests/test_torch_multihost.py)."""
    _, dirs = data
    for var in ("MFAR_COORDINATOR", "MFAR_NUM_PROCESSES", "MFAR_PROCESS_ID", "RANK",
                "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(err, match=item):
        port_retrieve.main(["--dataset-name", "amazon", "--data", dirs["port"],
                            "--out", str(tmp_path / "r.qres"), "--model-name", "synthetic",
                            "--device", "cpu", *extra])


@pytest.mark.parametrize("n_model", [1, 2])
def test_mesh_auto_with_several_cards(monkeypatch, capsys, n_model):
    """``--mesh auto`` in one process that sees two cards serves on one and
    says how to start one rank per card; ``--n-model 2`` shapes a mesh only
    over several ranks (as JAX's one-device ``mesh_from_flag``)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    args = argparse.Namespace(mesh="auto", device="cuda", n_model=n_model, n_replica=1)
    mesh = requested_mesh(args, "retrieve")
    assert mesh is None
    printed = capsys.readouterr().out
    assert "2 visible cards, running on one" in printed and "--multihost pod" in printed


def test_hybrid_retrieve_from_the_ports_own_inputs(data, tmp_path):
    """The port's chain with no JAX tool in it: make_synth_data ->
    create_sparse_index -> retrieve --lexical-index (hybrid, --mesh off
    --multihost off) in both modes; and a sparse-only run (BM25 mixed by
    the default uniform weights) ranks as the JAX command's."""
    root, dirs = data
    d = dirs["port"]
    idx = str(root / "idx_retrieve")
    port_csi.main(["--data-path", d, "--dataset-name", "amazon", "--output-path", idx])
    for mode in ("exact", "rerank"):
        out = str(tmp_path / f"{mode}.qres")
        port_retrieve.main(["--dataset-name", "amazon", "--data", d, "--out", out,
                            "--field-names", FIELDS, "--model-name", "synthetic",
                            "--lexical-index", idx, "--mode", mode, "--mesh", "off",
                            "--multihost", "off", "--recall-k", "20", "--top-k", "5",
                            "--device", "cpu"])
        qres = trec.QRes.from_file(out)
        assert len(qres) == 6 * 5
    # sparse-only: each package's engine gives the same BM25-mixed run
    runs = {}
    for name, cmd in (("jax", jax_retrieve), ("port", port_retrieve)):
        out = str(tmp_path / f"sparse_{name}.qres")
        argv = ["--dataset-name", "amazon", "--data", d, "--out", out,
                "--field-names", "title_sparse,description_sparse", "--model-name", "synthetic",
                "--lexical-index", idx, "--top-k", "5", "--mesh", "off"]
        cmd.main(argv + (["--device", "cpu"] if name == "port" else []))
        by_query = {}
        for r in trec.QRes.from_file(out):
            by_query.setdefault(r.query_id, []).append((r.doc_id, r.sim))
        runs[name] = [by_query[q] for q in sorted(by_query)]
    msg = rankings_agree(runs["port"], runs["jax"], 1e-4, 1e-3)
    assert msg is None, msg
