"""The port's ``retrieve`` and ``encode_corpus`` commands end to end on the
CPU: a synthetic dataset directory in the reference's on-disk layout -> a
TREC run file + metrics, and a dense index file that the JAX package
reads."""

import json
import os

import numpy as np
import pytest
import torch

from mfar_tpu.eval import index_build as jax_index
from mfar_tpu.eval import metrics as jax_metrics
from mfar_tpu_torch.commands import encode_corpus as encode_cmd
from mfar_tpu_torch.commands import retrieve as retrieve_cmd
from mfar_tpu_torch.commands.common import corpus_texts_for_vocab, load_corpus
from mfar_tpu_torch.data import trec
from mfar_tpu_torch.data.schema import resolve_fields
from mfar_tpu_torch.eval import index_build as port_index
from mfar_tpu_torch.eval import metrics as port_metrics
from mfar_tpu_torch.eval.compare import rankings_agree
from mfar_tpu_torch.models import build_encoder
from mfar_tpu_torch.models.encoder import EncoderConfig, init_encoder
from mfar_tpu_torch.models.registry import prepare_model, save_bert_dir
from synth import make_amazon_corpus, write_dataset_dir

torch.set_num_threads(1)

TOP_K = 5
N_VAL = 4


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_cli") / "ds")
    write_dataset_dir(d, make_amazon_corpus(30), n_train=4, n_val=N_VAL)
    return d


def _args(data_dir, out, *extra):
    return [
        "--dataset-name", "amazon", "--data", data_dir, "--out", out,
        "--field-names", "title_dense,description_dense", "--model-name", "synthetic",
        "--partition", "val", "--recall-k", "10", "--top-k", str(TOP_K),
        "--batch-size", "3", *extra,
    ]


@pytest.mark.parametrize("gather,path", [("on", "singlechip-rerank-k1"),
                                         ("off", "singlechip-rerank-plain")])
def test_retrieve_cli_rerank_writes_trec_run(data_dir, tmp_path, capsys, gather, path):
    out = str(tmp_path / "run.qres")
    retrieve_cmd.main(_args(data_dir, out, "--device", "cpu", "--mode", "rerank",
                            "--use-pallas-gather", gather))
    printed = capsys.readouterr().out.strip().splitlines()
    assert f"[{path}]" in printed[0] and "on cpu" in printed[0]

    queries = trec.read_queries(os.path.join(data_dir, "val.queries"))
    with open(out) as f:
        lines = [ln.rstrip("\n").split("\t") for ln in f]
    assert all(len(cols) == 6 for cols in lines)  # qid iteration doc rank score run
    by_query = {}
    for qid, iteration, doc, rank, score, _ in lines:
        assert iteration == "0"
        by_query.setdefault(qid, []).append((int(rank), float(score), doc))
    assert list(by_query) == list(queries)
    for hits in by_query.values():
        assert [r for r, _, _ in hits] == list(range(TOP_K))
        scores = [s for _, s, _ in hits]
        assert scores == sorted(scores, reverse=True)
        assert len({d for _, _, d in hits}) == TOP_K

    # metrics line, and the port's metrics copy agrees with the JAX package's
    metrics = json.loads(printed[-1])
    assert set(metrics) >= {"success_1", "recall_10", "ndcg_cut_10", "recip_rank", "map"}
    qrels = os.path.join(data_dir, "val.qrels")
    assert port_metrics.evaluate_files(qrels, out) == pytest.approx(
        jax_metrics.evaluate_files(qrels, out)
    )


def _read_run(path):
    runs = {}
    for r in trec.QRes.from_file(path):
        runs.setdefault(r.query_id, []).append((r.doc_id, r.sim))
    return runs


def test_retrieve_cli_auto_is_exact_and_full_recall_rerank_matches(data_dir, tmp_path, capsys):
    """``--mode auto`` serves exact.  With a recall that covers the whole
    30-doc corpus, rerank scores every document too, so both runs agree
    (f32 corpus; the two modes sum in different orders: rtol 1e-5, ties
    allowed)."""
    runs = {}
    for mode in ("auto", "rerank"):
        out = str(tmp_path / f"{mode}.qres")
        retrieve_cmd.main(_args(data_dir, out, "--device", "cpu", "--mode", mode,
                                "--recall-k", "30", "--dense-dtype", "f32"))
        assert ("[singlechip-dense]" if mode == "auto" else "[singlechip-rerank-k1]") \
            in capsys.readouterr().out
        runs[mode] = _read_run(out)
    assert list(runs["auto"]) == list(runs["rerank"])
    msg = rankings_agree(list(runs["rerank"].values()), list(runs["auto"].values()), 1e-5, 1e-5)
    assert msg is None, msg


def test_retrieve_cli_defaults_to_the_card(data_dir, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        retrieve_cmd.main(_args(data_dir, str(tmp_path / "x.qres")))


def test_retrieve_cli_checkpoint_not_ported(data_dir, tmp_path):
    with pytest.raises(NotImplementedError, match="A10"):
        retrieve_cmd.main(_args(data_dir, str(tmp_path / "x.qres"), "--device", "cpu",
                                "--checkpoint-dir", str(tmp_path)))


FIELDS = "title_dense,description_dense"


def _encode_args(data_dir, out, *extra):
    return ["--dataset-name", "amazon", "--data", data_dir, "--out", out,
            "--field-names", FIELDS, "--model-name", "synthetic", "--batch-size", "8", *extra]


@pytest.mark.parametrize("ext", [".npz", ".npy"])
def test_encode_corpus_cli_writes_what_jax_reads(data_dir, tmp_path, capsys, ext):
    """The CLI's file (.npz, or .npy streamed through a memmap plus a .keys
    sidecar) loads with the JAX package's reader and holds what the port's
    own index build gives for the same synthetic model."""
    out = str(tmp_path / f"index{ext}")
    encode_cmd.main(_encode_args(data_dir, out, "--device", "cpu"))
    assert "30 docs x 2 fields x 64 dims on cpu" in capsys.readouterr().out
    matrix, keys = jax_index.load_dense_matrix(out)

    corpus = load_corpus(data_dir, "amazon")
    fi = resolve_fields(FIELDS, "amazon")
    config, state, tok = prepare_model(
        "synthetic", corpus_texts=corpus_texts_for_vocab(corpus, fi))
    encoder = build_encoder(config)
    encoder.load_state_dict(state)
    want = port_index.build_dense_corpus_matrix(
        port_index.make_encode_fn(encoder, device="cpu"), tok, corpus, fi, batch_size=8)
    assert list(keys) == list(corpus.keys())
    assert matrix.shape == (30, 2, 64) and matrix.dtype == np.float32
    np.testing.assert_allclose(np.asarray(matrix), want, rtol=0, atol=1e-6)


def test_encode_corpus_cli_matches_the_jax_cli_on_a_bert_dir(data_dir, tmp_path):
    """Both packages' encode_corpus commands on one local BERT directory
    (seeded weights written by ``save_bert_dir``), with ``--prefix`` and
    ``--normalize``: the same file, up to bf16.  Tolerance atol 5e-3 on
    unit-norm rows of 64 entries (entries up to ~0.4): both encoders run
    bf16 activations (one ulp is 2**-8 relative) through two layers and
    round in different places.  The same command without ``--prefix``
    lands more than ten times the tolerance away."""
    jax_encode_cmd = pytest.importorskip("mfar_tpu.commands.encode_corpus")
    corpus = load_corpus(data_dir, "amazon")
    fi = resolve_fields(FIELDS, "amazon")
    words = sorted({w for t in corpus_texts_for_vocab(corpus, fi) for w in t.lower().split()})
    cfg = EncoderConfig(vocab_size=len(words) + 8, hidden_size=64, num_layers=2, num_heads=2,
                        intermediate_size=128)
    bert = str(tmp_path / "bert")
    save_bert_dir(bert, cfg, init_encoder(cfg, seed=4).state_dict(), words)

    def run(main, name, *extra):
        out = str(tmp_path / f"{name}.npz")
        main(["--dataset-name", "amazon", "--data", data_dir, "--out", out, "--field-names",
              FIELDS, "--model-name", bert, "--batch-size", "8", "--mesh", "off", *extra])
        matrix, keys = jax_index.load_dense_matrix(out)
        assert list(keys) == list(corpus.keys()) and matrix.shape == (30, 2, 64)
        return np.asarray(matrix)

    want = run(jax_encode_cmd.main, "jax", "--prefix", "--normalize")
    got = run(encode_cmd.main, "port", "--prefix", "--normalize", "--device", "cpu")
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-3)
    no_prefix = run(encode_cmd.main, "port_no_prefix", "--normalize", "--device", "cpu")
    assert np.abs(no_prefix - want).max() > 10 * 5e-3


@pytest.mark.parametrize("extra,cards,err,match", [
    (["--device", "cpu", "--checkpoint-dir", "ckpt"], 0, NotImplementedError, "A10"),
    (["--device", "cuda"], 2, NotImplementedError, "A15"),
    ([], 0, RuntimeError, "no CUDA device"),
])
def test_encode_corpus_cli_refuses(data_dir, tmp_path, monkeypatch, extra, cards, err, match):
    """Checkpoints (A10), several visible cards under --mesh auto (A15), and
    the default device without a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    with pytest.raises(err, match=match):
        encode_cmd.main(_encode_args(data_dir, str(tmp_path / "x.npz"), *extra))
