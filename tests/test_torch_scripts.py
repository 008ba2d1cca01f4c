"""The port's analysis scripts (``mfar_tpu_torch.scripts``) against the
repository's ``scripts/*.py``, which read the JAX package's data modules:
byte-equal stdout on the same files, and ``corpus_stats`` over a local
tokenizer directory held to ``transformers``' own count."""

import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from mfar_tpu_torch.data import trec
from mfar_tpu_torch.data.synth import make_corpus, write_dataset_dir
from mfar_tpu_torch.models.encoder import EncoderConfig, init_encoder
from mfar_tpu_torch.models.registry import save_bert_dir
from mfar_tpu_torch.scripts import compare_results, corpus_stats, find_failures

torch.set_num_threads(1)

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"
PORT = {"find_failures": find_failures, "compare_results": compare_results,
        "corpus_stats": corpus_stats}


def _load(name):
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}", SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _both(capsys, name, argv):
    """The JAX script's and the port's stdout on the same arguments."""
    _load(name).main(argv)
    jax_out = capsys.readouterr().out
    PORT[name].main(argv)
    return jax_out, capsys.readouterr().out


def _run(rng, queries, gold, n_docs, drop):
    """A run file: 8 docs a query, gold at a rank that varies, sims with ties
    (tenths), lines shuffled out of sim order; ``drop`` is left out."""
    rows = []
    for i, qid in enumerate(queries):
        if qid == drop:
            continue
        others = [str(d) for d in rng.permutation(n_docs) if str(d) not in gold.get(qid, ())]
        docs = others[:8]
        for j, g in enumerate(sorted(gold.get(qid, ()))):
            docs[(i + 3 * j) % 8] = g
        sims = np.round(np.linspace(1.0, 0.3, 8), 1)
        sims[3] = sims[4] = sims[2]  # a three-way tie
        rows += [trec.QRes(qid, d, float(s), rank=r) for r, (d, s) in enumerate(zip(docs, sims))]
    return [rows[i] for i in rng.permutation(len(rows))]


@pytest.fixture(scope="module")
def ds(tmp_path_factory):
    """Synthetic amazon and mag datasets; a ``probe`` partition whose
    queries have one or two gold docs (one of them absent from
    ``.queries``) and two runs over it that differ."""
    root = tmp_path_factory.mktemp("torch_scripts")
    dirs = {}
    for name in ("amazon", "mag"):
        d = str(root / name)
        write_dataset_dir(d, make_corpus(name, 30, seed=3), n_train=6, n_val=3)
        dirs[name] = d
    # one mag abstract longer than any model's 512 tokens: counted whole
    with open(os.path.join(dirs["mag"], "corpus"), "a") as f:
        f.write("30\t" + json.dumps({"type": "paper", "title": "long",
                                      "abstract": " ".join(["shoe glows"] * 400)}) + "\n")
    d = dirs["amazon"]
    rng = np.random.default_rng(7)
    queries = {f"q{i}": f"probe query {i}" for i in range(12)}
    gold = {q: {str(rng.integers(30))} | ({str(rng.integers(30))} if i % 3 == 0 else set())
            for i, q in enumerate(queries)}
    gold["q_unlisted"] = {"4"}
    with open(os.path.join(d, "probe.queries"), "w") as f:
        f.writelines(f"{q}\t{t}\n" for q, t in queries.items())
    trec.write_qrels(os.path.join(d, "probe.qrels"),
                     [trec.QRels(q, g, 1.0) for q, gs in gold.items() for g in sorted(gs)])
    all_q = list(queries) + ["q_unlisted"]
    trec.write_qres(os.path.join(d, "a.qres"), _run(rng, all_q, gold, 30, drop="q5"))
    trec.write_qres(os.path.join(d, "b.qres"), _run(rng, all_q[::-1], gold, 30, drop="q2"))
    return dirs


@pytest.mark.parametrize("k", [1, 2, 5])
def test_find_failures_matches_jax(ds, capsys, k):
    argv = ["--data-path", ds["amazon"], "--partition", "probe", "--qres-path",
            os.path.join(ds["amazon"], "a.qres"), "--k", str(k)]
    jax_out, port_out = _both(capsys, "find_failures", argv)
    assert port_out == jax_out
    assert "Query q5 not found in predictions" in port_out
    if k < 5:
        assert "QUERY: " in port_out and "Relevant documents: [(" in port_out


@pytest.mark.parametrize("k", [2, 5])
def test_compare_results_matches_jax(ds, capsys, k):
    d = ds["amazon"]
    argv = ["--data-path", d, "--partition", "probe", "--res1", os.path.join(d, "a.qres"),
            "--res2", os.path.join(d, "b.qres"), "--k", str(k)]
    jax_out, port_out = _both(capsys, "compare_results", argv)
    assert port_out == jax_out
    assert "has different results" in port_out and "\033[94;4;1m" in port_out


@pytest.mark.parametrize("dataset", ["amazon", "mag"])
def test_corpus_stats_whitespace_matches_jax(ds, capsys, dataset):
    argv = ["--corpus", ds[dataset], "--dataset-name", dataset, "--field-names", "all_dense"]
    jax_out, port_out = _both(capsys, "corpus_stats", argv)
    assert port_out == jax_out
    lines = port_out.splitlines()
    assert lines[0].startswith("field,p100.0,")
    assert lines[-1] == f"{31 if dataset == 'mag' else 30} documents"


@pytest.fixture(scope="module")
def bert_dir(ds, tmp_path_factory):
    """A local BERT directory as ``save_bert_dir`` writes it: a seeded tiny
    encoder and a WordPiece vocab of some of the corpus's words."""
    words = sorted({w.lower() for ln in open(os.path.join(ds["mag"], "corpus"))
                    for w in ln.split("\t")[1].replace('"', " ").split() if w.isalpha()})
    cfg = EncoderConfig.tiny(vocab_size=512, num_layers=1)
    path = str(tmp_path_factory.mktemp("bert"))
    save_bert_dir(path, cfg, init_encoder(cfg, seed=0).state_dict(), words[::2])
    return path


def test_corpus_stats_local_tokenizer_counts_as_transformers(ds, bert_dir, capsys):
    from transformers import AutoTokenizer

    from mfar_tpu_torch.data.format import format_documents
    from mfar_tpu_torch.data.schema import resolve_fields

    tok = AutoTokenizer.from_pretrained(bert_dir)
    pairs = list(trec.read_corpus(os.path.join(ds["mag"], "corpus")))
    want = ["field," + ",".join(f"p{p}" for p in corpus_stats.PERCENTILES)]
    seen = set()
    for field in resolve_fields("all_dense", "mag").values():
        if field.name in seen:
            continue
        seen.add(field.name)
        lengths = [len(tok(text)["input_ids"]) for _, text in
                   format_documents(pairs, field.name, field.dataset)]
        want.append(f"{field.name}," + ",".join(
            str(int(np.ceil(np.percentile(lengths, p)))) for p in corpus_stats.PERCENTILES))
    want.append(f"{len(pairs)} documents")
    p100 = {ln.split(",")[0]: int(ln.split(",")[1]) for ln in want[1:-1]}
    assert p100["abstract"] > 800  # the long abstract, whole

    corpus_stats.main(["--corpus", ds["mag"], "--dataset-name", "mag", "--field-names",
                       "all_dense", "--tokenizer", bert_dir])
    assert capsys.readouterr().out.splitlines() == want


def test_corpus_stats_reads_local_directories_only(ds, tmp_path):
    for name in ("bert-base-uncased", str(tmp_path / "missing")):
        with pytest.raises(FileNotFoundError, match="local files only"):
            corpus_stats.main(["--corpus", ds["mag"], "--dataset-name", "mag",
                               "--field-names", "all_dense", "--tokenizer", name])


def test_jax_corpus_stats_local_tokenizer_fault(ds, bert_dir):
    """The JAX script's fault (``scripts/corpus_stats.py:49-50``): a
    ``transformers`` tokenizer also has ``encode``, so the script takes the
    ``tokenizers`` branch and calls ``no_truncation``, which it lacks."""
    with pytest.raises(AttributeError, match="no_truncation"):
        _load("corpus_stats").main(["--corpus", ds["mag"], "--dataset-name", "mag",
                                    "--field-names", "all_dense", "--tokenizer", bert_dir])
