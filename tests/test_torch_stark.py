"""The port's STaRK tools (``stark_to_trec``, ``download_queries``) against
the JAX package's, on a stub ``stark_qa`` written in plain Python and numpy:
the same files byte for byte, the same printed lines, the same errors."""

import filecmp
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from mfar_tpu.commands.stark import download_queries as jax_dq
from mfar_tpu.commands.stark import stark_to_trec as jax_s2t
from mfar_tpu_torch.commands.stark import download_queries as port_dq
from mfar_tpu_torch.commands.stark import stark_to_trec as port_s2t

torch.set_num_threads(1)

TOOLS = {"jax": {"convert": jax_s2t, "download": jax_dq},
         "port": {"convert": port_s2t, "download": port_dq}}


# ---------------------------------------------------------------------------
# the stub: three small knowledge bases and their QA tables


class SKB:
    """What the tools read of ``stark_qa``'s semi-structured knowledge base."""

    def __init__(self, candidate_ids, node_info, edge_type_dict, edges, node_types=None,
                 node_type_dict=None):
        self.candidate_ids = candidate_ids
        self.node_info = node_info
        self.edge_type_dict = edge_type_dict
        self.edges = edges
        self.node_types = node_types
        self.node_type_dict = node_type_dict

    def get_neighbor_nodes(self, idx, edge_type):
        return list(self.edges.get((idx, edge_type), []))


def amazon_skb():
    info = {
        0: {"title": "Red\tlamp\n", "brand": "Acme", "price": 9.5, "in_stock": np.bool_(True)},
        1: {"title": "Blue chair", "brand": "Café Co", "rating": None},
        2: {"title": -1, "brand": "  spaced  "},
        3: {"title": "-1", "details": ["a\rb", "c"]},
        4: {"title": "Green kettle\u001f", "feature": {"colour": "green\tish"}},
        5: {"title": "Bright clock", "brand": "Acme"},
        6: {"name": "Acme"},  # a brand node, not a candidate
    }
    edges = {
        (0, "also_buy"): [1, 2, 3], (0, "also_view"): [4],
        (1, "also_buy"): [0], (1, "also_view"): [],
        (2, "also_view"): [5, 3], (3, "also_buy"): [2],
        (4, "also_buy"): [5, 0], (5, "also_view"): [1, 4],
        (0, "has_brand"): [6], (5, "has_brand"): [6],
    }
    return SKB([0, 1, 2, 3, 4, 5], info, {0: "also_buy", 1: "also_view", 2: "has_brand"},
               edges)


def mag_skb():
    papers = {i: {"title": t, "year": 2000 + i} for i, t in enumerate(
        ["Graph\tnets", "Sparse  retrieval\n", "Über Suche", "Dense passages", "Fields"])}
    authors = {10: "Ann", 11: "Bo", 12: "Cy", 13: -1, 14: "-1", 15: "Di"}
    info = dict(papers)
    info.update({a: {"DisplayName": n} for a, n in authors.items()})
    info.update({20: {"DisplayName": "MIT"}, 21: {"DisplayName": "ETH\tZürich"},
                 22: {"DisplayName": "KAIST"}, 30: {"DisplayName": "IR"},
                 31: {"DisplayName": "ML\n"}})
    aff = "author___affiliated_with___institution"
    writes = "author___writes___paper"
    edges = {
        (0, writes): [10, 11, 12], (1, writes): [12, 13, 14], (2, writes): [10, 15],
        (3, writes): [], (4, writes): [11, 14, 15],
        (11, aff): [20], (12, aff): [21, 22], (14, aff): [20], (15, aff): [22],
        (0, "paper___cites___paper"): [1, 2], (2, "paper___cites___paper"): [0],
        (4, "paper___cites___paper"): [3],
        (0, "paper___has_topic___field_of_study"): [30, 31],
        (3, "paper___has_topic___field_of_study"): [31],
    }
    # the affiliation edge comes first, as in STaRK's MAG: the join written
    # under the writes edge then replaces its plain (empty) neighbour list
    return SKB([0, 1, 2, 3, 4], info, {0: aff, 1: "paper___cites___paper",
                                       2: "paper___has_topic___field_of_study", 3: writes},
               edges)


def prime_skb():
    names = ["flu", "fever\t", "aspirin", "ibuprofen", "TP53", "BRCA1", "headache"]
    types_ = np.array([0, 0, 1, 1, 2, 2, 3])
    info = {i: {"name": n, "source": "stub", "details": {"note": f"node\n{i}"}}
            for i, n in enumerate(names)}
    edges = {
        (0, "indication"): [2, 4, 3],  # drugs and a gene under one relation
        (0, "side effect"): [],  # a relation with no neighbours
        (0, "ppi"): [5], (1, "indication"): [3], (2, "side effect"): [6],
        (2, "target"): [4, 5], (4, "ppi"): [5, 4], (6, "phenotype present"): [0, 1],
        (5, "not a field"): [0],
    }
    rels = ["ppi", "indication", "side effect", "target", "phenotype present", "not a field"]
    return SKB(list(range(7)), info, dict(enumerate(rels)), edges, node_types=types_,
               node_type_dict={0: "disease", 1: "drug", 2: "gene/protein",
                               3: "effect/phenotype"})


class Table:
    """``qa.data``: ``iloc[i]`` is a row with ``id``, ``query`` and
    ``answer_ids`` (a JSON list, as STaRK's CSV holds it)."""

    def __init__(self, rows):
        self.iloc = [types.SimpleNamespace(id=i, query=q, answer_ids=json.dumps(a))
                     for i, (q, a) in enumerate(rows)]


def qa_table(name):
    rows = [
        (f"{name} query\twith a tab\n", [0, 2]), ("all answers late", [3, 5]),
        ("repeated answer", [1, 1, 4]), ("  padded query  ", [2]), ("another late", [4]),
        ("zero", [0]), ("mixed", [5, 0, 3]), ("val one", [1]), ("val late", [6]),
        ("test one\r", [2, 3]), ("test two", [0, 6, 1]), ("test late", [3]),
    ]
    splits = {"train": [0, 1, 2, 3, 4, 5, 6], "val": [7, 8], "test": [9, 10, 11],
              "test-0.1": [10]}
    if name == "emptytrain":
        splits["train"] = []
    return types.SimpleNamespace(
        data=Table(rows), split_indices={k: np.array(v, dtype=np.int64)
                                         for k, v in splits.items()})


SKBS = {"amazon": amazon_skb, "mag": mag_skb, "prime": prime_skb}


def load_skb(name, download_processed=True):
    assert download_processed
    return SKBS[name]()


def load_qa(name):
    return qa_table(name)


@pytest.fixture
def stark_qa(monkeypatch):
    mod = types.ModuleType("stark_qa")
    mod.load_skb, mod.load_qa = load_skb, load_qa
    monkeypatch.setitem(sys.modules, "stark_qa", mod)


# ---------------------------------------------------------------------------
# helpers


def _files(root):
    return sorted(os.listdir(root)) if os.path.isdir(root) else []


def _same_files(a, b):
    assert _files(a) == _files(b) and _files(a)
    for name in _files(a):
        assert filecmp.cmp(os.path.join(a, name), os.path.join(b, name), shallow=False), name


def _run_both(tmp_path, capsys, tool, argv):
    """Each package's ``main(argv + ['--out', DIR])``; their stdouts and dirs."""
    outs = {}
    for pkg, mods in TOOLS.items():
        out = str(tmp_path / pkg)
        mods[tool].main(argv + ["--out", out])
        outs[pkg] = (capsys.readouterr().out, out)
    return outs


def _corpus(path):
    with open(os.path.join(path, "corpus"), encoding="utf-8") as f:
        return {int(k): json.loads(v) for k, v in (ln.split("\t") for ln in f.read().split("\n"))}


# ---------------------------------------------------------------------------
# stark_to_trec


@pytest.mark.parametrize("max_docs", [-1, 3])
@pytest.mark.parametrize("dataset", ["amazon", "mag", "prime"])
def test_convert_matches_jax(tmp_path, capsys, stark_qa, dataset, max_docs):
    # both flag spellings: the JAX reference's underscores and argparse's hyphens
    underscore = max_docs == -1
    argv = ["--dataset_name" if underscore else "--dataset-name", dataset,
            "--max_docs" if underscore else "--max-docs", str(max_docs)]
    outs = _run_both(tmp_path, capsys, "convert", argv)
    _same_files(outs["jax"][1], outs["port"][1])
    assert outs["jax"][0] == outs["port"][0]
    n = 3 if max_docs == 3 else len(SKBS[dataset]().candidate_ids)
    assert outs["port"][0] == f"Corpus {dataset} has {n} documents.\n"
    with open(os.path.join(outs["port"][1], "corpus"), encoding="utf-8") as f:
        text = f.read()
    assert not text.endswith("\n") and len(text.split("\n")) == n


def test_convert_behaviours(tmp_path, stark_qa):
    """What the byte comparison holds, read back from the port's files."""
    docs = {}
    for name in SKBS:
        port_s2t.convert(name, str(tmp_path / name))
        docs[name] = _corpus(str(tmp_path / name))

    amazon = docs["amazon"]
    assert amazon[0]["title"] == "Red lamp" and amazon[0]["in_stock"] is True
    assert amazon[0]["also_buy"] == ["Blue chair"]  # -1 and "-1" dropped
    assert amazon[2]["also_view"] == ["Bright clock"] and amazon[1]["also_view"] == []
    assert "has_brand" not in amazon[0] and amazon[4]["feature"] == {"colour": "green ish"}

    aff, writes = "author___affiliated_with___institution", "author___writes___paper"
    mag = docs["mag"]
    assert mag[0][writes] == ["Ann", "Bo", "Cy"]
    assert mag[0][aff] == {"Bo": ["MIT"], "Cy": ["KAIST"]}  # no institution: left out; last kept
    assert mag[1][writes] == ["Cy"] and mag[1][aff] == {"Cy": ["KAIST"]}
    assert mag[3][writes] == [] and mag[3][aff] == {}
    assert mag[2]["title"] == "Über Suche" and mag[0]["paper___has_topic___field_of_study"] == [
        "IR", "ML"]
    with open(tmp_path / "mag" / "corpus", encoding="utf-8") as f:
        assert "Über" in f.read()  # ensure_ascii=False

    prime = docs["prime"]
    assert prime[0]["indication"] == {"drug": ["aspirin", "ibuprofen"], "gene/protein": ["TP53"]}
    assert "side effect" not in prime[0] and "not a field" not in prime[5]
    assert prime[6]["phenotype present"] == {"disease": ["flu", "fever"]}
    assert prime[0]["details"] == {"note": "node 0"}


# ---------------------------------------------------------------------------
# download_queries


@pytest.mark.parametrize("max_docs", [None, "-1", "0", "3"])
@pytest.mark.parametrize("dataset", ["amazon", "mag", "prime"])
def test_download_matches_jax(tmp_path, capsys, stark_qa, dataset, max_docs):
    spelling = "--max_docs" if dataset == "mag" else "--max-docs"
    argv = ["--dataset_name", dataset] + ([spelling, max_docs] if max_docs else [])
    outs = _run_both(tmp_path, capsys, "download", argv)
    _same_files(outs["jax"][1], outs["port"][1])
    assert _files(outs["port"][1]) == sorted(
        f"{p}.{ext}" for p in port_dq.PARTITIONS for ext in ("queries", "qrels"))
    assert outs["jax"][0] == outs["port"][0]
    lines = outs["port"][0].splitlines()
    assert [ln.split(":")[0] for ln in lines] == [f"Partition {p}" for p in port_dq.PARTITIONS]
    with open(os.path.join(outs["port"][1], "train.queries")) as f:
        train = [ln.split("\t") for ln in f.read().splitlines()]
    if max_docs == "3":  # queries 1 and 4 have no answer below 3
        assert [q for q, _ in train] == ["0", "2", "3", "5", "6"]
    else:
        assert len(train) == 7
    assert train[0][1] == f"{dataset} query with a tab"


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_download_bad_max_docs_writes_nothing(tmp_path, stark_qa, pkg):
    with pytest.raises(ValueError):
        TOOLS[pkg]["download"].main(["--dataset-name", "amazon", "--out", str(tmp_path / "o"),
                            "--max-docs", "abc"])
    assert not os.path.exists(tmp_path / "o")


def test_download_empty_train_raises_in_both(tmp_path, capsys, stark_qa):
    for pkg, mods in TOOLS.items():
        with pytest.raises(ValueError, match="train has no queries"):
            mods["download"].download("emptytrain", str(tmp_path / pkg))
    assert capsys.readouterr().out == "Partition train: 0 queries, 0 judgements\n" * 2
    _same_files(str(tmp_path / "jax"), str(tmp_path / "port"))


@pytest.mark.parametrize("tool", ["convert", "download"])
def test_without_stark_qa_both_exit(tmp_path, monkeypatch, tool):
    monkeypatch.setitem(sys.modules, "stark_qa", None)
    for pkg, mods in TOOLS.items():
        with pytest.raises(SystemExit) as e:
            mods[tool].main(["--dataset-name", "mag", "--out", str(tmp_path / pkg)])
        assert not os.path.exists(tmp_path / pkg)
    assert "python -m mfar_tpu_torch.commands.make_synth_data" in str(e.value)
