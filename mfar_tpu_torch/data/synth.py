"""Deterministic synthetic corpus generation: the port's copy of
``mfar_tpu/data/synth.py`` (numpy-seeded, so its files are byte for byte
the JAX package's).

Replaces the STaRK downloads in offline environments and tests (SURVEY.md
section 4): deterministic semi-structured corpora shaped like each supported
schema (amazon / mag / prime / whatsthatbook), whose queries are built from
distinguishing words of their gold documents, so lexical and dense retrieval
both have learnable/retrievable signal.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np

from mfar_tpu_torch.data import trec
from mfar_tpu_torch.data.types import Corpus

_ADJ = "red blue green small large bright dark heavy light soft".split()
_NOUN = "shoe lamp table chair phone book kettle jacket bottle clock".split()
_VERB = "glows folds spins charges floats warms cools rolls locks sings".split()


def make_amazon_corpus(n_docs: int = 40, seed: int = 0) -> Corpus:
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n_docs):
        adj = _ADJ[i % len(_ADJ)]
        noun = _NOUN[(i // len(_ADJ)) % len(_NOUN)]
        # deterministic, period-1000 jointly with adj/noun (an rng-drawn verb
        # collided for docs i and i+100, yielding identical queries with
        # different gold documents)
        verb = _VERB[(i + i // (len(_ADJ) * len(_NOUN))) % len(_VERB)]
        payload = {
            "title": f"{adj} {noun} model {i}",
            "brand": f"brand{i % 7}",
            "description": [f"a {adj} {noun} that {verb}", f"sku {i}"],
            "feature": [f"feature {verb}", f"weight {i % 5} kg"],
            "review": [
                {
                    "summary": f"{adj} and useful",
                    "reviewText": f"the {noun} really {verb}",
                    "reviewerID": f"user{i}",
                    "overall": 5,
                }
            ],
            "qa": [{"question": f"does it {verb}?", "answer": "yes"}],
            "also_buy": [f"{_ADJ[(i + 1) % len(_ADJ)]} {noun} model {i + 1}"],
            "also_view": [],
        }
        docs.append((str(i), payload))
    return Corpus.from_pairs(docs, dataset_name="amazon")


def make_mag_corpus(n_docs: int = 40, seed: int = 0) -> Corpus:
    rng = np.random.default_rng(seed)
    topics = "optics plasma graphene catalysis polymers neurons".split()
    docs = []
    for i in range(n_docs):
        adj, noun = _ADJ[i % len(_ADJ)], _NOUN[(i // len(_ADJ)) % len(_NOUN)]
        # deterministic, period-1000 jointly with adj/noun (an rng-drawn verb
        # collided for docs i and i+100, yielding identical queries with
        # different gold documents)
        verb = _VERB[(i + i // (len(_ADJ) * len(_NOUN))) % len(_VERB)]
        topic = topics[i % len(topics)]
        payload = {
            "type": "paper",
            "title": f"{adj} {noun} systems study {i}",
            "abstract": f"we show that a {adj} {noun} {verb} under {topic} conditions",
            "paper___cites___paper": [f"{_ADJ[(i + 1) % len(_ADJ)]} {noun} systems study {i + 1}"],
            "paper___has_topic___field_of_study": [topic, "materials"],
            "author___affiliated_with___institution": {
                f"author{i % 9}": [f"institute of {topic}"],
            },
        }
        docs.append((str(i), payload))
    return Corpus.from_pairs(docs, dataset_name="mag")


def make_prime_corpus(n_docs: int = 40, seed: int = 0) -> Corpus:
    rng = np.random.default_rng(seed)
    kinds = ["gene/protein", "disease", "drug"]
    docs = []
    for i in range(n_docs):
        adj, noun = _ADJ[i % len(_ADJ)], _NOUN[(i // len(_ADJ)) % len(_NOUN)]
        # deterministic, period-1000 jointly with adj/noun (an rng-drawn verb
        # collided for docs i and i+100, yielding identical queries with
        # different gold documents)
        verb = _VERB[(i + i // (len(_ADJ) * len(_NOUN))) % len(_VERB)]
        payload = {
            "name": f"{adj.upper()}{noun.upper()}{i}",
            "type": kinds[i % len(kinds)],
            "source": "synthdb",
            "details": {"summary": f"a {adj} entity that {verb}", "count": i},
            # relation fields are {group: [names]} dicts (STaRK grouping)
            "interacts with": {"ppi": [f"{_ADJ[(i + 1) % len(_ADJ)].upper()}{noun.upper()}{i + 1}"]},
            "associated with": {"disease_protein": [f"{adj} {noun} syndrome"]},
            "indication": {"indication": [f"the {adj} {noun} condition"]},
        }
        docs.append((str(i), payload))
    return Corpus.from_pairs(docs, dataset_name="prime")


def make_wtb_corpus(n_docs: int = 40, seed: int = 0) -> Corpus:
    rng = np.random.default_rng(seed)
    genres = "mystery fantasy romance thriller history satire".split()
    docs = []
    for i in range(n_docs):
        adj, noun = _ADJ[i % len(_ADJ)], _NOUN[(i // len(_ADJ)) % len(_NOUN)]
        # deterministic, period-1000 jointly with adj/noun (an rng-drawn verb
        # collided for docs i and i+100, yielding identical queries with
        # different gold documents)
        verb = _VERB[(i + i // (len(_ADJ) * len(_NOUN))) % len(_VERB)]
        payload = {
            "id": str(i),
            "title": f"the {adj} {noun}",
            "author": f"author {i % 9}",
            "author_url": f"https://books.example/a{i % 9}",
            "description": f"a story where the {adj} {noun} {verb} at midnight",
            "genres": [genres[i % len(genres)]],
            "parsed_dates": [f"19{50 + i % 50}"],
            "num_ratings": int(rng.integers(1, 5000)),
            "num_reviews": int(rng.integers(1, 500)),
            "image_link": f"https://books.example/cover{i}.jpg",
            "isbn_13": f"978{i:010d}",
            "ratings": int(rng.integers(1, 6)),
            "reviews": f"readers say it {verb}",
        }
        docs.append((str(i), payload))
    return Corpus.from_pairs(docs, dataset_name="whatsthatbook")


_CORPUS_MAKERS = {
    "amazon": make_amazon_corpus,
    "mag": make_mag_corpus,
    "prime": make_prime_corpus,
    "whatsthatbook": make_wtb_corpus,
}


def make_corpus(dataset_name: str, n_docs: int = 40, seed: int = 0) -> Corpus:
    return _CORPUS_MAKERS[dataset_name](n_docs=n_docs, seed=seed)


def _query_for(doc) -> str:
    """A query lexically anchored to its gold document, per schema."""
    raw = doc.raw
    if "title" in raw and "brand" in raw:  # amazon
        title, verb = raw["title"], raw["description"][0].split(" ")[-1]
        return f"which {title.split()[1]} {verb} and is {title.split()[0]}"
    if raw.get("type") == "paper":  # mag
        words = raw["abstract"].split()
        return f"paper about a {words[4]} {words[5]} in {words[-2]}"
    if "details" in raw:  # prime
        return f"what {raw['type']} is named {raw['name']} and {raw['details']['summary'].split()[-1]}"
    title, verb = raw["title"], raw["description"].split(" ")[-3]  # wtb
    return f"book where {title.split()[-1]} {verb}"


def make_queries_and_qrels(
    corpus: Corpus, n_queries: int = 16, seed: int = 1
) -> Tuple[Dict[str, str], List[trec.QRels]]:
    rng = np.random.default_rng(seed)
    queries: Dict[str, str] = {}
    qrels: List[trec.QRels] = []
    if n_queries > len(corpus):
        raise ValueError(
            f"requested {n_queries} queries from a {len(corpus)}-doc corpus "
            f"(each query has one distinct gold document); raise n_docs or "
            f"lower n_train/n_val"
        )
    doc_ids = rng.permutation(len(corpus))[:n_queries]
    for qi, di in enumerate(doc_ids):
        doc = corpus.docs[int(di)]
        qid = str(1000 + qi)
        queries[qid] = _query_for(doc)
        qrels.append(trec.QRels(qid, doc.id, 1.0))
    return queries, qrels


def write_dataset_dir(path: str, corpus: Corpus, n_train: int = 10, n_val: int = 3, seed: int = 1):
    """Materialize corpus/queries/qrels files in the reference's on-disk layout."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "corpus"), "w") as f:
        for key, payload in corpus.pairs():
            f.write(f"{key}\t{json.dumps(payload)}\n")
    queries, qrels = make_queries_and_qrels(corpus, n_queries=n_train + 2 * n_val, seed=seed)
    qids = list(queries)
    splits = {
        "train": qids[:n_train],
        "val": qids[n_train : n_train + n_val],
        "test": qids[n_train + n_val :],
    }
    for split, ids in splits.items():
        ids_set = set(ids)
        with open(os.path.join(path, f"{split}.queries"), "w") as f:
            for qid in ids:
                f.write(f"{qid}\t{queries[qid]}\n")
        trec.write_qrels(
            os.path.join(path, f"{split}.qrels"),
            [r for r in qrels if r.query_id in ids_set],
        )
    return splits


def stark_like_token_lengths(
    budget: int, n: int, rng: np.random.Generator
) -> np.ndarray:
    """Sample ``n`` per-sequence REAL token lengths for a field whose schema
    budget is ``budget``, shaped like the STaRK corpora the budgets were
    derived from.

    The reference sized each field's ``max_seq_length`` from per-field
    token-length percentiles (the reference's scripts/corpus_stats.py) --
    budgets sit near the tail, so real documents rarely fill them.  With the datasets unavailable
    offline, this encodes that relationship as a DOCUMENTED ASSUMPTION
    rather than a measurement: lengths are lognormal with

    - long fields (budget >= 256, e.g. mag abstract/cites at 512):
      median ~= 0.35 x budget, p95 ~= budget (sigma = ln(1/0.35)/1.645);
    - short fields (budget < 256, e.g. title/topic at 64):
      median ~= 0.2 x budget, p95 ~= 0.6 x budget (titles almost never
      approach their cap);

    clipped to [2, budget] (every sequence carries at least CLS+SEP, and
    the tokenizer truncates at the budget).  Re-derive from real data with
    scripts/corpus_stats.py when the corpora are reachable.
    """
    if budget >= 256:
        median, sigma = 0.35 * budget, np.log(1 / 0.35) / 1.645
    else:
        median, sigma = 0.20 * budget, np.log(3.0) / 1.645
    lens = rng.lognormal(mean=np.log(median), sigma=sigma, size=n)
    return np.clip(np.round(lens).astype(np.int64), 2, budget)
