"""BM25 index: the port's copy of the scipy backend of
``mfar_tpu/sparse/bm25.py::BM25Index``, for the negative sampler (and later
the hybrid fields).  The same scoring model, the "lucene" BM25 variant with
k1=1.2, b=0.75:

    idf(t)      = ln(1 + (N - df + 0.5) / (df + 0.5))
    tf_part     = tf / (tf + k1 * (1 - b + b * dl / avgdl))
    impact(t,d) = idf(t) * tf_part

Impacts are precomputed at build time into a ``[vocab, n_docs]`` CSR matrix,
so scoring a query is a sparse row-gather + sum.  The JAX package's native
C++ engine is not ported (``backend="native"`` and loading a native-saved
index raise, ROADMAP A8); its scores equal the scipy backend's, so an index
saved by the JAX package's scipy backend loads here and scores the same.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as sp

from mfar_tpu_torch.sparse.tokenize import Vocabulary, tokenize

_SCORE_CACHE_MAX = 1 << 15  # entry cap (matches the reference's lru budget)
_SCORE_CACHE_MAX_BYTES = 1 << 30  # 1 GB: each entry is an [n_docs] f32 vector


def _native_not_ported() -> NotImplementedError:
    return NotImplementedError(
        "the native C++ BM25 engine is not ported: the port's BM25 runs the "
        "scipy backend (ROADMAP A8)"
    )


class BM25Index:
    """Per-field BM25 index over an ordered document collection."""

    def __init__(
        self,
        keys: List[str],
        vocab: Vocabulary,
        matrix: sp.csr_matrix,  # [vocab, n_docs] impact scores
        k1: float = 1.2,
        b: float = 0.75,
        name: Optional[str] = None,
    ):
        self.keys = keys
        self.key_to_id = {key: i for i, key in enumerate(keys)}
        self.vocab = vocab
        self.matrix = matrix
        self.k1 = k1
        self.b = b
        self.name = name
        self._score_cache: Dict[str, np.ndarray] = {}
        self._score_cache_bytes = 0

    def _cache_put(self, query: str, scores: np.ndarray) -> None:
        """Insert with oldest-first eviction, bounded by entry count and bytes."""
        cache = self._score_cache
        entry = scores.nbytes
        while cache and (
            len(cache) >= _SCORE_CACHE_MAX
            or self._score_cache_bytes + entry > _SCORE_CACHE_MAX_BYTES
        ):
            oldest = next(iter(cache))
            self._score_cache_bytes -= cache.pop(oldest).nbytes
        cache[query] = scores
        self._score_cache_bytes += entry

    @classmethod
    def create(
        cls,
        pairs: Sequence[Tuple[str, str]],
        k1: float = 1.2,
        b: float = 0.75,
        name: Optional[str] = None,
        backend: str = "auto",
    ) -> "BM25Index":
        """Build from (key, text) pairs.  ``backend`` 'auto' and 'scipy'
        build the scipy index; 'native' raises (ROADMAP A8)."""
        if backend == "native":
            raise _native_not_ported()
        if backend not in ("auto", "scipy"):
            raise ValueError(f"backend {backend!r} not in auto|scipy|native")
        keys = [k for k, _ in pairs]
        n_docs = len(keys)
        vocab = Vocabulary()

        doc_term_ids: List[np.ndarray] = []
        doc_term_tfs: List[np.ndarray] = []
        doc_lens = np.zeros(n_docs, dtype=np.float64)
        df_counts: Dict[int, int] = {}

        for d, (_, text) in enumerate(pairs):
            tokens = tokenize(text)
            doc_lens[d] = len(tokens)
            counts: Dict[int, int] = {}
            for t in tokens:
                tid = vocab.add(t)
                counts[tid] = counts.get(tid, 0) + 1
            doc_term_ids.append(np.fromiter(counts.keys(), dtype=np.int64, count=len(counts)))
            doc_term_tfs.append(np.fromiter(counts.values(), dtype=np.float64, count=len(counts)))
            for tid in counts:
                df_counts[tid] = df_counts.get(tid, 0) + 1

        v = len(vocab)
        df = np.zeros(v, dtype=np.float64)
        for tid, c in df_counts.items():
            df[tid] = c
        idf = np.log(1.0 + (n_docs - df + 0.5) / (df + 0.5))
        avgdl = doc_lens.mean() if n_docs else 0.0

        rows, cols, vals = [], [], []
        for d in range(n_docs):
            tids, tfs = doc_term_ids[d], doc_term_tfs[d]
            if tids.size == 0:
                continue
            denom = tfs + k1 * (1.0 - b + b * doc_lens[d] / avgdl)
            rows.append(tids)
            cols.append(np.full(tids.shape, d, dtype=np.int64))
            vals.append(idf[tids] * (tfs / denom))

        if rows:
            matrix = sp.csr_matrix(
                (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
                shape=(v, n_docs),
                dtype=np.float32,
            )
        else:
            matrix = sp.csr_matrix((v, n_docs), dtype=np.float32)
        return cls(keys, vocab, matrix, k1=k1, b=b, name=name)

    # ------------------------------------------------------------------
    # Scoring

    def get_scores(self, query: str) -> np.ndarray:
        """Full-corpus score vector for one query string (cached)."""
        cached = self._score_cache.get(query)
        if cached is not None:
            return cached
        token_ids = self.vocab.lookup(tokenize(query))
        if token_ids:
            rows = self.matrix[np.asarray(token_ids, dtype=np.int64)]
            scores = np.asarray(rows.sum(axis=0)).ravel().astype(np.float32)
        else:
            scores = np.zeros(self.matrix.shape[1], dtype=np.float32)
        self._cache_put(query, scores)
        return scores

    def get_scores_batch(self, queries: Sequence[str]) -> np.ndarray:
        """Full-corpus score vectors [B, N]."""
        return np.stack([self.get_scores(q) for q in queries], axis=0)

    def retrieve(self, query: str, top_k: int) -> List[Tuple[str, float]]:
        return self.retrieve_batch([query], top_k)[0]

    def retrieve_batch(
        self, queries: Sequence[str], top_k: int
    ) -> List[List[Tuple[str, float]]]:
        out = []
        for q in queries:
            scores = self.get_scores(q)
            k = min(top_k, scores.shape[0])
            idx = np.argpartition(-scores, k - 1)[:k] if k < scores.shape[0] else np.arange(k)
            order = idx[np.argsort(-scores[idx], kind="stable")]
            out.append([(self.keys[int(i)], float(scores[int(i)])) for i in order])
        return out

    def score_batch(self, queries: Sequence[str], keys: Sequence[str]) -> np.ndarray:
        """[Q, C] scores restricted to candidate keys; unknown keys score 0."""
        doc_ids = np.array([self.key_to_id.get(key, -1) for key in keys], dtype=np.int64)
        picked = self.get_scores_batch(queries)[:, doc_ids]
        picked[:, doc_ids == -1] = 0.0
        return picked

    def score_batch_with_cache(
        self,
        query_ids: Sequence[int],
        keys: Sequence[str],
        sparse_scores: Mapping[int, Mapping[int, float]],
    ) -> np.ndarray:
        """[Q, C] from precomputed {qid: {doc_id: score}} dicts."""
        doc_ids = [self.key_to_id.get(key, -1) for key in keys]
        out = np.zeros((len(query_ids), len(keys)), dtype=np.float32)
        for qi, qid in enumerate(query_ids):
            per_query = sparse_scores.get(qid, {})
            for ci, did in enumerate(doc_ids):
                if did >= 0:
                    out[qi, ci] = per_query.get(did, 0.0)
        return out

    # ------------------------------------------------------------------
    # Persistence (the JAX package's scipy layout: impacts.npz + meta.json)

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        sp.save_npz(os.path.join(path, "impacts.npz"), self.matrix)
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(
                {
                    "keys": self.keys,
                    "vocab": self.vocab.token_to_id,
                    "k1": self.k1,
                    "b": self.b,
                    "name": self.name,
                    "backend": "scipy",
                },
                f,
            )

    @classmethod
    def load(cls, path: str) -> "BM25Index":
        if os.path.exists(os.path.join(path, "native.bin")):
            raise _native_not_ported()
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        return cls(
            meta["keys"],
            Vocabulary(meta["vocab"]),
            sp.load_npz(os.path.join(path, "impacts.npz")).tocsr(),
            k1=meta["k1"],
            b=meta["b"],
            name=meta.get("name"),
        )
