"""BM25 index: the port's copy of ``mfar_tpu/sparse/bm25.py::BM25Index``,
for the negative sampler and the hybrid (sparse) fields.  The same scoring
model, the "lucene" BM25 variant with k1=1.2, b=0.75:

    idf(t)      = ln(1 + (N - df + 0.5) / (df + 0.5))
    tf_part     = tf / (tf + k1 * (1 - b + b * dl / avgdl))
    impact(t,d) = idf(t) * tf_part

Impacts are precomputed at build time into a ``[vocab, n_docs]`` CSR matrix,
so scoring a query is a sparse row-gather + sum.  With the native C++
engine (:mod:`mfar_tpu_torch.native`, built from the copied source at first
use) scoring, postings and top-k run there instead; ``backend="auto"``
picks it whenever the library builds, as the JAX package does.  Both
backends give the same scores, and both on-disk layouts (``impacts.npz`` or
``native.bin``, beside ``meta.json``) are the JAX package's, so an index
saved by either package loads in the other.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Mapping, Optional, Sequence, Set, Tuple

import numpy as np
import scipy.sparse as sp

from mfar_tpu_torch import native as native_mod
from mfar_tpu_torch.sparse.tokenize import Vocabulary, tokenize

_SCORE_CACHE_MAX = 1 << 15  # entry cap (matches the reference's lru budget)
_SCORE_CACHE_MAX_BYTES = 1 << 30  # 1 GB: each entry is an [n_docs] f32 vector


def _top_rows(scores: np.ndarray, top_k: int) -> np.ndarray:
    """The rows of the ``top_k`` largest scores, unordered (int64)."""
    k = min(top_k, scores.shape[0])
    if k < scores.shape[0]:
        return np.argpartition(-scores, k - 1)[:k].astype(np.int64)
    return np.arange(k, dtype=np.int64)


class BM25Index:
    """Per-field BM25 index over an ordered document collection."""

    def __init__(
        self,
        keys: List[str],
        vocab: Vocabulary,
        matrix: Optional[sp.csr_matrix],  # [vocab, n_docs] impact scores
        k1: float = 1.2,
        b: float = 0.75,
        name: Optional[str] = None,
        native: Optional[native_mod.NativeBM25] = None,  # the native backend
    ):
        self.keys = keys
        self.key_to_id = {key: i for i, key in enumerate(keys)}
        self.vocab = vocab
        self.matrix = matrix
        self.k1 = k1
        self.b = b
        self.name = name
        self.native = native
        self.safe_docs: Set[int] = set()
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
        """Build from (key, text) pairs.  ``backend``: 'native' (the C++
        engine; raises when its library does not build), 'scipy', or 'auto'
        (native whenever the library builds)."""
        if backend not in ("auto", "scipy", "native"):
            raise ValueError(f"backend {backend!r} not in auto|scipy|native")
        keys = [k for k, _ in pairs]
        if backend == "auto":
            backend = "native" if native_mod.available() else "scipy"
        if backend == "native":
            nat = native_mod.NativeBM25.create([t for _, t in pairs], k1=k1, b=b)
            return cls(keys, Vocabulary(), None, k1=k1, b=b, name=name, native=nat)
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

    @property
    def vocab_size(self) -> int:
        return self.native.vocab_size if self.native is not None else len(self.vocab)

    # ------------------------------------------------------------------
    # Scoring

    def get_scores(self, query: str) -> np.ndarray:
        """Full-corpus score vector for one query string (cached)."""
        cached = self._score_cache.get(query)
        if cached is not None:
            return cached
        if self.native is not None:
            scores = self.native.get_scores(query)
        else:
            token_ids = self.vocab.lookup(tokenize(query))
            if token_ids:
                rows = self.matrix[np.asarray(token_ids, dtype=np.int64)]
                scores = np.asarray(rows.sum(axis=0)).ravel().astype(np.float32)
            else:
                scores = np.zeros(self.matrix.shape[1], dtype=np.float32)
        self._cache_put(query, scores)
        return scores

    def get_scores_batch(self, queries: Sequence[str]) -> np.ndarray:
        """Full-corpus score vectors [B, N].  On the native backend the cache
        misses are scored in one threaded call (deduplicated); the result
        never depends on the cache keeping them."""
        if self.native is None:
            return np.stack([self.get_scores(q) for q in queries], axis=0)
        hits = {q: self._score_cache.get(q) for q in queries}
        missing = list(dict.fromkeys(q for q, s in hits.items() if s is None))
        if missing:
            for q, s in zip(missing, self.native.get_scores_batch(missing)):
                hits[q] = s
                self._cache_put(q, s)
        return np.stack([hits[q] for q in queries], axis=0)

    def get_postings_batch(
        self, queries: Sequence[str], pad_multiple: Optional[int] = 128
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Concatenated query-term postings: (doc_ids [B, M] i32, impacts
        [B, M] f32), zero-padded to the batch's longest rounded up to a
        geometric :func:`~mfar_tpu_torch.native.bucket_width` of
        ``pad_multiple`` (None: to the longest itself, at least 1).  A
        document hit by several query terms appears once per term; the
        consumer scatter-adds, so duplicates sum as in the dense score
        vector.  The feed of exact hybrid retrieval: O(nnz)
        per query crosses to the device instead of O(N)."""
        if self.native is not None:
            return self.native.get_postings_batch(queries, pad_multiple)
        per_q: List[Tuple[np.ndarray, np.ndarray]] = []
        for q in queries:
            token_ids = self.vocab.lookup(tokenize(q))
            if token_ids:
                rows = self.matrix[np.asarray(token_ids, dtype=np.int64)]
                per_q.append((rows.indices.astype(np.int32), rows.data.astype(np.float32)))
            else:
                per_q.append((np.zeros(0, np.int32), np.zeros(0, np.float32)))
        m = native_mod.postings_width(max((len(i) for i, _ in per_q), default=0), pad_multiple)
        out_ids = np.zeros((len(queries), m), np.int32)
        out_vals = np.zeros((len(queries), m), np.float32)
        for qi, (ids, vals) in enumerate(per_q):
            out_ids[qi, : len(ids)] = ids
            out_vals[qi, : len(vals)] = vals
        return out_ids, out_vals

    def get_scores_sparse(self, query: str) -> Dict[int, float]:
        """Nonzero scores as {doc_id: score}, restricted to ``safe_docs``
        when it is set (the precompute pipeline's feed)."""
        scores = self.get_scores(query)
        (nz,) = np.nonzero(scores)
        if self.safe_docs:
            return {int(i): float(scores[i]) for i in nz if int(i) in self.safe_docs}
        return {int(i): float(scores[i]) for i in nz}

    def set_safe_docs(self, safe_docs: Set[int]) -> None:
        self.safe_docs = set(safe_docs)

    # ------------------------------------------------------------------
    # Retrieval

    def retrieve(self, query: str, top_k: int) -> List[Tuple[str, float]]:
        return self.retrieve_batch([query], top_k)[0]

    def retrieve_batch(
        self, queries: Sequence[str], top_k: int
    ) -> List[List[Tuple[str, float]]]:
        out = []
        for q in queries:
            scores = self.get_scores(q)
            idx = _top_rows(scores, top_k)
            order = idx[np.argsort(-scores[idx], kind="stable")]
            out.append([(self.keys[int(i)], float(scores[int(i)])) for i in order])
        return out

    def retrieve_rows_batch(self, queries: Sequence[str], top_k: int) -> List[np.ndarray]:
        """Top-k row ids per query, unordered (argpartition only): the
        rerank recall feed, where only membership of the union matters."""
        return [_top_rows(self.get_scores(q), top_k) for q in queries]

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
    # Persistence (the JAX package's layouts: impacts.npz or native.bin,
    # beside meta.json)

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        if self.native is not None:
            self.native.save(os.path.join(path, "native.bin"))
        else:
            sp.save_npz(os.path.join(path, "impacts.npz"), self.matrix)
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(
                {
                    "keys": self.keys,
                    "vocab": self.vocab.token_to_id,
                    "k1": self.k1,
                    "b": self.b,
                    "name": self.name,
                    "backend": "native" if self.native is not None else "scipy",
                },
                f,
            )

    @classmethod
    def load(cls, path: str) -> "BM25Index":
        """A saved index; a ``native.bin`` one needs the native library (and
        raises where it does not build)."""
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        native = matrix = None
        native_bin = os.path.join(path, "native.bin")
        if os.path.exists(native_bin):
            native = native_mod.NativeBM25.load(native_bin)
        else:
            matrix = sp.load_npz(os.path.join(path, "impacts.npz")).tocsr()
        return cls(
            meta["keys"],
            Vocabulary(meta["vocab"]),
            matrix,
            k1=meta["k1"],
            b=meta["b"],
            name=meta.get("name"),
            native=native,
        )
