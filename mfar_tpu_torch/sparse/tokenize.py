"""Text -> stemmed token streams for the sparse (BM25) side: the port's
copy of ``mfar_tpu/sparse/tokenize.py``.  Lowercase, word tokens of length
>= 2, English stopwords dropped, Porter2-stemmed
(:mod:`mfar_tpu_torch.sparse.stemmer`).
"""

from __future__ import annotations

import re
from functools import lru_cache
from typing import Dict, Iterable, List, Optional, Tuple

from mfar_tpu_torch.sparse.stemmer import porter2_stem

# sklearn-style token pattern (also bm25s's default): unicode word chars,
# minimum length 2.
_TOKEN_RE = re.compile(r"(?u)\b\w\w+\b")

# Lucene's classic English stopword list.
STOPWORDS_EN = frozenset(
    """a an and are as at be but by for if in into is it no not of on or such
    that the their then there these they this to was will with""".split()
)


@lru_cache(maxsize=1 << 20)
def tokenize(text: str, stopwords: str = "en", stem: bool = True) -> Tuple[str, ...]:
    """Tokenize one string; cached because training re-tokenizes the same
    queries every epoch (the reference used the same trick, reference:
    mfar/data/index.py:56-58)."""
    stop = STOPWORDS_EN if stopwords == "en" else frozenset()
    tokens = [t for t in _TOKEN_RE.findall(text.lower()) if t not in stop]
    if stem:
        tokens = [porter2_stem(t) for t in tokens]
    return tuple(tokens)


class Vocabulary:
    """Token string <-> integer id map built at index time."""

    def __init__(self, token_to_id: Optional[Dict[str, int]] = None):
        self.token_to_id: Dict[str, int] = token_to_id or {}

    def __len__(self) -> int:
        return len(self.token_to_id)

    def add(self, token: str) -> int:
        tid = self.token_to_id.get(token)
        if tid is None:
            tid = len(self.token_to_id)
            self.token_to_id[token] = tid
        return tid

    def lookup(self, tokens: Iterable[str]) -> List[int]:
        """Ids of known tokens; unknown tokens are dropped (they cannot
        contribute to any document's score)."""
        out = []
        for t in tokens:
            tid = self.token_to_id.get(t)
            if tid is not None:
                out.append(tid)
        return out
