"""BM25-mined hard negative sampling: the port's copy of
``mfar_tpu/data/negative_sampler.py``.

Retrieve the whole-document BM25 top ``n_retrieve`` for the query, drop gold
positives, keep the *bottom* ``n_bottom`` of the remaining ranked list (BM25
ranks 51-100 with the defaults: lexically plausible but not trivially
relevant), and sample ``n_sample`` uniformly with an explicit numpy
generator, so one seed gives the JAX package's draws.
"""

from __future__ import annotations

from typing import AbstractSet, List, Optional

import numpy as np

from mfar_tpu_torch.sparse.bm25 import BM25Index


class IndexNegativeSampler:
    def __init__(
        self,
        index: BM25Index,
        n_retrieve: int = 100,
        n_bottom: int = 50,
        n_sample: int = 1,
    ):
        self.index = index
        self.n_retrieve = n_retrieve
        self.n_bottom = n_bottom
        self.n_sample = n_sample

    def sample(
        self,
        query_text: str,
        positives: AbstractSet[str],
        rng: Optional[np.random.Generator] = None,
    ) -> List[str]:
        """Returns sampled negative document keys."""
        rng = rng or np.random.default_rng()
        candidates = [
            (key, score)
            for key, score in self.index.retrieve(query_text, top_k=self.n_retrieve)
            if key not in positives
        ]
        if not candidates:
            # Widen the retrieval just enough to clear the positives.
            wider = len(positives) + self.n_bottom
            candidates = [
                (key, score)
                for key, score in self.index.retrieve(query_text, top_k=wider)
                if key not in positives
            ]
        candidates.sort(key=lambda x: x[1], reverse=True)
        pool = [key for key, _ in candidates[-self.n_bottom :]]
        if not pool:
            return []
        picks = rng.choice(len(pool), size=min(self.n_sample, len(pool)), replace=False)
        return [pool[int(i)] for i in picks]
