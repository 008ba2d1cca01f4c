"""Copy of ``mfar_tpu/models/tokenizer.py`` for the PyTorch port (the port imports nothing
of the JAX package); keep the two in step.  The port reads a local ``tokenizer.json``
only: ``HFTokenizer.from_pretrained`` (``transformers``) is not copied.

Tokenization for the dense encoder with static-shape-friendly padding.

Two backends:

- :class:`HFTokenizer`: wraps a HuggingFace ``tokenizers`` fast tokenizer
  loaded from a local ``tokenizer.json`` (the WordPiece vocab Contriever
  uses).  Host-side Rust -- this is the reference's tokenization path too.
- :class:`SimpleVocabTokenizer`: a deterministic word-level tokenizer built
  from a corpus, for tests and offline environments.

XLA wants static shapes (SURVEY.md section 7 "hard parts"): instead of the
reference's ``padding='longest'`` dynamic shapes (reference:
mfar/data/dataset.py:240-247), batches pad to the smallest power-of-two
bucket that fits, capping recompilation at one program per (field, bucket).
"""

from __future__ import annotations

import json
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np

PAD_ID = 0
UNK_ID = 1
CLS_ID = 2
SEP_ID = 3

_BUCKETS = (8, 16, 32, 64, 128, 256, 512)


def pad_to_bucket(length: int, max_length: int) -> int:
    """Smallest bucket >= length, capped at max_length."""
    for b in _BUCKETS:
        if b >= min(length, max_length):
            return min(b, max_length)
    return max_length


class SimpleVocabTokenizer:
    """Word-level tokenizer with a corpus-built vocabulary.

    Emits BERT-style sequences: [CLS] tokens... [SEP], attention mask 1 on
    real tokens.  Deterministic given the corpus; id 0 is PAD so embedding
    rows line up with the attention mask.
    """

    def __init__(self, vocab: Dict[str, int], max_length: int = 512):
        self.vocab = vocab
        self.max_length = max_length

    @property
    def vocab_size(self) -> int:
        # default covers an empty corpus vocab: the 4 reserved ids
        # (PAD/UNK/CLS/SEP) always exist
        return max(self.vocab.values(), default=3) + 1

    @classmethod
    def build(cls, texts: Sequence[str], max_vocab: int = 32768, max_length: int = 512):
        counts: Dict[str, int] = {}
        for t in texts:
            for w in t.lower().split():
                counts[w] = counts.get(w, 0) + 1
        words = sorted(counts, key=lambda w: (-counts[w], w))[: max_vocab - 4]
        vocab = {w: i + 4 for i, w in enumerate(words)}
        return cls(vocab, max_length)

    def encode(self, text: str, max_length: Optional[int] = None) -> List[int]:
        # The tokenizer's own max_length is the encoder's hard capacity cap
        # (mirrors the reference's 512-token encoder limit): per-field
        # budgets larger than it truncate here.
        max_length = min(max_length or self.max_length, self.max_length)
        ids = [self.vocab.get(w, UNK_ID) for w in text.lower().split()]
        return [CLS_ID] + ids[: max_length - 2] + [SEP_ID]

    def encode_batch(
        self,
        texts: Sequence[str],
        max_length: Optional[int] = None,
        bucket: bool = True,
    ) -> Dict[str, np.ndarray]:
        max_length = min(max_length or self.max_length, self.max_length)
        seqs = [self.encode(t, max_length) for t in texts]
        longest = max((len(s) for s in seqs), default=1)
        width = pad_to_bucket(longest, max_length) if bucket else max_length
        input_ids = np.full((len(seqs), width), PAD_ID, dtype=np.int32)
        mask = np.zeros((len(seqs), width), dtype=np.int32)
        for i, s in enumerate(seqs):
            s = s[:width]
            input_ids[i, : len(s)] = s
            mask[i, : len(s)] = 1
        return {"input_ids": input_ids, "attention_mask": mask}

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"vocab": self.vocab, "max_length": self.max_length}, f)

    @classmethod
    def load(cls, path: str) -> "SimpleVocabTokenizer":
        with open(path) as f:
            d = json.load(f)
        return cls(d["vocab"], d["max_length"])


class HFTokenizer:
    """HuggingFace fast-tokenizer backend (local ``tokenizer.json``).

    Unlike the JAX copy, each truncation length encodes through its own
    copy of the backend tokenizer, configured once: reconfiguring one
    shared tokenizer while another thread encodes with it (the trainer's
    prefetch thread beside the caller's index build) raises "Already
    borrowed"."""

    def __init__(self, tokenizer, max_length: int = 512):
        self.tokenizer = tokenizer
        self.max_length = max_length
        self._by_length: Dict[int, object] = {}
        self._lock = threading.Lock()

    def _truncating(self, max_length: int):
        """The backend tokenizer set to truncate at ``max_length``, unpadded."""
        with self._lock:
            t = self._by_length.get(max_length)
            if t is None:
                t = type(self.tokenizer).from_str(self.tokenizer.to_str())
                t.enable_truncation(max_length)
                t.no_padding()
                self._by_length[max_length] = t
        return t

    @classmethod
    def from_file(cls, path: str, max_length: int = 512) -> "HFTokenizer":
        from tokenizers import Tokenizer

        return cls(Tokenizer.from_file(path), max_length)

    @property
    def vocab_size(self) -> int:
        t = self.tokenizer
        return t.get_vocab_size() if hasattr(t, "get_vocab_size") else len(t)

    def encode_batch(
        self,
        texts: Sequence[str],
        max_length: Optional[int] = None,
        bucket: bool = True,
    ) -> Dict[str, np.ndarray]:
        max_length = min(max_length or self.max_length, self.max_length)
        t = self.tokenizer
        if hasattr(t, "encode_batch"):  # tokenizers.Tokenizer
            # Backend truncation (not a raw id slice): the post-processor
            # then keeps [SEP] as the final token like the transformers
            # branch below; no_padding() drops any padding config saved in
            # the tokenizer.json, whose pad ids a raw slice would hand to
            # the ones-mask loop as real tokens.
            encs = self._truncating(max_length).encode_batch(list(texts))
            seqs = [e.ids for e in encs]
        else:  # transformers tokenizer
            out = t(list(texts), truncation=True, max_length=max_length)
            seqs = out["input_ids"]
        longest = max((len(s) for s in seqs), default=1)
        width = pad_to_bucket(longest, max_length) if bucket else max_length
        input_ids = np.full((len(seqs), width), 0, dtype=np.int32)
        mask = np.zeros((len(seqs), width), dtype=np.int32)
        for i, s in enumerate(seqs):
            s = s[:width]
            input_ids[i, : len(s)] = s
            mask[i, : len(s)] = 1
        return {"input_ids": input_ids, "attention_mask": mask}
