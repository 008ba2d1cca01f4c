"""Corpus index construction: counterpart of ``mfar_tpu/eval/index_build.py``.

Per dense field, documents format and tokenize on the host into fixed-size
batches (padded to the full batch size and the field's token budget) and run
through the encoder on the device; the result is the ``[N, Fd, E]`` matrix
the engine serves, in host memory or streamed into a write target such as a
disk memmap.  An encoder with ``attention_impl="auto"`` runs the 512- and
128-token fields through kernel K2 on the card.  The on-disk format of
:func:`save_dense_matrix` / :func:`load_dense_matrix` is the JAX package's,
so either package reads the other's files.  Each sparse field gets a BM25
index over its formatted text (:func:`build_sparse_indices`).
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from mfar_tpu_torch.data.format import format_documents
from mfar_tpu_torch.data.schema import dense_keys, sparse_keys
from mfar_tpu_torch.data.types import Corpus, Field
from mfar_tpu_torch.sparse.bm25 import BM25Index
from mfar_tpu_torch.utils.device import DeviceLike, resolve_device


def make_encode_fn(encoder: torch.nn.Module, device: DeviceLike = None) -> Callable:
    """(input_ids, attention_mask) -> f32 [n, E] embeddings on ``device``.

    The encoder moves to the device once and runs eagerly in eval mode
    under ``torch.inference_mode``; inputs may be numpy arrays or tensors.
    ``device`` defaults to ``cuda`` and raises when there is no card."""
    dev = resolve_device(device)
    encoder = encoder.to(dev).eval()

    def encode(input_ids, attention_mask) -> torch.Tensor:
        with torch.inference_mode():
            ids = torch.as_tensor(input_ids, device=dev).long()
            mask = torch.as_tensor(attention_mask, device=dev)
            return encoder(ids, mask)

    return encode


def encode_texts(
    encode_fn: Callable,  # (input_ids, attention_mask) -> [n, E]
    tokenizer,
    texts: Sequence[str],
    max_length: int,
    batch_size: int = 256,
    out=None,  # optional [len(texts), E] write target (e.g. a row slice of
    #            a disk memmap): batches stream into it, so host memory
    #            stays O(window * batch) instead of O(corpus)
) -> np.ndarray:
    """Batched encoder forward over texts -> f32 ``[len(texts), E]`` (or
    ``out``, filled).  Every batch pads to the full ``batch_size`` and to
    ``max_length`` (``bucket=False``), as in the JAX package.  Batches
    dispatch asynchronously and come back to the host in a bounded window,
    so host tokenization overlaps device compute."""
    window = 8  # batches in flight
    pending: List[Tuple[torch.Tensor, int, int]] = []
    acc: List[np.ndarray] = []

    def drain(upto: int) -> None:
        while len(pending) > upto:
            embs, real, pos = pending.pop(0)
            rows = embs[:real].float().cpu().numpy()
            if out is not None:
                out[pos : pos + real] = rows
            else:
                acc.append(rows)

    for start in range(0, len(texts), batch_size):
        chunk = list(texts[start : start + batch_size])
        real = len(chunk)
        chunk += [""] * (batch_size - real)
        toks = tokenizer.encode_batch(chunk, max_length, bucket=False)
        pending.append((encode_fn(toks["input_ids"], toks["attention_mask"]), real, start))
        drain(window)
    drain(0)
    if out is not None:
        return out
    if not acc:
        return np.zeros((0, 0), np.float32)
    return np.concatenate(acc, axis=0)


def build_dense_corpus_matrix(
    encode_fn: Callable,
    tokenizer,
    corpus: Corpus,
    field_info: Dict[str, Field],
    batch_size: int = 256,
    prefix: bool = False,
    dtype=np.float32,
    out=None,  # optional [N, Fd, E] write target (e.g. np.lib.format.
    #            open_memmap): each field's batches stream into out[:, fi, :]
) -> np.ndarray:
    """[N, Fd, E] per-field corpus embeddings (dense fields, schema order),
    in ``dtype``, or ``out`` filled.  ``prefix`` puts the field's name in
    front of each text (``"title: ..."``), as the JAX package does."""
    pairs = list(corpus.pairs())
    mats = []
    for fi, fk in enumerate(dense_keys(field_info)):
        field = field_info[fk]
        texts = [t for _, t in format_documents(pairs, field.name, field.dataset)]
        if prefix:
            texts = [field.name.replace("___", " ") + ": " + t for t in texts]
        embs = encode_texts(
            encode_fn, tokenizer, texts, field.max_seq_length, batch_size,
            out=None if out is None else out[:, fi, :],
        )
        if out is None:
            mats.append(embs.astype(dtype))
    if out is not None:
        return out
    if not mats:
        return np.zeros((len(corpus), 0, 0), dtype)
    return np.stack(mats, axis=1)


def build_sparse_indices(corpus: Corpus, field_info: Dict[str, Field]) -> Dict[str, BM25Index]:
    """Per-sparse-field BM25 indices (reference: mfar/modeling/util.py:102-106)."""
    out: Dict[str, BM25Index] = {}
    pairs = list(corpus.pairs())
    for fk in sparse_keys(field_info):
        field = field_info[fk]
        out[fk] = BM25Index.create(format_documents(pairs, field.name, field.dataset),
                                   name=field.name)
    return out


def save_dense_matrix(path: str, matrix: np.ndarray, keys: Sequence[str]) -> str:
    """Write the matrix and its doc keys; returns the path written.  A
    ``.npy`` path writes the raw array plus a ``<path>.keys`` sidecar (one
    key per line, memory-mappable); any other path writes an ``.npz`` with
    ``matrix`` and ``keys`` (``.npz`` appended to a bare path)."""
    if path.endswith(".npy"):
        if not (isinstance(matrix, np.memmap)
                and getattr(matrix, "filename", None) == os.path.abspath(path)):
            np.save(path, matrix)
        elif hasattr(matrix, "flush"):
            matrix.flush()
        with open(path + ".keys", "w", encoding="utf-8") as f:
            f.write("\n".join(keys) + ("\n" if len(keys) else ""))
        return path
    if not path.endswith(".npz"):
        path = path + ".npz"
    np.savez(path, matrix=matrix, keys=np.asarray(list(keys), dtype=object))
    return path


def load_dense_matrix(path: str) -> Tuple[np.ndarray, List[str]]:
    if not os.path.exists(path):
        for ext in (".npz", ".npy"):  # tolerate the bare spelling
            if os.path.exists(path + ext):
                path = path + ext
                break
    if path.endswith(".npy"):
        matrix = np.load(path, mmap_mode="r")  # lazy: rows page in on access
        with open(path + ".keys", encoding="utf-8") as f:
            keys = f.read().splitlines()
        return matrix, keys
    data = np.load(path, allow_pickle=True)
    return data["matrix"], list(data["keys"])
