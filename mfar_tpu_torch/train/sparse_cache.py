"""Precomputed sparse-score cache I/O: the port's copy of
``mfar_tpu/train/sparse_cache.py``.

Artifact-compatible with the reference's precompute pipeline (reference:
mfar/commands/precompute_bm25s_scores.py:26-30, loaded by
mfar/modeling/util.py:112-173): per sparse field two .npy files --
``{field}_keys_bm25.npy`` int32 [n, 2] of (query_id, doc_row_id) pairs and
``{field}_vals_bm25.npy`` float16 scores -- expanded into nested
``{qid: {doc_id: score}}`` dicts.  The expansion here is a vectorized
numpy group-by instead of the reference's 64-thread dict-merge."""

from __future__ import annotations

import os
from typing import Dict, Iterable, Mapping, Tuple

import numpy as np

from mfar_tpu_torch.data.types import Field
from mfar_tpu_torch.data.schema import sparse_keys


def save_field_scores(
    out_dir: str,
    field_key: str,
    scores: Mapping[int, Mapping[int, float]],
) -> None:
    keys, vals = [], []
    for qid, per_doc in scores.items():
        if not per_doc:
            # Sentinel row: a query whose scores are ALL zero must still be
            # present after the round-trip (the trainer enables the cache
            # only when every batch qid is covered); doc_id -1 never
            # matches a real row and the loader drops it.
            keys.append((int(qid), -1))
            vals.append(0.0)
            continue
        for doc_id, score in per_doc.items():
            keys.append((int(qid), int(doc_id)))
            vals.append(score)
    os.makedirs(out_dir, exist_ok=True)
    np.save(
        os.path.join(out_dir, f"{field_key}_keys_bm25.npy"),
        np.asarray(keys, np.int32).reshape(-1, 2),
    )
    np.save(
        os.path.join(out_dir, f"{field_key}_vals_bm25.npy"),
        np.asarray(vals, np.float16),
    )


def load_field_scores(scores_dir: str, field_key: str) -> Dict[int, Dict[int, float]]:
    keys = np.load(os.path.join(scores_dir, f"{field_key}_keys_bm25.npy"))
    vals = np.load(os.path.join(scores_dir, f"{field_key}_vals_bm25.npy")).astype(np.float32)
    out: Dict[int, Dict[int, float]] = {}
    if keys.size == 0:
        return out
    # vectorized group-by query id
    order = np.argsort(keys[:, 0], kind="stable")
    keys, vals = keys[order], vals[order]
    qids, starts = np.unique(keys[:, 0], return_index=True)
    bounds = list(starts) + [len(keys)]
    for i, qid in enumerate(qids):
        lo, hi = bounds[i], bounds[i + 1]
        row = dict(zip(keys[lo:hi, 1].tolist(), vals[lo:hi].tolist()))
        row.pop(-1, None)  # empty-query sentinel (see save_field_scores)
        out[int(qid)] = row
    return out


def read_sparse_scores(
    scores_dir: str, field_info: Mapping[str, Field]
) -> Dict[str, Dict[int, Dict[int, float]]]:
    """{field_key: {qid: {doc_id: score}}} for every sparse field
    (reference: mfar/modeling/util.py:151-173)."""
    fields = sparse_keys(dict(field_info))
    if not fields:
        print("No sparse fields found")
    return {fk: load_field_scores(scores_dir, fk) for fk in fields}
