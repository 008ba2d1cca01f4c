"""JSON sanitization helpers: the port's copy of ``mfar_tpu/utils/jsonutil.py``
(reference: mfar/data/util.py:62-75)."""

from __future__ import annotations

from typing import Any

import numpy as np


def remove_irregularities(obj: Any) -> Any:
    """Recursively make an object JSON-serializable and single-line safe:
    whitespace control characters in strings collapse to spaces (the corpus
    tsv format is one document per line), numpy bools become Python bools."""
    if isinstance(obj, str):
        return (
            obj.replace("\n", " ")
            .replace("\t", " ")
            .replace("\r", " ")
            .replace("\u001f", " ")
            .strip()
        )
    if isinstance(obj, list):
        return [remove_irregularities(x) for x in obj]
    if isinstance(obj, dict):
        return {k: remove_irregularities(v) for k, v in obj.items()}
    if isinstance(obj, (int, float, bool)) or obj is None:
        return obj
    if isinstance(obj, np.bool_):
        return obj.item()
    raise ValueError(f"Unexpected type {type(obj)}")
