"""Offline analysis of a dataset directory and its run files, the port's
counterparts of the repository's ``scripts/``; each runs as
``python -m mfar_tpu_torch.scripts.<name>``:

- ``find_failures``: queries whose gold lies outside the top k of a run but
  inside its list;
- ``compare_results``: queries where one of two runs hits in the top k and
  the other misses;
- ``corpus_stats``: per-field token-length percentiles of a corpus."""

from __future__ import annotations

from typing import Dict, List, Set

from mfar_tpu_torch.data import trec


def read_gold(data_path: str, partition: str) -> Dict[str, Set[str]]:
    """Each query's relevant doc ids from ``<partition>.qrels``."""
    gold: Dict[str, Set[str]] = {}
    for item in trec.QRels.from_file(f"{data_path}/{partition}.qrels"):
        gold.setdefault(item.query_id, set()).add(item.doc_id)
    return gold


def ranked_by_query(qres_path: str) -> Dict[str, List[str]]:
    """Each query's doc ids in a run file, ranked by sim, ties by doc id (as
    trec_eval ranks; the file's line order is not trusted)."""
    rows: Dict[str, list] = {}
    for item in trec.QRes.from_file(qres_path):
        rows.setdefault(item.query_id, []).append((-item.sim, item.doc_id))
    return {q: [d for _, d in sorted(r)] for q, r in rows.items()}
