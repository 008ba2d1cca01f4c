"""Find queries whose relevant docs rank outside the top k but are found
deeper in the list; prints the same text as ``scripts/find_failures.py``:

    python -m mfar_tpu_torch.scripts.find_failures --data-path DS \\
        --partition val --qres-path run.qres --k 10
"""

from __future__ import annotations

import argparse

from mfar_tpu_torch.data import trec
from mfar_tpu_torch.scripts import ranked_by_query, read_gold


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data-path", required=True)
    p.add_argument("--partition", required=True)
    p.add_argument("--qres-path", required=True)
    p.add_argument("--k", type=int, required=True)
    args = p.parse_args(argv)

    queries = trec.read_queries(f"{args.data_path}/{args.partition}.queries")
    gold = read_gold(args.data_path, args.partition)
    pred = ranked_by_query(args.qres_path)

    for query_id, gold_set in gold.items():
        if query_id not in pred:
            print(f"Query {query_id} not found in predictions")
            continue
        ranked = pred[query_id]
        head, tail = set(ranked[: args.k]), set(ranked[args.k :])
        if not (gold_set & head) and (gold_set & tail):
            gold_ranks = sorted(
                (i, doc_id) for i, doc_id in enumerate(ranked) if doc_id in gold_set
            )
            print(f"QUERY: {queries.get(query_id, '<unknown>')}")
            print(f"Top {args.k} retrieved: {ranked[: args.k]}")
            print(f"Relevant documents: {gold_ranks}")
            print()


if __name__ == "__main__":
    main()
