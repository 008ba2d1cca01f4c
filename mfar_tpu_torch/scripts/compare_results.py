"""Diff two runs: queries where one run hits in the top k and the other
misses; prints the same text as ``scripts/compare_results.py``, gold ids in
ANSI emphasis:

    python -m mfar_tpu_torch.scripts.compare_results --data-path DS \\
        --partition val --res1 a.qres --res2 b.qres --k 10
"""

from __future__ import annotations

import argparse

from mfar_tpu_torch.data import trec
from mfar_tpu_torch.scripts import ranked_by_query, read_gold


def emph(s: str) -> str:
    return f"\033[94;4;1m{s}\033[0m"


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data-path", required=True)
    p.add_argument("--partition", required=True)
    p.add_argument("--res1", required=True)
    p.add_argument("--res2", required=True)
    p.add_argument("--k", type=int, required=True)
    args = p.parse_args(argv)

    queries = trec.read_queries(f"{args.data_path}/{args.partition}.queries")
    gold = read_gold(args.data_path, args.partition)
    pred1 = ranked_by_query(args.res1)
    pred2 = ranked_by_query(args.res2)

    for query_id, gold_set in gold.items():
        list1 = pred1.get(query_id, [])[: args.k]
        list2 = pred2.get(query_id, [])[: args.k]
        hit1 = bool(gold_set & set(list1))
        hit2 = bool(gold_set & set(list2))
        if hit1 != hit2:
            print(f"Query {query_id} has different results")
            print(f"Query: {queries.get(query_id, '<unknown>')}")
            print(f"Pred1: {', '.join(emph(x) if x in gold_set else x for x in list1)}")
            print(f"Pred2: {', '.join(emph(x) if x in gold_set else x for x in list2)}")


if __name__ == "__main__":
    main()
