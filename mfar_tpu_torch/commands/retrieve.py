"""Answer a query file with the PyTorch engine -> a TREC run file (+ metrics
when qrels are present), over dense fields, BM25 fields or both.

Counterpart of ``mfar_tpu/commands/retrieve.py`` on one device, with its
flag set (``--multihost force|pod`` and an explicit mesh: ROADMAP A15):

    python -m mfar_tpu_torch.commands.retrieve --dataset-name mag --data DIR \\
        --field-names all_dense,all_sparse --lexical-index IDX \\
        --out run.qres [--mode rerank] [--device cpu] [--model-name DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import time

from mfar_tpu_torch.commands.common import (
    add_data_args,
    add_engine_args,
    build_engine,
    normalize_argv,
)
from mfar_tpu_torch.data import trec


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    add_data_args(p)
    p.add_argument("--out", required=True, help="output qres path")
    p.add_argument("--partition", default="test")
    p.add_argument("--top-k", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=64)
    add_engine_args(p)
    p.add_argument("--multihost", default="auto", choices=["auto", "off", "force", "pod"],
                   help="force|pod: ROADMAP A15; auto and off run one process")
    args = p.parse_args(normalize_argv(argv))
    if args.multihost in ("force", "pod"):
        raise NotImplementedError(
            f"--multihost {args.multihost}: serving over several processes is ROADMAP A15")

    engine = build_engine(args, label="retrieve")
    queries = trec.read_queries(os.path.join(args.queries, f"{args.partition}.queries"))

    qids = list(queries)
    t0 = time.perf_counter()
    results = engine.retrieve_many(
        [queries[q] for q in qids], top_k=args.top_k, batch_size=args.batch_size
    )
    qres = engine.to_qres(qids, results)
    dt = time.perf_counter() - t0
    trec.write_qres(args.out, qres)
    print(f"{len(qids)} queries in {dt:.2f}s ({len(qids)/dt:.1f} q/s) on "
          f"{engine.device} [{engine.last_serve_path}] -> {args.out}")

    qrels_path = os.path.join(args.queries, f"{args.partition}.qrels")
    if os.path.exists(qrels_path):
        metrics = trec.call_trec_eval_and_get_metrics(qrels_path, args.out)
        keys = ["success_1", "recall_10", "recall_100", "ndcg_cut_10", "recip_rank", "map"]
        print(json.dumps({k: round(metrics.get(k, 0.0), 4) for k in keys}))


if __name__ == "__main__":
    main()
