"""Answer a query file with the PyTorch engine -> a TREC run file (+ metrics
when qrels are present), over dense fields, BM25 fields or both.

Counterpart of ``mfar_tpu/commands/retrieve.py``, with its flag set:

    python -m mfar_tpu_torch.commands.retrieve --dataset-name mag --data DIR \\
        --field-names all_dense,all_sparse --lexical-index IDX \\
        --out run.qres [--mode rerank] [--device cpu] [--model-name DIR]

Over several cards, one rank per card serves on a mesh (``--mesh auto``)
and rank 0 writes the run file:

    torchrun --nproc-per-node 4 -m mfar_tpu_torch.commands.retrieve ... --multihost pod
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
from mfar_tpu_torch.parallel import multihost


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    add_data_args(p)
    p.add_argument("--out", required=True, help="output qres path")
    p.add_argument("--partition", default="test")
    p.add_argument("--top-k", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=64)
    add_engine_args(p)
    p.add_argument("--multihost", default="auto", choices=["auto", "off", "force", "pod"],
                   help="several processes, one per card (torch.distributed): auto and "
                        "force read MFAR_COORDINATOR/MFAR_NUM_PROCESSES/MFAR_PROCESS_ID "
                        "(force fails without them), pod reads torchrun's environment")
    args = p.parse_args(normalize_argv(argv))
    if multihost.maybe_initialize(args.multihost, args.device):
        print(f"[retrieve] multihost: process {multihost.process_index()}/"
              f"{multihost.process_count()}", flush=True)

    engine = build_engine(args, label="retrieve")
    queries = trec.read_queries(os.path.join(args.queries, f"{args.partition}.queries"))

    qids = list(queries)
    t0 = time.perf_counter()
    results = engine.retrieve_many(
        [queries[q] for q in qids], top_k=args.top_k, batch_size=args.batch_size
    )
    qres = engine.to_qres(qids, results)
    dt = time.perf_counter() - t0
    if multihost.is_primary():  # rank 0 owns file I/O
        trec.write_qres(args.out, qres)
        print(f"{len(qids)} queries in {dt:.2f}s ({len(qids)/dt:.1f} q/s) on "
              f"{engine.device} x {multihost.process_count()} [{engine.last_serve_path}] "
              f"-> {args.out}", flush=True)

        qrels_path = os.path.join(args.queries, f"{args.partition}.qrels")
        if os.path.exists(qrels_path):
            metrics = trec.call_trec_eval_and_get_metrics(qrels_path, args.out)
            keys = ["success_1", "recall_10", "recall_100", "ndcg_cut_10", "recip_rank", "map"]
            print(json.dumps({k: round(metrics.get(k, 0.0), 4) for k in keys}))
    multihost.sync("retrieve-done")


if __name__ == "__main__":
    main()
