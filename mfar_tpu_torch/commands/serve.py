"""Run the online retrieval daemon.

Counterpart of ``mfar_tpu/commands/serve.py``: it loads the same corpus,
model, checkpoint and indices as ``retrieve`` (the shared flag block), runs
a warmup batch, then answers HTTP traffic with micro-batched engine calls
(:mod:`mfar_tpu_torch.serve`).  Over several processes (one rank per card,
``--multihost pod`` under ``torchrun`` or ``force`` with the ``MFAR_*``
environment) rank 0 binds the port and broadcasts each batch, and the other
ranks follow it on the mesh.  On the card by default; ``--device cpu``
serves from the host:

    python -m mfar_tpu_torch.commands.serve --dataset-name mag --data DIR \\
        --model-name DIR --checkpoint-dir RUN --port 8080 --max-batch 256

``--smoke-out PATH`` runs the daemon once end to end: warmup, bind an
ephemeral port, POST the dataset's ``test.queries`` over HTTP, write
``{qids, results, stats}`` as JSON to PATH, shut down.
"""

from __future__ import annotations

import argparse
import glob
import http.client
import json
import os

from mfar_tpu_torch.commands.common import (
    add_data_args,
    add_engine_args,
    build_engine,
    normalize_argv,
)
from mfar_tpu_torch.data import trec
from mfar_tpu_torch.parallel import multihost
from mfar_tpu_torch.serve import MultihostEngineProxy, RetrievalServer, follower_loop


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    add_data_args(p)
    add_engine_args(p)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--top-k", type=int, default=100,
                   help="served depth; a request's top_k may be lower")
    p.add_argument("--max-batch", type=int, default=64,
                   help="the most queries one engine batch holds")
    p.add_argument("--max-wait-ms", type=float, default=5.0,
                   help="batching window opened by the first waiting request")
    p.add_argument("--pipeline-depth", type=int, default=2,
                   help="batches in flight at once: batch i+1's host prep and copies "
                        "overlap batch i's device work (1 = one at a time)")
    p.add_argument("--no-warmup", action="store_true",
                   help="open the port without a warmup batch (the first request then "
                        "pays the kernels' builds)")
    p.add_argument("--multihost", default="auto", choices=["auto", "off", "force", "pod"],
                   help="several processes, one per card: rank 0 owns the HTTP port and "
                        "broadcasts each batch; every other rank serves the same batch on "
                        "the mesh (see mfar_tpu_torch/serve.py MultihostEngineProxy)")
    p.add_argument("--smoke-out", default=None, metavar="PATH",
                   help="self-test: POST the dataset's test queries to the daemon over "
                        "HTTP, write the JSON results to PATH, then shut down")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(normalize_argv(argv))
    if multihost.maybe_initialize(args.multihost, args.device):
        print(f"[serve] multihost: process {multihost.process_index()}/"
              f"{multihost.process_count()}", flush=True)

    engine = build_engine(args, label="serve")
    proxy = None
    if multihost.is_multiprocess():
        if not multihost.is_primary():
            # every batch rank 0 broadcasts (its warmup included) until stop
            follower_loop(engine)
            print(f"[serve] follower {multihost.process_index()} done", flush=True)
            return
        engine = proxy = MultihostEngineProxy(engine, max_batch=args.max_batch)
    server = RetrievalServer(
        engine, host=args.host, port=args.port, max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms, top_k=args.top_k, mode=args.mode,
        pipeline_depth=args.pipeline_depth,
    )
    if not args.no_warmup:
        # real queries, where the dataset has any, reach the postings widths
        # and candidate counts that traffic brings
        sample = None
        for path in sorted(glob.glob(os.path.join(args.queries, "*.queries"))):
            qs = list(trec.read_queries(path).values())
            if qs:
                sample = qs[: args.max_batch]
                break
        dt = server.warmup(sample)
        print(f"[serve] warmup: {dt:.1f}s" + (" (with a real-query batch)" if sample else ""))
    server.bind()  # the port opens only now, after warmup
    print(f"[serve] listening on http://{server.host}:{server.port} "
          f"(max_batch={args.max_batch}, top_k={args.top_k}, n_docs={engine.n_docs}, "
          f"device={engine.device})", flush=True)

    if args.smoke_out:
        server.start_background()
        try:
            queries = trec.read_queries(os.path.join(args.queries, "test.queries"))
            conn = http.client.HTTPConnection(server.host, server.port, timeout=300)
            conn.request("POST", "/retrieve",
                         json.dumps({"queries": list(queries.values()), "top_k": args.top_k}),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            payload = json.loads(resp.read())
            if resp.status != 200:
                raise RuntimeError(f"/retrieve answered {resp.status}: {payload}")
            conn.request("GET", "/stats")
            stats = json.loads(conn.getresponse().read())
            conn.close()
            with open(args.smoke_out, "w") as f:
                json.dump({"qids": list(queries), "results": payload["results"],
                           "stats": stats}, f)
            print(f"[serve] smoke: {len(queries)} queries -> {args.smoke_out}", flush=True)
        finally:
            server.shutdown()
            if proxy is not None:
                proxy.stop()
        return

    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print("[serve] shutting down")
        server.shutdown()
    finally:
        if proxy is not None:
            proxy.stop()


if __name__ == "__main__":
    main()
