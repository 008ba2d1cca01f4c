"""Online serving daemon: an HTTP front end and a micro-batching dispatcher.

Counterpart of ``mfar_tpu/serve.py`` (``MicroBatcher`` and
``RetrievalServer``) on one device; serving over several processes
(``MultihostEngineProxy``, ``follower_loop``) is ROADMAP A15.

- **Micro-batching**: concurrent requests are coalesced into one engine
  batch.  The first request opens a window of ``max_wait_ms``; the batch
  dispatches when ``max_batch`` queries wait or the window closes.  One
  scan of the corpus then serves the whole batch.
- **No padding**: the JAX daemon pads every batch to ``max_batch`` so that
  XLA compiles one program; the port runs eagerly and compiles nothing per
  shape, so a batch carries only its real queries.  ``/stats`` still counts
  ``padded`` (the room left in each batch) and ``mean_batch_fill`` against
  ``max_batch``, as the JAX daemon reports them.
- **Warm before the port opens**: :meth:`MicroBatcher.warmup` runs one full
  ``max_batch`` batch (and a batch of real queries): the kernels and the
  native BM25 library build at their first use, cuBLAS initialises, and
  the caching allocator takes the largest batch's blocks.  The listening
  socket is bound only after it (:meth:`RetrievalServer.bind`).
- **One thread touches the engine and the card**: the dispatcher.  HTTP
  handler threads only queue a request and wait on its event.  It
  pipelines: up to ``pipeline_depth`` batches are dispatched (host prep and
  the device work enqueued, ``RetrievalEngine.dispatch``) before the
  oldest is fetched (``finish``), and an idle queue drains the pipeline at
  once.

Endpoints:
  POST /retrieve  {"queries": [...], "top_k"?: int}  ->
                  {"results": [[[doc_key, score], ...], ...]}
  GET  /healthz   liveness and device
  GET  /stats     request and query counters, batch fill, latency percentiles
"""

from __future__ import annotations

import json
import queue
import socket
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

_IDLE = object()  # _collect(block=False): no request queued right now


class _Pending:
    __slots__ = ("queries", "top_k", "done", "results", "error", "t0")

    def __init__(self, queries: List[str], top_k: Optional[int]):
        self.queries = queries
        self.top_k = top_k
        self.done = threading.Event()
        self.results: Optional[List[List[Tuple[str, float]]]] = None
        self.error: Optional[str] = None
        self.t0 = time.perf_counter()


class MicroBatcher:
    """Coalesce concurrent retrieve requests into engine batches.

    ``top_k`` is the served depth; a request's own ``top_k`` (at most it) is
    sliced from the shared result.  Engines with the dispatch/finish split
    pipeline; others run each batch through ``retrieve``."""

    def __init__(
        self,
        engine,
        max_batch: int = 64,
        max_wait_ms: float = 5.0,
        top_k: int = 100,
        mode: Optional[str] = None,
        pipeline_depth: int = 2,
    ):
        self.engine = engine
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1000.0
        self.top_k = int(top_k)
        self.mode = mode
        self.pipeline_depth = max(int(pipeline_depth), 1)
        self._can_split = hasattr(engine, "dispatch") and hasattr(engine, "finish")
        self._q: "queue.Queue[Optional[_Pending]]" = queue.Queue()
        self._carry: Optional[_Pending] = None  # overflow from _collect
        self._lock = threading.Lock()
        self._stats = dict(requests=0, queries=0, batches=0, padded=0, errors=0)
        self._phase_s = dict(collect=0.0, dispatch=0.0, finish=0.0)
        self._latencies: List[float] = []  # the last 1000, seconds
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._started = False

    # -- client side -----------------------------------------------------

    def submit(
        self, queries: Sequence[str], top_k: Optional[int] = None, timeout: float = 120.0,
    ) -> List[List[Tuple[str, float]]]:
        """Block until the micro-batch holding these queries returns."""
        if len(queries) == 0:
            raise ValueError("queries must be a non-empty list")
        if top_k is not None:
            if not isinstance(top_k, int) or isinstance(top_k, bool) or top_k < 1:
                raise ValueError(f"top_k must be a positive int, got {top_k!r}")
            if top_k > self.top_k:
                raise ValueError(
                    f"per-request top_k {top_k} exceeds the served depth {self.top_k}")
        item = _Pending([str(q) for q in queries], top_k)
        self._q.put(item)
        if not item.done.wait(timeout):
            raise TimeoutError("retrieve timed out")
        if item.error is not None:
            raise RuntimeError(item.error)
        with self._lock:
            self._stats["requests"] += 1
            self._latencies.append(time.perf_counter() - item.t0)
            if len(self._latencies) > 1000:
                del self._latencies[:-1000]
        return item.results

    # -- dispatcher ------------------------------------------------------

    def start(self) -> "MicroBatcher":
        if not self._started:
            self._started = True
            self._thread.start()
        return self

    def stop(self) -> None:
        if self._started:
            self._q.put(None)
            self._thread.join(timeout=30)
            self._started = False

    def warmup(self, sample_queries: Optional[Sequence[str]] = None) -> float:
        """Run one full ``max_batch`` batch, then (when given) a batch of
        real queries, before traffic arrives; returns the seconds spent.
        Real queries reach the postings widths and candidate counts that
        traffic will bring."""
        t0 = time.perf_counter()
        self.engine.retrieve(["warmup"] * self.max_batch, top_k=self.top_k, mode=self.mode)
        if sample_queries is not None and len(sample_queries) > 0:
            sample = list(sample_queries)[: self.max_batch]
            sample += [sample[-1]] * (self.max_batch - len(sample))
            self.engine.retrieve(sample, top_k=self.top_k, mode=self.mode)
        return time.perf_counter() - t0

    def _collect(self, block: bool = True):
        """One micro-batch: wait for the first request (``block=False``
        returns ``_IDLE`` at once when none is queued), then drain until
        max_batch queries are assembled or the window closes.  None on
        shutdown.  A request that would push the batch past max_batch opens
        the next batch instead; only a single request larger than max_batch
        overflows, as the first item of its own batch."""
        first = self._carry
        if first is None:
            try:
                first = self._q.get(block=block)
            except queue.Empty:
                return _IDLE
        self._carry = None
        if first is None:
            return None
        batch, n = [first], len(first.queries)
        deadline = time.perf_counter() + self.max_wait_s
        while n < self.max_batch:
            left = deadline - time.perf_counter()
            if left <= 0:
                break
            try:
                nxt = self._q.get(timeout=left)
            except queue.Empty:
                break
            if nxt is None:
                self._q.put(None)  # deliver the shutdown after this batch
                break
            if n + len(nxt.queries) > self.max_batch:
                self._carry = nxt
                break
            batch.append(nxt)
            n += len(nxt.queries)
        return batch

    def _deliver(self, batch: List[_Pending], results) -> None:
        pos = 0
        for item in batch:
            sub = results[pos : pos + len(item.queries)]
            if item.top_k is not None:
                sub = [hits[: item.top_k] for hits in sub]
            item.results = sub
            pos += len(item.queries)
            item.done.set()

    def _fail(self, batch: List[_Pending], e: BaseException) -> None:
        with self._lock:
            self._stats["errors"] += 1
        for item in batch:
            item.error = f"{type(e).__name__}: {e}"
            item.done.set()

    def _count(self, real: int, t0: float) -> None:
        with self._lock:
            self._stats["batches"] += 1
            self._stats["queries"] += real
            self._stats["padded"] += max(self.max_batch - real, 0)
            self._phase_s["dispatch"] += time.perf_counter() - t0

    def _dispatch_batch(self, batch: List[_Pending]):
        """Host prep and the device work enqueued for one collected batch.
        Returns an in-flight (batch, handle) entry for _finish_batch, or
        None when the batch was handled here (an error, an oversized
        request through ``retrieve_many``, an engine without the split)."""
        texts: List[str] = []
        for item in batch:
            texts.extend(item.queries)
        real = len(texts)
        t0 = time.perf_counter()
        try:
            if real > self.max_batch:
                results = self.engine.retrieve_many(
                    texts, top_k=self.top_k, mode=self.mode, batch_size=self.max_batch)
            elif self._can_split:
                handle = self.engine.dispatch(texts, top_k=self.top_k, mode=self.mode)
                self._count(real, t0)
                return (batch, handle)
            else:
                results = self.engine.retrieve(texts, top_k=self.top_k, mode=self.mode)
        except Exception as e:  # noqa: BLE001 -- reported to every waiter
            self._fail(batch, e)
            return None
        self._count(real, t0)
        self._deliver(batch, results)
        return None

    def _finish_batch(self, entry) -> None:
        batch, handle = entry
        t0 = time.perf_counter()
        try:
            results = self.engine.finish(handle)
        except Exception as e:  # noqa: BLE001 -- reported to every waiter
            self._fail(batch, e)
            return
        with self._lock:
            self._phase_s["finish"] += time.perf_counter() - t0
        self._deliver(batch, results)

    def _run(self) -> None:
        # In-flight batches, oldest first; at most pipeline_depth of them.
        pending: List[Any] = []
        while True:
            t0 = time.perf_counter()
            # block for work only when nothing is in flight; otherwise
            # poll, and spend idle time finishing the oldest batch
            batch = self._collect(block=not pending)
            with self._lock:
                self._phase_s["collect"] += time.perf_counter() - t0
            if batch is None:  # shutdown: drain in-flight work first
                for entry in pending:
                    self._finish_batch(entry)
                return
            if batch is _IDLE:
                self._finish_batch(pending.pop(0))
                continue
            entry = self._dispatch_batch(batch)
            if entry is not None:
                pending.append(entry)
                if len(pending) >= self.pipeline_depth:
                    self._finish_batch(pending.pop(0))

    # -- introspection ---------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            out: Dict[str, Any] = dict(self._stats)
            lat = np.asarray(self._latencies, np.float64)
            # dispatcher-thread seconds per phase: collect = waiting for and
            # coalescing requests, dispatch = host prep + enqueued device
            # work, finish = waiting for device results + key mapping
            out["phase_s"] = {k: round(v, 2) for k, v in self._phase_s.items()}
        out["served_top_k"] = self.top_k
        out["max_batch"] = self.max_batch
        out["pipeline_depth"] = self.pipeline_depth if self._can_split else 1
        if out["queries"] + out["padded"] > 0:
            out["mean_batch_fill"] = round(out["queries"] / (out["queries"] + out["padded"]), 4)
        if lat.size:
            out["latency_ms_p50"] = round(float(np.percentile(lat, 50)) * 1000, 2)
            out["latency_ms_p95"] = round(float(np.percentile(lat, 95)) * 1000, 2)
        return out


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    # the listen backlog: socketserver's default of 5 resets connections
    # when a burst of clients connects at once (64 closed-loop clients do)
    request_queue_size = socket.SOMAXCONN

    def handle_error(self, request, client_address):
        etype = sys.exc_info()[0]
        if etype is not None and issubclass(etype, (BrokenPipeError, ConnectionResetError)):
            return  # the client went away: not an error
        super().handle_error(request, client_address)


class RetrievalServer:
    """ThreadingHTTPServer front end over a :class:`MicroBatcher`."""

    def __init__(
        self,
        engine,
        host: str = "127.0.0.1",
        port: int = 8080,
        max_batch: int = 64,
        max_wait_ms: float = 5.0,
        top_k: int = 100,
        mode: Optional[str] = None,
        pipeline_depth: int = 2,
    ):
        self.batcher = MicroBatcher(
            engine, max_batch=max_batch, max_wait_ms=max_wait_ms, top_k=top_k, mode=mode,
            pipeline_depth=pipeline_depth,
        )
        batcher = self.batcher
        started = time.time()

        class Handler(BaseHTTPRequestHandler):
            # HTTP/1.1 keep-alive: every response carries Content-Length, so
            # a closed-loop client keeps one connection and one server
            # thread for its lifetime
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *a):  # no per-request stderr lines
                pass

            def _send(self, code: int, payload: Dict[str, Any]) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._send(200, {
                        "status": "ok",
                        "uptime_s": round(time.time() - started, 1),
                        "backend": batcher.engine.device.type,
                        "n_devices": torch.cuda.device_count(),
                        "n_docs": batcher.engine.n_docs,
                    })
                elif self.path == "/stats":
                    self._send(200, batcher.stats())
                else:
                    self._send(404, {"error": f"unknown path {self.path}"})

            def do_POST(self):
                if self.path != "/retrieve":
                    self._send(404, {"error": f"unknown path {self.path}"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    queries = req["queries"]
                    if not isinstance(queries, list) or not queries:
                        raise ValueError("queries must be a non-empty list")
                    results = batcher.submit(queries, top_k=req.get("top_k"))
                except (ValueError, KeyError) as e:
                    self._send(400, {"error": str(e)})
                    return
                except Exception as e:  # noqa: BLE001 -- the engine's error, to the client
                    self._send(500, {"error": f"{type(e).__name__}: {e}"})
                    return
                self._send(200, {
                    "results": [[[k, float(s)] for k, s in hits] for hits in results],
                })

        # The socket is bound only after warmup (bind): a prober that saw
        # the port open during warmup would route traffic into the listen
        # backlog for the whole build of the kernels.
        self.httpd = _Server((host, port), Handler, bind_and_activate=False)
        self.host: Optional[str] = None
        self.port: Optional[int] = None
        self._serving = False  # the HTTP loop was started

    def bind(self) -> None:
        """Bind and activate the listening socket (idempotent)."""
        if self.port is None:
            self.httpd.server_bind()
            self.httpd.server_activate()
            self.host, self.port = self.httpd.server_address[:2]

    def warmup(self, sample_queries: Optional[Sequence[str]] = None) -> float:
        return self.batcher.warmup(sample_queries)

    def serve_forever(self) -> None:
        self.batcher.start()
        self.bind()
        self._serving = True
        try:
            self.httpd.serve_forever()
        finally:
            self.batcher.stop()

    def start_background(self) -> threading.Thread:
        """Serve on a daemon thread; binds the port, so ``host``/``port``
        are set when this returns."""
        self.batcher.start()
        self.bind()
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        t.start()
        self._serving = True
        return t

    def shutdown(self) -> None:
        if self._serving:  # httpd.shutdown() waits for a loop that was started
            self.httpd.shutdown()
        self.httpd.server_close()
        self.batcher.stop()
