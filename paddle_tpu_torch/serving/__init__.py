"""HTTP serving: a save_inference_model export over ``/predict`` and a
paged-KV decode engine over ``/generate``
(``paddle_tpu/serving/__init__.py``).

Endpoints:
  GET  /health   -> {"status": "ok", "feeds": [...], "fetches": [...],
                     "place": "...", "batching": {...},
                     "generation": engine.info() or null}
  POST /predict  -> body {"<feed>": nested-list, ...}
                 -> {"outputs": [nested-list per fetch]}
  POST /generate -> body {"src": [int ids], "max_new_tokens": N,
                     "stream": bool, "beam": k, "temperature": t,
                     "top_k": k, "seed": s} against a
                     ``decode.GenerationEngine``.  With ``stream``
                     (default true) the reply is chunked ndjson: one
                     ``{"token": t}`` line per generated token as the
                     continuous-batching session emits it, then
                     ``{"done": true, "ids": [...], "finish_reason":
                     ...}``; without it, one JSON object after
                     generation finishes.  ``beam`` replies non-streamed
                     with ``"beams"`` best-first; ``temperature`` /
                     ``top_k`` / ``seed`` switch the slot to seeded
                     sampling.  A streaming client that goes away
                     cancels its slot.

Status contract: 400 for a missing feed, an unknown payload key or a
malformed body; 503 past ``max_inflight`` requests in flight, and for a
generation request the session refuses (with its ``reason``:
``too_long``, ``queue_full``, ``beam_too_wide``, ...); 504 when
``request_timeout`` expires first; 404 for another path; 500 for any
other failure.  Requests coalesce into power-of-two buckets
(``batching.py``) and run on replica workers (``replica.py``) on
``CUDAPlace(0)`` unless ``place`` says otherwise; the generation engine
runs on its model's place.  Both endpoints take a tenant id (the
``"tenant"`` key or the ``X-Tenant`` header) and admit every request, as
the reference does without a ``--tenants`` spec; quotas, ``/metrics``
and ``/stats`` are not ported yet.

Launch: ``python -m paddle_tpu_torch.serving --model_dir=DIR --port=N``,
or ``--gen_config=SCRIPT`` for ``/generate``.
"""

from __future__ import annotations

import json
import queue as queue_mod
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from paddle_tpu_torch.decode.session import AdmissionRefused
from paddle_tpu_torch.serving.batching import (BatchSpec, PendingRequest,
                                               RequestQueue, bucket_ladder,
                                               next_bucket)
from paddle_tpu_torch.serving.replica import ModelBundle, Replica, ReplicaPool

_GENERATE_KEYS = frozenset({"src", "max_new_tokens", "stream", "beam",
                            "temperature", "top_k", "seed"})



def _drop_tenant(payload: dict) -> None:
    """Take the ``"tenant"`` key out of a request body.  The reference
    admits a request under its tenant's quota (this key, or the
    ``X-Tenant`` header), and without a ``--tenants`` spec every tenant
    is unmetered; quotas are not ported, so every request is admitted."""
    payload.pop("tenant", None)


__all__ = ["BatchSpec", "InferenceServer", "ModelBundle", "PendingRequest",
           "Replica", "ReplicaPool", "RequestQueue", "bucket_ladder",
           "next_bucket"]


class InferenceServer:
    def __init__(self, model_dir: Optional[str], port: int = 0,
                 request_timeout: float = None, max_inflight: int = None,
                 replicas: int = 1, max_batch: int = 8,
                 batch_timeout_ms: float = 0.0, warmup: bool = False,
                 place=None, host: str = "127.0.0.1", generator=None):
        if model_dir is None and generator is None:
            raise ValueError("need a model_dir to predict from and/or a "
                             "generator (paddle_tpu_torch.decode."
                             "GenerationEngine) to generate with")
        self._generator = generator
        self._bundle = ModelBundle(model_dir) if model_dir else None
        self.feed_names = self._bundle.feed_names if self._bundle else []
        self._feed_set = frozenset(self.feed_names)
        if self._bundle is None:
            self._spec = BatchSpec.disabled(
                "generation-only server (no model_dir export loaded)")
        elif max_batch > 1:
            self._spec = self._bundle.batch_spec()
        else:
            self._spec = BatchSpec.disabled(
                "coalescing off (max_batch <= 1): every request runs at "
                "its exact feed shape")
        self._queue = RequestQueue(max_batch=max_batch,
                                   batch_timeout=batch_timeout_ms / 1000.0)
        self._pool = (ReplicaPool(self._bundle, self._queue, self._spec,
                                  replicas=replicas, place=place)
                      if self._bundle else None)
        self.place = (self._pool.replicas[0].exe.place if self._pool
                      else generator.model.place)
        self._request_timeout = request_timeout
        self._max_inflight = max_inflight
        self._slots = (threading.BoundedSemaphore(max_inflight)
                       if max_inflight else None)
        if warmup and self._pool is not None:
            self._pool.warmup()

        server = self

        class Handler(BaseHTTPRequestHandler):
            # keep-alive: one TCP connection per client (we always send
            # Content-Length)
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet
                pass

            def _reply(self, code, obj):
                body = json.dumps(obj).encode()
                try:
                    self.send_response(code)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                except (BrokenPipeError, ConnectionResetError):
                    self.close_connection = True

            def do_GET(self):
                if self.path == "/health":
                    self._reply(200, {
                        "status": "ok",
                        "feeds": server.feed_names,
                        "fetches": (server._bundle.fetch_names
                                    if server._bundle else []),
                        "place": repr(server.place),
                        "batching": server.batching_info(),
                        "generation": (server._generator.info()
                                       if server._generator else None)})
                else:
                    self._reply(404, {"error": "unknown path"})

            def do_POST(self):
                # always consume the body first: on keep-alive an unread
                # body would be parsed as the next request line
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    raw_body = self.rfile.read(n)
                except (BrokenPipeError, ConnectionResetError):
                    self.close_connection = True
                    return
                if self.path == "/generate":
                    self._handle_generate(raw_body)
                    return
                if self.path != "/predict":
                    self._reply(404, {"error": "unknown path"})
                    return
                if server._slots is not None and \
                        not server._slots.acquire(blocking=False):
                    self._reply(503, {"error": "server overloaded "
                                      f"(max_inflight={server._max_inflight})"})
                    return
                try:
                    payload = json.loads(raw_body or b"{}")
                    if not isinstance(payload, dict):
                        raise ValueError("request body must be a JSON object")
                    _drop_tenant(payload)
                    deadline = (time.monotonic() + server._request_timeout
                                if server._request_timeout else None)
                    outs = server.predict(payload, deadline=deadline)
                    self._reply(200, {"outputs": [np.asarray(o).tolist()
                                                  for o in outs]})
                except TimeoutError as e:
                    self._reply(504, {"error": str(e)})
                except (BrokenPipeError, ConnectionResetError):
                    self.close_connection = True
                except (KeyError, ValueError, TypeError) as e:
                    self._reply(400, {"error": str(e)})
                except Exception as e:  # surface, don't kill the server
                    self._reply(500, {"error": f"{type(e).__name__}: {e}"})
                finally:
                    if server._slots is not None:
                        server._slots.release()

            # -- generation (paged-KV decode engine) ---------------------

            def _chunk(self, obj) -> None:
                data = json.dumps(obj).encode() + b"\n"
                self.wfile.write(f"{len(data):X}\r\n".encode()
                                 + data + b"\r\n")

            def _handle_generate(self, raw_body: bytes) -> None:
                if server._generator is None:
                    self._reply(400, {"error": "no generation engine "
                                      "mounted (serve with --gen_config)"})
                    return
                try:
                    payload = json.loads(raw_body or b"{}")
                    if not isinstance(payload, dict):
                        raise ValueError(
                            "request body must be a JSON object")
                    _drop_tenant(payload)
                    src = payload.get("src")
                    if (not isinstance(src, list) or not src
                            or not all(isinstance(t, int) for t in src)):
                        raise ValueError(
                            "'src' must be a non-empty list of int ids")
                    unknown = set(payload) - _GENERATE_KEYS
                    if unknown:
                        raise ValueError(
                            f"unknown payload key {sorted(unknown)[0]!r}; "
                            "expected src / max_new_tokens / stream / "
                            "beam / temperature / top_k / seed / tenant")
                    budget = payload.get("max_new_tokens")
                    beam = payload.get("beam")
                    deadline = (time.monotonic() + server._request_timeout
                                if server._request_timeout else None)
                    # grace past the deadline: the session itself
                    # expires the request and reports it
                    timeout = (None if deadline is None else
                               max(0.0, deadline - time.monotonic())
                               + 30.0)
                    if beam is not None:
                        if (not isinstance(beam, int) or beam < 1
                                or isinstance(beam, bool)):
                            raise ValueError(
                                "'beam' must be a positive int")
                        req = server._generator.submit_beam(
                            src, beam_size=beam,
                            max_new_tokens=budget, deadline=deadline)
                        ids = req.result(timeout)
                        self._reply(200, {
                            "ids": ids,
                            "beams": [{"score": s, "ids": t}
                                      for s, t in (req.beams or [])],
                            "finish_reason": req.finish_reason})
                    elif payload.get("stream", True):
                        self._stream_generate(src, budget, deadline,
                                              payload)
                    else:
                        req = server._generator.submit(
                            src, budget, deadline=deadline,
                            temperature=payload.get("temperature"),
                            top_k=payload.get("top_k"),
                            seed=payload.get("seed"))
                        ids = req.result(timeout)
                        self._reply(200, {
                            "ids": ids,
                            "finish_reason": req.finish_reason})
                except AdmissionRefused as e:
                    self._reply(503, {"error": str(e),
                                      "reason": e.reason})
                except TimeoutError as e:
                    self._reply(504, {"error": str(e)})
                except (BrokenPipeError, ConnectionResetError):
                    self.close_connection = True
                except (KeyError, ValueError, TypeError) as e:
                    self._reply(400, {"error": str(e)})
                except Exception as e:  # surface, don't kill the server
                    self._reply(500, {"error": f"{type(e).__name__}: {e}"})

            def _stream_generate(self, src, budget, deadline,
                                 payload) -> None:
                """Chunked ndjson: one line per token as the decode
                session emits it, then the summary line.  Admission
                refusals (503) and pre-stream deadline expiry (504)
                raise BEFORE any header is written; once tokens are
                flowing, a mid-stream expiry rides the final line as
                ``finish_reason: "deadline"``."""
                q: queue_mod.Queue = queue_mod.Queue()
                req = server._generator.submit(
                    src, budget, on_token=q.put, deadline=deadline,
                    temperature=payload.get("temperature"),
                    top_k=payload.get("top_k"),
                    seed=payload.get("seed"))
                if deadline is not None:
                    # hold the 200 until the stream starts: a request
                    # that dies of its deadline before its first token
                    # is a 504, not a 200 that trickles out an error
                    while (req.first_token_at is None
                           and not req.wait(0.01)):
                        pass
                    if req.first_token_at is None and req.error is not None:
                        raise req.error
                try:
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "application/x-ndjson")
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()
                    while True:
                        try:
                            self._chunk({"token": q.get(timeout=0.05)})
                        except queue_mod.Empty:
                            if req.done and q.empty():
                                break
                    final = {"done": True, "ids": req.tokens,
                             "finish_reason": req.finish_reason}
                    if req.error is not None:
                        final["error"] = str(req.error)
                    self._chunk(final)
                    self.wfile.write(b"0\r\n\r\n")
                except (BrokenPipeError, ConnectionResetError):
                    # the consumer left: cancel the decode slot so its
                    # pages free now instead of generating the rest of
                    # the sequence into a dead socket
                    server._generator.cancel(req)
                    self.close_connection = True

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    @property
    def address(self):
        host, port = self._httpd.server_address[:2]
        return f"{host}:{port}"

    @property
    def port(self):
        return self._httpd.server_address[1]

    def batching_info(self) -> dict:
        return {
            "enabled": self._spec.batchable,
            "reason": self._spec.reason,
            "replicas": len(self._pool.replicas) if self._pool else 0,
            "max_batch": self._queue.max_batch,
            "batch_timeout_ms": self._queue.batch_timeout * 1000.0,
            "buckets": (list(bucket_ladder(self._queue.max_batch))
                        if self._spec.batchable else []),
        }

    def _build_feeds(self, payload: dict) -> dict:
        for name in self.feed_names:
            if name not in payload:
                raise KeyError(f"missing feed {name!r}")
        feed = {}
        for k, v in payload.items():
            if k not in self._feed_set:
                # a mis-keyed request must not silently drop data
                raise ValueError(f"unknown payload key {k!r}; expected "
                                 f"feeds {sorted(self._feed_set)}")
            feed[k] = np.asarray(v)
        return feed

    def predict(self, payload: dict, deadline: float = None):
        """Run one request through the batching engine.  ``deadline`` (a
        ``time.monotonic`` timestamp) bounds the whole wait; an expired
        request raises TimeoutError (504 over HTTP)."""
        if self._bundle is None:
            raise ValueError("this server mounts no inference export "
                             "(generation-only; POST /generate instead)")
        feed = self._build_feeds(payload)
        info = self._spec.classify(feed)
        if info is None:
            req = PendingRequest(feed, rows=1, batchable=False,
                                 deadline=deadline)
        else:
            rows, cast = info
            req = PendingRequest(cast, rows=rows, batchable=True,
                                 deadline=deadline)
        self._queue.submit(req)
        timeout = None
        if deadline is not None:
            timeout = max(0.0, deadline - time.monotonic())
        if not req.wait(timeout):
            req.abandoned = True
            raise TimeoutError(
                "request deadline expired waiting for a serving replica")
        if req.error is not None:
            raise req.error
        return list(req.outputs)

    def warmup(self) -> int:
        """Run the bucket ladder once on every replica."""
        return self._pool.warmup() if self._pool else 0

    def stop(self):
        self._httpd.shutdown()
        if self._pool:
            self._pool.stop()
        if self._generator is not None:
            self._generator.stop()
        self._httpd.server_close()
