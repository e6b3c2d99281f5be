"""HTTP model serving over a save_inference_model export
(``paddle_tpu/serving/__init__.py``, the ``/predict`` path).

Endpoints:
  GET  /health   -> {"status": "ok", "feeds": [...], "fetches": [...],
                     "place": "...", "batching": {...}}
  POST /predict  -> body {"<feed>": nested-list, ...}
                 -> {"outputs": [nested-list per fetch]}

Status contract: 400 for a missing feed, an unknown payload key or a
malformed body; 503 past ``max_inflight`` requests in flight; 504 when
``request_timeout`` expires first; 404 for another path; 500 for any
other failure.  Requests coalesce into power-of-two buckets
(``batching.py``) and run on replica workers (``replica.py``) on
``CUDAPlace(0)`` unless ``place`` says otherwise.

Launch: ``python -m paddle_tpu_torch.serving --model_dir=DIR --port=N``.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from paddle_tpu_torch.serving.batching import (BatchSpec, PendingRequest,
                                               RequestQueue, bucket_ladder,
                                               next_bucket)
from paddle_tpu_torch.serving.replica import ModelBundle, Replica, ReplicaPool

__all__ = ["BatchSpec", "InferenceServer", "ModelBundle", "PendingRequest",
           "Replica", "ReplicaPool", "RequestQueue", "bucket_ladder",
           "next_bucket"]


class InferenceServer:
    def __init__(self, model_dir: str, port: int = 0,
                 request_timeout: float = None, max_inflight: int = None,
                 replicas: int = 1, max_batch: int = 8,
                 batch_timeout_ms: float = 0.0, warmup: bool = False,
                 place=None, host: str = "127.0.0.1"):
        self._bundle = ModelBundle(model_dir)
        self.feed_names = self._bundle.feed_names
        self._feed_set = frozenset(self.feed_names)
        if max_batch > 1:
            self._spec = self._bundle.batch_spec()
        else:
            self._spec = BatchSpec.disabled(
                "coalescing off (max_batch <= 1): every request runs at "
                "its exact feed shape")
        self._queue = RequestQueue(max_batch=max_batch,
                                   batch_timeout=batch_timeout_ms / 1000.0)
        self._pool = ReplicaPool(self._bundle, self._queue, self._spec,
                                 replicas=replicas, place=place)
        self.place = self._pool.replicas[0].exe.place
        self._request_timeout = request_timeout
        self._max_inflight = max_inflight
        self._slots = (threading.BoundedSemaphore(max_inflight)
                       if max_inflight else None)
        if warmup:
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
                        "fetches": server._bundle.fetch_names,
                        "place": repr(server.place),
                        "batching": server.batching_info()})
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
            "replicas": len(self._pool.replicas),
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
        return self._pool.warmup()

    def stop(self):
        self._httpd.shutdown()
        self._pool.stop()
        self._httpd.server_close()
