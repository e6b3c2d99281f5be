"""HTTP serving: a save_inference_model export over ``/predict`` and a
paged-KV decode engine over ``/generate``
(``paddle_tpu/serving/__init__.py``).

Endpoints:
  GET  /health   -> {"status": "ok" | "degraded", "reasons": [...],
                     "self_healing": {"pool", "tenants", "queue"},
                     "feeds": [...], "fetches": [...], "place": "...",
                     "batching": {...}, "aot": store.info() + "boot"
                     or null,
                     "generation": engine.info() or null}
  GET  /metrics  -> Prometheus text exposition (0.0.4) of the telemetry
                     registry: the server's request histogram, in-flight
                     gauge and status counters, the queue's and the
                     pool's families, the executor's plan-cache and
                     step families
  GET  /stats    -> the same registry's snapshot as JSON
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
malformed body; 429 ``tenant_over_quota`` when the tenant's token bucket
is empty; 503 past ``max_inflight`` requests in flight, when the queue
sheds (``shed_low_weight``, ``queue_collapse``), when a request is
quarantined after ``max_attempts`` dispatches each of which lost its
replica (``retry_exhausted``), and for a generation request the session
refuses (with its ``reason``: ``too_long``, ``queue_full``,
``beam_too_wide``, ...); 504 when ``request_timeout`` expires first; 404
for another path; 500 for any other failure.  Every reply counts in
``serving_responses_total{code}``, every refusal in
``serving_rejected_total{reason, tenant}``.

Requests coalesce into power-of-two buckets (``batching.py``) and run on
supervised replica workers (``replica.py``) on ``CUDAPlace(0)`` unless
``place`` says otherwise; the generation engine runs on its model's
place.  Both endpoints take a tenant id (the ``"tenant"`` key or the
``X-Tenant`` header, else ``"default"``) and charge it one token of its
quota (``tenants``: ``"name:rate[:burst[:weight]],..."`` or a dict;
without one every tenant is unmetered).  ``chaos`` (``"KIND[@N[:rIDX]]"``
or a ``FaultInjector``) injects a replica fault; a spec string is armed
after warmup.  ``artifacts`` (a ``paddle compile`` directory) boots the
replicas from an AOT artifact store (``paddle_tpu_torch.aot``): each
replica's Executor builds its plans from the store's records, and the
store, attached process-wide while the server runs, supplies the kernel
libraries; any mismatch falls back loudly to plans built in process
(``aot_load_total{result=rejected_*}``), never to a wrong answer.

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
from paddle_tpu_torch.lod import LoDArray
from paddle_tpu_torch.observability import metrics as _metrics
from paddle_tpu_torch.observability.events import GLOBAL_EVENTS as _EVENTS
from paddle_tpu_torch.serving.batching import (DEFAULT_TENANT, BatchSpec,
                                               PendingRequest, QueueShed,
                                               RequestQueue, RetryExhausted,
                                               TenantOverQuota,
                                               TenantRegistry, bucket_ladder,
                                               next_bucket)
from paddle_tpu_torch.serving.replica import (FaultInjector, ModelBundle,
                                              Replica, ReplicaPool)

__all__ = ["BatchSpec", "FaultInjector", "InferenceServer", "ModelBundle",
           "PendingRequest", "QueueShed", "Replica", "ReplicaPool",
           "RequestQueue", "RetryExhausted", "TenantOverQuota",
           "TenantRegistry", "bucket_ladder", "next_bucket"]

_GENERATE_KEYS = frozenset({"src", "max_new_tokens", "stream", "beam",
                            "temperature", "top_k", "seed"})

_M_REQ_SEC = _metrics.histogram(
    "serving_request_seconds",
    "wall time per inference request, including executor dispatch")
_M_INFLIGHT = _metrics.gauge(
    "serving_inflight_requests", "requests currently being handled")
_M_RESPONSES = _metrics.counter(
    "serving_responses_total", "HTTP responses by status code")
_M_REJECTED = _metrics.counter(
    "serving_rejected_total",
    "requests shed for graceful degradation, by reason "
    "(overload -> 503, deadline -> 504, client_gone -> disconnect)")

#: The content type of a Prometheus 0.0.4 text scrape.
PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

def _jsonable(o):
    """A fetch value in JSON shape; a LoD output becomes {"data": ...,
    "lod": [...]} (packed rows and offset tables)."""
    if isinstance(o, LoDArray):
        return {"data": np.asarray(o.data).tolist(),
                "lod": [np.asarray(l).tolist() for l in o.lod]}
    return np.asarray(o).tolist()


def _tenant_of(headers) -> str:
    return (headers.get("X-Tenant") or DEFAULT_TENANT).strip() \
        or DEFAULT_TENANT


class InferenceServer:
    def __init__(self, model_dir: Optional[str], port: int = 0,
                 request_timeout: float = None, max_inflight: int = None,
                 replicas: int = 1, max_batch: int = 8,
                 batch_timeout_ms: float = 0.0, warmup: bool = False,
                 place=None, host: str = "127.0.0.1", generator=None,
                 tenants=None, max_attempts: int = 3,
                 replica_heartbeat_ms: float = 1000.0,
                 dispatch_timeout: float = None, chaos=None,
                 shed_watermark: int = None, artifacts: str = None):
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
                "generation-only server (no model_dir export loaded)",
                code="generation_only")
        elif max_batch > 1:
            self._spec = self._bundle.batch_spec()
        else:
            self._spec = BatchSpec.disabled(
                "coalescing off (max_batch <= 1): every request runs at "
                "its exact feed shape", code="coalescing_off")
        if isinstance(tenants, str):
            tenants = TenantRegistry.parse(tenants)
        elif isinstance(tenants, dict):
            tenants = TenantRegistry(tenants)
        self._tenants = tenants if tenants is not None else TenantRegistry()
        if shed_watermark is None:
            # deep enough that normal bursts never shed, shallow enough
            # that a collapsing pool refuses instead of queueing forever
            shed_watermark = max(64, 8 * max_batch)
        self.fault = (FaultInjector.from_spec(chaos)
                      if isinstance(chaos, str) else chaos)
        self._artifact_store = None
        self._aot_attached = False
        if artifacts:
            # `paddle compile` output: replicas consult the store before
            # building a plan; attached process-wide as well, since the
            # kernel libraries load once a process
            from paddle_tpu_torch import aot as _aot

            self._artifact_store = _aot.ArtifactStore(artifacts, place=place)
            _aot.attach(self._artifact_store)
            self._aot_attached = True
        self._queue = RequestQueue(max_batch=max_batch,
                                   batch_timeout=batch_timeout_ms / 1000.0,
                                   tenants=self._tenants,
                                   shed_watermark=shed_watermark)
        self._pool = (ReplicaPool(self._bundle, self._queue, self._spec,
                                  replicas=replicas, place=place,
                                  fault=self.fault,
                                  max_attempts=max_attempts,
                                  heartbeat=replica_heartbeat_ms / 1000.0,
                                  dispatch_timeout=dispatch_timeout,
                                  artifact_store=self._artifact_store)
                      if self._bundle else None)
        self.place = (self._pool.replicas[0].exe.place if self._pool
                      else generator.model.place)
        self._request_timeout = request_timeout
        self._max_inflight = max_inflight
        self._slots = (threading.BoundedSemaphore(max_inflight)
                       if max_inflight else None)
        if warmup and self._pool is not None:
            self._pool.warmup()
        if isinstance(chaos, str) and self.fault is not None:
            # a spec string is the operator's path (--chaos=die@1): nobody
            # else can arm it, so arm it now, after warmup, so the nth
            # dispatch counts live traffic
            self.fault.arm()

        server = self

        class Handler(BaseHTTPRequestHandler):
            # keep-alive: one TCP connection per client (we always send
            # Content-Length)
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet
                pass

            def _reply(self, code, obj, ctype="application/json",
                       raw=None):
                body = raw if raw is not None else json.dumps(obj).encode()
                _M_RESPONSES.inc(code=str(code))
                try:
                    self.send_response(code)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                except (BrokenPipeError, ConnectionResetError):
                    _M_REJECTED.inc(reason="client_gone")
                    self.close_connection = True

            def do_GET(self):
                if self.path == "/health":
                    reasons = server.degraded_reasons()
                    self._reply(200, {
                        "status": "degraded" if reasons else "ok",
                        "reasons": reasons,
                        "self_healing": server.self_healing_info(),
                        "feeds": server.feed_names,
                        "fetches": (server._bundle.fetch_names
                                    if server._bundle else []),
                        "place": repr(server.place),
                        "batching": server.batching_info(),
                        "aot": server.aot_info(),
                        "generation": (server._generator.info()
                                       if server._generator else None)})
                elif self.path == "/metrics":
                    self._reply(200, None, ctype=PROMETHEUS_CONTENT_TYPE,
                                raw=_metrics.render_prometheus().encode())
                elif self.path == "/stats":
                    self._reply(200, _metrics.snapshot())
                else:
                    self._reply(404, {"error": "unknown path"})

            def do_POST(self):
                # always consume the body first: on keep-alive an unread
                # body would be parsed as the next request line
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    raw_body = self.rfile.read(n)
                except (BrokenPipeError, ConnectionResetError):
                    _M_REJECTED.inc(reason="client_gone")
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
                    _M_REJECTED.inc(reason="overload")
                    self._reply(503, {"error": "server overloaded "
                                      f"(max_inflight={server._max_inflight})"})
                    return
                _M_INFLIGHT.inc()
                ev_t0 = _EVENTS.now()
                t0 = time.perf_counter()
                tenant = _tenant_of(self.headers)
                try:
                    payload = json.loads(raw_body or b"{}")
                    if not isinstance(payload, dict):
                        raise ValueError("request body must be a JSON object")
                    if "tenant" in payload:
                        tenant = str(payload.pop("tenant")) or tenant
                    deadline = (time.monotonic() + server._request_timeout
                                if server._request_timeout else None)
                    outs = server.predict(payload, deadline=deadline,
                                          tenant=tenant)
                    self._reply(200, {"outputs": [_jsonable(o)
                                                  for o in outs]})
                except TenantOverQuota as e:
                    _M_REJECTED.inc(reason="tenant_over_quota",
                                    tenant=e.tenant)
                    self._reply(429, {"error": str(e),
                                      "reason": "tenant_over_quota",
                                      "tenant": e.tenant})
                except QueueShed as e:
                    _M_REJECTED.inc(reason=e.reason, tenant=tenant)
                    self._reply(503, {"error": str(e), "reason": e.reason})
                except RetryExhausted as e:
                    _M_REJECTED.inc(reason="retry_exhausted", tenant=tenant)
                    self._reply(503, {"error": str(e),
                                      "reason": "retry_exhausted"})
                except TimeoutError as e:
                    _M_REJECTED.inc(reason="deadline")
                    self._reply(504, {"error": str(e)})
                except (BrokenPipeError, ConnectionResetError):
                    _M_REJECTED.inc(reason="client_gone")
                    self.close_connection = True
                except (KeyError, ValueError, TypeError) as e:
                    self._reply(400, {"error": str(e)})
                except Exception as e:  # surface, don't kill the server
                    self._reply(500, {"error": f"{type(e).__name__}: {e}"})
                finally:
                    dt = time.perf_counter() - t0
                    _M_INFLIGHT.dec()
                    if server._slots is not None:
                        server._slots.release()
                    _M_REQ_SEC.observe(dt, endpoint="/predict")
                    _EVENTS.complete("serving.predict", ev_t0, dt,
                                     cat="serving")

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
                _M_INFLIGHT.inc()
                ev_t0 = _EVENTS.now()
                t0 = time.perf_counter()
                tenant = _tenant_of(self.headers)
                try:
                    payload = json.loads(raw_body or b"{}")
                    if not isinstance(payload, dict):
                        raise ValueError(
                            "request body must be a JSON object")
                    if "tenant" in payload:
                        tenant = str(payload.pop("tenant")) or tenant
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
                    # the same token buckets as /predict: a generation
                    # call spends one admission token of its tenant
                    server._tenants.admit(tenant)
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
                except TenantOverQuota as e:
                    _M_REJECTED.inc(reason="tenant_over_quota",
                                    tenant=e.tenant)
                    self._reply(429, {"error": str(e),
                                      "reason": "tenant_over_quota",
                                      "tenant": e.tenant})
                except AdmissionRefused as e:
                    _M_REJECTED.inc(reason=e.reason)
                    self._reply(503, {"error": str(e),
                                      "reason": e.reason})
                except TimeoutError as e:
                    _M_REJECTED.inc(reason="deadline")
                    self._reply(504, {"error": str(e)})
                except (BrokenPipeError, ConnectionResetError):
                    _M_REJECTED.inc(reason="client_gone")
                    self.close_connection = True
                except (KeyError, ValueError, TypeError) as e:
                    self._reply(400, {"error": str(e)})
                except Exception as e:  # surface, don't kill the server
                    self._reply(500, {"error": f"{type(e).__name__}: {e}"})
                finally:
                    dt = time.perf_counter() - t0
                    _M_INFLIGHT.dec()
                    _M_REQ_SEC.observe(dt, endpoint="/generate")
                    _EVENTS.complete("serving.generate", ev_t0, dt,
                                     cat="serving")

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
                _M_RESPONSES.inc(code="200")
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
                    _M_REJECTED.inc(reason="client_gone")
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

    def degraded_reasons(self) -> list:
        """Why /health says ``degraded`` (empty = healthy): replicas
        down, the restart budget spent, load shedding."""
        reasons = []
        if self._pool is not None:
            reasons.extend(self._pool.degraded_reasons())
        deg = self._queue.degradation()
        if deg.get("shedding"):
            reasons.append(f"load_shedding:{deg['shedding']}")
        return reasons

    def self_healing_info(self) -> dict:
        return {
            "pool": self._pool.info() if self._pool else None,
            "tenants": self._tenants.info(),
            "queue": self._queue.degradation(),
        }

    def aot_info(self) -> Optional[dict]:
        """The artifact store's state for /health: its root, poison
        reason, entry count and per-outcome lookup results, and the pool's
        boot source; None without ``artifacts``."""
        if self._artifact_store is None:
            return None
        info = self._artifact_store.info()
        info["boot"] = (self._pool.boot_source()
                        if self._pool is not None else None)
        return info

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

    def predict(self, payload: dict, deadline: float = None,
                tenant: str = DEFAULT_TENANT):
        """Run one request through the batching engine.  ``deadline`` (a
        ``time.monotonic`` timestamp) bounds the whole wait; an expired
        request raises TimeoutError (504 over HTTP).  ``tenant`` selects
        the admission token bucket and fair-queue weight
        (``TenantOverQuota`` / ``QueueShed`` raised here)."""
        if self._bundle is None:
            raise ValueError("this server mounts no inference export "
                             "(generation-only; POST /generate instead)")
        feed = self._build_feeds(payload)
        info = self._spec.classify(feed)
        if info is None:
            # a model that cannot batch carries its BatchSpec code; a
            # batchable model whose request shapes did not fit is a
            # per-request miss
            reason = (self._spec.code if not self._spec.batchable
                      else "shape_mismatch")
            req = PendingRequest(feed, rows=1, batchable=False,
                                 deadline=deadline, solo_reason=reason,
                                 tenant=tenant)
        else:
            rows, cast = info
            req = PendingRequest(cast, rows=rows, batchable=True,
                                 deadline=deadline, tenant=tenant)
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

    def pause(self):
        """Stop replicas taking new batches (drain, maintenance); queued
        requests wait and expire against their deadlines."""
        if self._pool:
            self._pool.pause()

    def resume(self):
        if self._pool:
            self._pool.resume()

    def stop(self):
        self._httpd.shutdown()
        if self._pool:
            self._pool.stop()
        if self._generator is not None:
            self._generator.stop()
        if self._aot_attached:
            from paddle_tpu_torch import aot as _aot

            if _aot.active_store() is self._artifact_store:
                _aot.detach()
            self._aot_attached = False
        self._httpd.server_close()
