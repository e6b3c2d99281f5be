"""Runtime telemetry: metrics registry, host events, Chrome-trace export
(``paddle_tpu/observability/__init__.py``).

- ``metrics``: typed counters, gauges and histograms with labels.  The
  Executor, the InferenceServer, its queue and replica pool and the
  decode engine update the process-global ``REGISTRY`` on every plan
  build, step and request.  The server exposes it as Prometheus text on
  ``GET /metrics`` and as JSON on ``GET /stats``.
- ``events``: a bounded host-side event ring exporting Chrome-trace
  JSON (``executor.compile``, ``executor.step``, ``serving.predict``,
  ``serving.generate``).
- op names on the device timeline: ``FLAGS.trace_ops`` runs each op
  inside ``torch.profiler.record_function(op.type)`` (executor.py).

``reset()`` clears recorded values; registered families survive, so
module-level handles stay valid.
"""

from __future__ import annotations

import time

from paddle_tpu_torch.observability.metrics import (  # noqa: F401
    COMPILE_TIME_BUCKETS,
    DEFAULT_LATENCY_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    REGISTRY,
    counter,
    format_snapshot,
    format_table,
    gauge,
    histogram,
    render_prometheus,
    snapshot,
)
from paddle_tpu_torch.observability.events import (  # noqa: F401
    EventRecorder,
    GLOBAL_EVENTS,
)


def reset():
    """Clear all recorded metric values and host events."""
    REGISTRY.reset()
    GLOBAL_EVENTS.clear()


def export_chrome_trace(path: str) -> str:
    """Dump the global host-event ring as Chrome-trace JSON."""
    return GLOBAL_EVENTS.export(path)


def measure_step_overhead(iters: int = 2000) -> float:
    """Average wall cost (seconds) of the telemetry writes Executor.run
    adds to one cached step: the cache-hit counter, the feed and step
    histogram observes, the fetch-bytes counter and one host event.

    Runs against a private registry and recorder, so measuring does not
    touch live metrics.
    """
    reg = MetricsRegistry()
    hits = reg.counter("overhead_probe_hits_total")
    fetched = reg.counter("overhead_probe_bytes_total")
    steps = reg.histogram("overhead_probe_seconds")
    ev = EventRecorder(max_events=16)
    t0 = time.perf_counter()
    for _ in range(iters):
        t = ev.now()
        hits.inc(program="fingerprint0")
        steps.observe(1e-4, program="fingerprint0", stage="feed")
        steps.observe(1e-3, program="fingerprint0", cached="hit")
        fetched.inc(4096, program="fingerprint0")
        ev.complete("executor.step", t, 1e-3, program="fingerprint0")
    return (time.perf_counter() - t0) / iters
