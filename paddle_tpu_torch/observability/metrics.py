"""Typed metrics registry: counters, gauges and histograms with labels
(``paddle_tpu/observability/metrics.py``, the part the decode modules
record into and read: ``counter``, ``gauge``, ``histogram`` and
``snapshot``).

A write is one lock acquire and a dict or bisect update, so the hot
path records unconditionally.  A Histogram keeps fixed-bucket counts
beside the total, count and max, so p50/p95/p99 come out of the object
the hot path updates.  The Prometheus text exposition and ``/metrics``
are not ported yet.
"""

from __future__ import annotations

import bisect
import threading
from typing import Any, Dict, Sequence, Tuple

# Default latency buckets (seconds): 0.5 ms .. 10 s.
DEFAULT_LATENCY_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, Any]) -> _LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class _Metric:
    """Shared family plumbing: name, help text, labeled children."""

    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._children: Dict[_LabelKey, Any] = {}


class Counter(_Metric):
    """Monotonically increasing count."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels):
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        key = _label_key(labels)
        with self._lock:
            self._children[key] = self._children.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return self._children.get(_label_key(labels), 0.0)

    def snapshot(self) -> dict:
        with self._lock:
            items = sorted(self._children.items())
        return {
            "type": self.kind, "help": self.help,
            "values": [{"labels": dict(k), "value": v} for k, v in items],
        }


class Gauge(_Metric):
    """Point-in-time value."""

    kind = "gauge"

    def set(self, value: float, **labels):
        with self._lock:
            self._children[_label_key(labels)] = float(value)

    snapshot = Counter.snapshot


class _HistState:
    __slots__ = ("counts", "sum", "count", "max")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets  # per-bucket (not cumulative)
        self.sum = 0.0
        self.count = 0
        self.max = 0.0


class Histogram(_Metric):
    """Fixed-bucket distribution that also keeps total/count/max."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS):
        super().__init__(name, help)
        b = tuple(sorted(float(x) for x in buckets))
        if not b:
            raise ValueError(f"histogram {name}: empty bucket list")
        self.buckets = b

    def observe(self, value: float, **labels):
        key = _label_key(labels)
        v = float(value)
        # bisect_left: v == bound lands in that bucket (le is inclusive)
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            st = self._children.get(key)
            if st is None:
                st = self._children[key] = _HistState(len(self.buckets) + 1)
            st.counts[i] += 1
            st.sum += v
            st.count += 1
            if v > st.max:
                st.max = v

    @staticmethod
    def _quantile_from(counts, total, vmax, q, buckets) -> float:
        target = q * total
        cum = 0
        lower = 0.0
        for i, edge in enumerate(buckets):
            nxt = cum + counts[i]
            if nxt >= target and counts[i] > 0:
                frac = (target - cum) / counts[i]
                return min(lower + (edge - lower) * frac, vmax)
            cum = nxt
            lower = edge
        return vmax  # landed in the +Inf bucket

    def snapshot(self) -> dict:
        with self._lock:
            items = sorted((k, (list(st.counts), st.sum, st.count, st.max))
                           for k, st in self._children.items())
        values = []
        for k, (counts, total_sum, count, vmax) in items:
            cum, bucket_map = 0, {}
            for i, edge in enumerate(self.buckets):
                cum += counts[i]
                bucket_map[f"{edge:g}"] = cum
            bucket_map["+Inf"] = count
            values.append({
                "labels": dict(k), "count": count, "sum": total_sum,
                "max": vmax, "buckets": bucket_map,
                "p50": self._quantile_from(counts, count, vmax, 0.50,
                                           self.buckets),
                "p95": self._quantile_from(counts, count, vmax, 0.95,
                                           self.buckets),
                "p99": self._quantile_from(counts, count, vmax, 0.99,
                                           self.buckets),
            })
        return {"type": self.kind, "help": self.help, "values": values}


class MetricsRegistry:
    """Name -> metric family map.  ``counter``/``gauge``/``histogram``
    are get-or-create (idempotent), erroring on a kind clash."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name: str, help: str, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls):
                    raise TypeError(
                        f"metric {name!r} already registered as {m.kind}, "
                        f"not {cls.kind}")
                return m
            m = cls(name, help, **kwargs)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS
                  ) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def snapshot(self) -> Dict[str, dict]:
        """JSON-able {name: family snapshot}; empty families omitted."""
        with self._lock:
            fams = sorted(self._metrics.items())
        out = {}
        for name, m in fams:
            snap = m.snapshot()
            if snap["values"]:
                out[name] = snap
        return out


REGISTRY = MetricsRegistry()


def counter(name: str, help: str = "") -> Counter:
    return REGISTRY.counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return REGISTRY.gauge(name, help)


def histogram(name: str, help: str = "",
              buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS) -> Histogram:
    return REGISTRY.histogram(name, help, buckets=buckets)


def snapshot() -> Dict[str, dict]:
    return REGISTRY.snapshot()
