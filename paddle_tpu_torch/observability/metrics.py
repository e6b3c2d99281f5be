"""Typed metrics registry: counters, gauges, histograms with labels
(``paddle_tpu/observability/metrics.py``).

The Executor, the serving front, its queue and its replica pool, and
the decode engine record into the process-global ``REGISTRY``.  A
Histogram keeps fixed-bucket counts beside the total, count and max,
so latency quantiles (p50/p95/p99) come out of the object the hot path
updates.

- a hot-path write is one lock acquire and a dict or bisect update (a
  few microseconds; ``observability.measure_step_overhead``), so the
  Executor records every step unconditionally;
- exposition is pulled: ``render_prometheus()`` for a ``GET /metrics``
  scrape, ``snapshot()`` (plain JSON-able dicts) for ``GET /stats``,
  ``format_snapshot()`` for people.

The Prometheus text follows the 0.0.4 exposition format (cumulative
``_bucket{le=...}`` counts, ``_sum`` and ``_count`` rows).  For the
same recorded values it is byte-equal to the JAX package's, and so is
``format_table``: label escaping, number formatting and the order of
families and labels are the same code.
"""

from __future__ import annotations

import bisect
import contextlib
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

# Default latency buckets (seconds): 0.5 ms .. 10 s, the span from a
# cached executor step to a cold serving request.
DEFAULT_LATENCY_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

# Compile-time buckets (seconds): from tens of ms (a plan build of a toy
# net) to minutes.
COMPILE_TIME_BUCKETS = (
    0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
    10.0, 30.0, 60.0, 120.0, 300.0,
)

_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, Any]) -> _LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _fmt_num(v: float) -> str:
    if isinstance(v, float) and v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _prom_labels(key: _LabelKey, extra: Sequence[Tuple[str, str]] = ()) -> str:
    pairs = list(key) + list(extra)
    if not pairs:
        return ""
    body = ",".join(f'{k}="{_escape_label(v)}"' for k, v in pairs)
    return "{" + body + "}"


class _Metric:
    """Shared family plumbing: name, help text, labeled children."""

    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._children: Dict[_LabelKey, Any] = {}

    def _clear(self):
        with self._lock:
            self._children.clear()

    def label_sets(self) -> List[Dict[str, str]]:
        with self._lock:
            return [dict(k) for k in self._children]


class Counter(_Metric):
    """Monotonically increasing count (Prometheus counter)."""

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

    def render(self) -> List[str]:
        with self._lock:
            items = sorted(self._children.items())
        return [f"{self.name}{_prom_labels(k)} {_fmt_num(v)}"
                for k, v in items]


class Gauge(_Metric):
    """Point-in-time value (Prometheus gauge)."""

    kind = "gauge"

    def set(self, value: float, **labels):
        with self._lock:
            self._children[_label_key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels):
        key = _label_key(labels)
        with self._lock:
            self._children[key] = self._children.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels):
        self.inc(-amount, **labels)

    def value(self, **labels) -> float:
        with self._lock:
            return self._children.get(_label_key(labels), 0.0)

    snapshot = Counter.snapshot
    render = Counter.render


class _HistState:
    __slots__ = ("counts", "sum", "count", "max")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets  # per-bucket (not cumulative)
        self.sum = 0.0
        self.count = 0
        self.max = 0.0


class Histogram(_Metric):
    """Fixed-bucket distribution (Prometheus histogram) that also keeps
    the StatSet-style total/count/max summary."""

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

    @contextlib.contextmanager
    def time(self, **labels):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(time.perf_counter() - t0, **labels)

    def count(self, **labels) -> int:
        with self._lock:
            st = self._children.get(_label_key(labels))
            return st.count if st else 0

    def quantile(self, q: float, **labels) -> float:
        """Bucket-interpolated quantile (the Prometheus
        ``histogram_quantile`` estimate); the +Inf bucket is clamped to
        the max observed value instead of an unbounded edge."""
        with self._lock:
            st = self._children.get(_label_key(labels))
            if st is None or st.count == 0:
                return float("nan")
            counts, total, vmax = list(st.counts), st.count, st.max
        return self._quantile_from(counts, total, vmax, q, self.buckets)

    @staticmethod
    def _quantile_from(counts, total, vmax, q, buckets) -> float:
        target = q * total
        cum = 0
        lower = 0.0
        for i, edge in enumerate(buckets):
            nxt = cum + counts[i]
            if nxt >= target and counts[i] > 0:
                frac = (target - cum) / counts[i]
                est = lower + (edge - lower) * frac
                # no observation exceeds vmax, so no quantile can either
                # (an all-zeros histogram must report 0, not bucket-edge
                # interpolation)
                return min(est, vmax)
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

    def render(self) -> List[str]:
        snap = self.snapshot()
        lines: List[str] = []
        for child in snap["values"]:
            key = _label_key(child["labels"])
            for edge, cum in child["buckets"].items():
                lines.append(
                    f"{self.name}_bucket{_prom_labels(key, (('le', edge),))}"
                    f" {_fmt_num(float(cum))}")
            lines.append(f"{self.name}_sum{_prom_labels(key)}"
                         f" {_fmt_num(child['sum'])}")
            lines.append(f"{self.name}_count{_prom_labels(key)}"
                         f" {_fmt_num(float(child['count']))}")
        return lines


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

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def reset(self):
        """Clear recorded values; registered families survive (module
        level handles into the registry stay valid)."""
        with self._lock:
            fams = list(self._metrics.values())
        for m in fams:
            m._clear()

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

    def render_prometheus(self) -> str:
        """Prometheus text exposition (0.0.4)."""
        with self._lock:
            fams = sorted(self._metrics.items())
        lines: List[str] = []
        for name, m in fams:
            body = m.render()
            if not body:
                continue
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            lines.extend(body)
        return "\n".join(lines) + ("\n" if lines else "")

    def render_table(self) -> str:
        return format_snapshot(self.snapshot())


# ---------------------------------------------------------------------------
# Human rendering (shared with stat.StatSet.print_status)
# ---------------------------------------------------------------------------


def format_table(rows: Sequence[Sequence[str]],
                 headers: Optional[Sequence[str]] = None) -> str:
    """Align columns: first column left, the rest right."""
    all_rows = ([list(headers)] if headers else []) + [list(r) for r in rows]
    if not all_rows:
        return ""
    ncols = max(len(r) for r in all_rows)
    widths = [0] * ncols
    for r in all_rows:
        for i, cell in enumerate(r):
            widths[i] = max(widths[i], len(str(cell)))
    lines = []
    for r in all_rows:
        cells = [str(c) for c in r] + [""] * (ncols - len(r))
        lines.append("  ".join(
            cells[i].ljust(widths[i]) if i == 0 else cells[i].rjust(widths[i])
            for i in range(ncols)).rstrip())
    return "\n".join(lines)


def _g(v) -> str:
    try:
        return f"{float(v):.6g}"
    except (TypeError, ValueError):
        return str(v)


def format_snapshot(snap: Dict[str, dict]) -> str:
    """Human table from a ``snapshot()`` dict (also accepts the same
    structure parsed back from JSON, as ``GET /stats`` serves it)."""
    rows = []
    for name in sorted(snap):
        fam = snap[name]
        for child in fam.get("values", []):
            labels = child.get("labels", {})
            label_str = " ".join(f"{k}={labels[k]}" for k in sorted(labels)) \
                or "-"
            if fam.get("type") == "histogram":
                val = (f"count={child['count']} sum={_g(child['sum'])} "
                       f"p50={_g(child.get('p50'))} "
                       f"p95={_g(child.get('p95'))} "
                       f"p99={_g(child.get('p99'))} max={_g(child['max'])}")
            else:
                val = _fmt_num(float(child["value"]))
            rows.append((name, label_str, val))
    if not rows:
        return ""
    return format_table(rows, headers=("metric", "labels", "value"))


# ---------------------------------------------------------------------------
# Process-global registry + module-level conveniences
# ---------------------------------------------------------------------------

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


def render_prometheus() -> str:
    return REGISTRY.render_prometheus()
