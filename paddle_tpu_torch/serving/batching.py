"""Bucketed request coalescing for the serving engine
(``paddle_tpu/serving/batching.py``).

Concurrent ``/predict`` requests are coalesced into one padded batch at
power-of-two bucket shapes.  A worker that frees up takes whatever
compatible requests are queued right now, so light traffic keeps
single-request latency and heavy traffic shares one dispatch.

- ``BatchSpec`` decides from the program's shape metadata whether rows
  can be coalesced at all (every feed and fetch batch-major: leading
  dim -1, static trailing dims, lod_level 0).  Programs that fail the
  test still serve; each request then runs alone at its own shape, and
  ``code`` names the reason in ``serving_unbatched_total{reason}``.
- ``PendingRequest`` is one waiter: feeds, row count, deadline, tenant,
  dispatch attempts (the supervised pool requeues a dead replica's
  batch) and a completion event.
- ``RequestQueue`` hands replicas dispatch groups up to ``max_batch``
  rows, optionally lingering ``batch_timeout`` seconds to fill a
  bucket, and expires requests whose deadline passed while queued.
- ``coalesce``/``scatter`` pad rows up to the bucket by repeating the
  last real row and slice each fetch back to its waiter.

Tenants: ``TenantQuota`` is a per-tenant token bucket (``rate`` tokens
a second, capped at ``burst``) with a fair-share ``weight``;
``TenantRegistry`` holds the configured tenants and a ``"*"`` template
for tenants first seen at run time.  An over-quota submission raises
``TenantOverQuota`` (HTTP 429).  Dequeue is weighted-fair: a request's
virtual finish time is ``vft = max(tenant_vft, queue_vclock) +
rows / weight`` and ``take()`` serves in vft order, so under saturation
each tenant's share converges to its weight, while a lone tenant sees
plain FIFO.  Past ``shed_watermark`` queued requests the queue sheds
the tenants below the top weight (``QueueShed`` ``shed_low_weight``,
HTTP 503), and everyone at twice it (``queue_collapse``).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from paddle_tpu_torch.kernels.tuning import bucket as _bucket
from paddle_tpu_torch.observability import metrics as _metrics
_M_QUEUE_WAIT = _metrics.histogram(
    "serving_queue_wait_seconds",
    "time a request spends queued before a replica takes it")
_M_BATCH_ROWS = _metrics.histogram(
    "serving_batch_size",
    "coalesced request rows per executed batch "
    "(label bucket = padded rows dispatched, 'unbatched' = solo path)",
    buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0))
_M_UNBATCHED = _metrics.counter(
    "serving_unbatched_total",
    "solo-fallback dispatches by reason (the BatchSpec disabled() "
    "family: lod_feed/lod_fetch/not_batch_major/... when the model "
    "cannot batch at all, shape_mismatch when this request's shapes "
    "did not fit an otherwise batchable model, requeued when a "
    "replica death sent the request back for solo redispatch)")
_M_TENANT_DEPTH = _metrics.gauge(
    "serving_tenant_queue_depth",
    "queued requests per tenant (weighted-fair scheduling input)")

#: Tenant id used when a request names none (no X-Tenant header, no
#: "tenant" payload key).
DEFAULT_TENANT = "default"


class TenantOverQuota(RuntimeError):
    """The tenant's token bucket is empty — HTTP 429, their burst
    degrades *their* latency instead of starving other tenants."""

    def __init__(self, tenant: str, message: str):
        super().__init__(message)
        self.tenant = tenant


class QueueShed(RuntimeError):
    """Load-shedding admission refusal under sustained queue pressure
    (HTTP 503): ``reason`` is ``shed_low_weight`` (lowest-weight
    tenants go first) or ``queue_collapse`` (everyone, at twice the
    watermark)."""

    def __init__(self, reason: str, message: str):
        super().__init__(message)
        self.reason = reason


class RetryExhausted(RuntimeError):
    """A request burned its dispatch-attempt budget (every attempt
    killed or lost a replica) and is quarantined — HTTP 503 naming the
    reason, never an infinite redispatch of a poison batch."""

    reason = "retry_exhausted"


class TenantQuota:
    """One tenant's admission policy: token bucket + fair-share weight.

    ``rate`` is tokens (requests) per second, ``burst`` the bucket
    capacity; ``rate=None`` means unmetered (the bucket never empties).
    Refill is lazy (computed from elapsed wall time at each take) and
    clamped at ``burst``, so an idle tenant's unused tokens never
    accumulate past one burst.
    """

    __slots__ = ("name", "rate", "burst", "weight", "tokens", "_last",
                 "vft")

    def __init__(self, name: str, rate: Optional[float] = None,
                 burst: Optional[float] = None, weight: float = 1.0):
        self.name = name
        self.rate = float(rate) if rate else None
        if self.rate is not None and self.rate <= 0:
            raise ValueError(f"tenant {name!r}: rate must be > 0")
        self.burst = float(burst) if burst is not None else (
            max(self.rate, 1.0) if self.rate is not None else 0.0)
        if self.rate is not None and self.burst < 1.0:
            raise ValueError(f"tenant {name!r}: burst must be >= 1")
        self.weight = float(weight)
        if self.weight <= 0:
            raise ValueError(f"tenant {name!r}: weight must be > 0")
        self.tokens = self.burst
        self._last = time.monotonic()
        self.vft = 0.0                 # fair-queue virtual finish time

    def available(self, now: Optional[float] = None) -> float:
        """Tokens in the bucket right now (refilled, burst-capped)."""
        if self.rate is None:
            return float("inf")
        now = time.monotonic() if now is None else now
        self.tokens = min(self.burst,
                          self.tokens + (now - self._last) * self.rate)
        self._last = now
        return self.tokens

    def try_take(self, now: Optional[float] = None, n: float = 1.0) -> bool:
        if self.rate is None:
            return True
        if self.available(now) < n:
            return False
        self.tokens -= n
        return True


class TenantRegistry:
    """The configured tenants plus a ``"*"`` template for unknown ones.

    Config shape (``--tenant_config`` JSON / ``InferenceServer``
    ``tenants=`` dict)::

        {"A": {"rate": 100, "burst": 20, "weight": 4},
         "B": {"rate": 50, "weight": 1},
         "*": {"rate": 10, "burst": 10}}

    or the compact ``--tenants`` form ``A:100:20:4,B:50::1,*:10:10``
    (``name:rate[:burst[:weight]]``, ``-`` or empty = default).  A
    tenant id never configured inherits the ``"*"`` template (default:
    unmetered, weight 1) — multi-tenancy is opt-in per tenant, not a
    registration wall.
    """

    def __init__(self, config: Optional[Dict[str, dict]] = None):
        self._lock = threading.Lock()
        self._tenants: Dict[str, TenantQuota] = {}
        cfg = dict(config or {})
        self._template = cfg.pop("*", {})
        for name, spec in cfg.items():
            self._tenants[name] = TenantQuota(name, **spec)

    @classmethod
    def parse(cls, compact: str) -> "TenantRegistry":
        """``A:100:20:4,B:50``  ->  name:rate[:burst[:weight]]."""
        config: Dict[str, dict] = {}
        for item in compact.split(","):
            item = item.strip()
            if not item:
                continue
            parts = item.split(":")
            name = parts[0]
            if not name:
                raise ValueError(f"tenant spec {item!r} names no tenant")
            spec: dict = {}
            fields = ("rate", "burst", "weight")
            for key, raw in zip(fields, parts[1:]):
                if raw not in ("", "-"):
                    spec[key] = float(raw)
            config[name] = spec
        return cls(config)

    def get(self, name: str) -> TenantQuota:
        with self._lock:
            q = self._tenants.get(name)
            if q is None:
                q = TenantQuota(name, **self._template)
                self._tenants[name] = q
            return q

    def admit(self, name: str) -> TenantQuota:
        """Charge one request to the tenant's bucket; raises
        ``TenantOverQuota`` when it is empty."""
        q = self.get(name)
        with self._lock:
            if not q.try_take():
                raise TenantOverQuota(
                    name, f"tenant {name!r} is over quota "
                    f"(rate={q.rate}/s, burst={q.burst:g})")
        return q

    def max_weight(self) -> float:
        with self._lock:
            if not self._tenants:
                return 1.0
            return max(q.weight for q in self._tenants.values())

    def info(self) -> dict:
        with self._lock:
            return {
                name: {"rate": q.rate, "burst": q.burst,
                       "weight": q.weight,
                       "tokens": (None if q.rate is None
                                  else round(q.available(), 3))}
                for name, q in sorted(self._tenants.items())
            }


def next_bucket(rows: int) -> int:
    """Smallest power of two >= rows (rows <= 1 maps to 1): the padded
    batch dim.  The kernel tuner's ladder (``kernels/tuning/bucket.py``),
    so serving's batch buckets and the tuning database's shape buckets
    cannot drift apart."""
    return _bucket.bucket_dim(rows)


def bucket_ladder(max_batch: int) -> Tuple[int, ...]:
    """The bucket shapes a server with this cap runs: 1, 2, 4 .. the
    bucket covering max_batch (``kernels/tuning/bucket.py``)."""
    return _bucket.bucket_ladder(max_batch)


def propagate_shapes(program) -> None:
    """Run the registered ``infer_shape`` rules over the global block so
    the bucketer sees backfilled var metadata (a program loaded with
    ``Program.from_dict`` skips append-time inference).  Rules that
    cannot infer or that reject are ignored: the bucketer is
    conservative, not a verifier."""
    from paddle_tpu_torch.registry import OpRegistry

    block = program.global_block()
    for op in block.ops:
        info = OpRegistry.get(op.type, none_ok=True)
        if info is None or info.infer_shape is None:
            continue
        try:
            info.infer_shape(op, block)
        except Exception:
            continue
    program.invalidate_cache()


class BatchSpec:
    """Static batchability decision + per-feed row layout."""

    def __init__(self, batchable: bool, reason: str,
                 feed_names: Sequence[str] = (),
                 row_shapes: Optional[Dict[str, tuple]] = None,
                 dtypes: Optional[Dict[str, Any]] = None,
                 code: str = "ok"):
        self.batchable = batchable
        self.reason = reason
        # short slug of the disabled() reason family: the label value of
        # serving_unbatched_total (the prose stays in .reason)
        self.code = code
        self.feed_names = tuple(feed_names)
        self.row_shapes = row_shapes or {}
        self.dtypes = dtypes or {}
        self._feed_set = frozenset(self.feed_names)

    @classmethod
    def disabled(cls, reason: str, code: str = "disabled") -> "BatchSpec":
        return cls(False, reason, code=code)

    @classmethod
    def from_program(cls, program, feed_names: Sequence[str],
                     fetch_names: Sequence[str]) -> "BatchSpec":
        propagate_shapes(program)
        block = program.global_block()
        row_shapes: Dict[str, tuple] = {}
        dtypes: Dict[str, Any] = {}
        for name in feed_names:
            var = block.find_var(name)
            if var is None or var.shape is None:
                return cls.disabled(f"feed {name!r} has no shape metadata",
                                    code="no_shape_metadata")
            if var.lod_level:
                return cls.disabled(f"feed {name!r} is LoD "
                                    f"(lod_level={var.lod_level})",
                                    code="lod_feed")
            if len(var.shape) < 1 or var.shape[0] != -1:
                return cls.disabled(
                    f"feed {name!r} shape {var.shape} is not batch-major",
                    code="not_batch_major")
            if any(d < 0 for d in var.shape[1:]):
                return cls.disabled(
                    f"feed {name!r} shape {var.shape} has dynamic "
                    "non-batch dims", code="dynamic_dims")
            if var.dtype == "bfloat16":
                return cls.disabled(f"feed {name!r} is bfloat16, which "
                                    "numpy cannot hold", code="bfloat16_feed")
            row_shapes[name] = tuple(var.shape[1:])
            dtypes[name] = np.dtype(var.dtype)
        for name in fetch_names:
            var = block.find_var(name)
            if var is None or var.shape is None:
                return cls.disabled(f"fetch {name!r} has no shape metadata",
                                    code="no_shape_metadata")
            if var.lod_level:
                return cls.disabled(f"fetch {name!r} is LoD "
                                    f"(lod_level={var.lod_level})",
                                    code="lod_fetch")
            if len(var.shape) < 1 or var.shape[0] != -1:
                return cls.disabled(
                    f"fetch {name!r} shape {var.shape} is not batch-major "
                    "(per-request rows cannot be scattered back)",
                    code="not_batch_major")
        return cls(True, "ok", feed_names, row_shapes, dtypes)

    def classify(self, feeds: Dict[str, np.ndarray]):
        """``(rows, cast_feeds)`` when this request can join a coalesced
        batch, else ``None`` (the request runs alone).  Never raises."""
        if not self.batchable or set(feeds) != self._feed_set:
            return None
        rows = None
        cast: Dict[str, np.ndarray] = {}
        for name in self.feed_names:
            arr = feeds[name]
            shape = np.shape(arr)
            if len(shape) != len(self.row_shapes[name]) + 1 or shape[0] < 1:
                return None
            if tuple(shape[1:]) != self.row_shapes[name]:
                return None
            if rows is None:
                rows = shape[0]
            elif shape[0] != rows:
                return None
            if arr.dtype != self.dtypes[name]:
                arr = arr.astype(self.dtypes[name])
            cast[name] = arr
        return rows, cast


class PendingRequest:
    """One in-flight request: feeds + row span + completion event.

    ``tenant`` feeds the fair queue; ``attempts`` counts dispatches —
    the supervised replica pool bumps it each time a replica dies with
    this request in flight, and quarantines the request
    (``RetryExhausted`` -> 503) once the budget is spent.
    """

    __slots__ = ("feeds", "rows", "batchable", "solo_reason", "deadline",
                 "enqueued_at", "abandoned", "outputs", "error", "bucket",
                 "tenant", "attempts", "_vft", "_seq", "_event", "_done")

    def __init__(self, feeds: Dict[str, Any], rows: int = 1,
                 batchable: bool = False, deadline: Optional[float] = None,
                 solo_reason: str = "unbatchable",
                 tenant: str = DEFAULT_TENANT):
        self.feeds = feeds
        self.rows = rows
        self.batchable = batchable
        self.solo_reason = solo_reason    # serving_unbatched_total label
        self.deadline = deadline          # time.monotonic timestamp
        self.tenant = tenant
        self.attempts = 0                 # dispatches consumed so far
        self.enqueued_at = time.monotonic()
        self.abandoned = False            # waiter gave up (timed out)
        self.outputs: Optional[list] = None
        self.error: Optional[BaseException] = None
        self.bucket: Optional[int] = None  # padded rows it dispatched at
        self._vft = 0.0                   # virtual finish time (fair queue)
        self._seq = 0                     # submit order tie-break
        self._event = threading.Event()
        self._done = False

    @property
    def done(self) -> bool:
        return self._done

    def complete(self, outputs: list) -> None:
        if self._done:
            return
        self._done = True
        self.outputs = outputs
        self._event.set()

    def fail(self, exc: BaseException) -> None:
        if self._done:
            return
        self._done = True
        self.error = exc
        self._event.set()

    def wait(self, timeout: Optional[float]) -> bool:
        return self._event.wait(timeout)

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now > self.deadline


class RequestQueue:
    """Coalescing FIFO the replica pool pulls from.

    ``take()`` (worker side) returns a list of requests forming one
    dispatch: either a group of batchable requests totalling at most
    ``max_batch`` rows, or a single unbatchable request.  With
    ``batch_timeout`` > 0 the head request may linger that long waiting
    for peers to fill the bucket; at 0 (default) coalescing is purely
    opportunistic — whatever is queued when a worker frees up rides
    along, so an idle server adds zero latency.

    With a ``TenantRegistry`` the queue is weighted-fair: ``submit``
    charges the tenant's token bucket (``TenantOverQuota`` when empty)
    and stamps a virtual finish time; ``take`` serves in vft order, so
    dispatch share converges to the weight ratio under saturation.
    ``shed_watermark`` arms pressure shedding: past it, tenants below
    the registry's top weight are refused (``QueueShed``
    ``shed_low_weight``); past twice it, everyone is
    (``queue_collapse``) — bounded degradation instead of queue
    collapse.
    """

    def __init__(self, max_batch: int = 8, batch_timeout: float = 0.0,
                 tenants: Optional[TenantRegistry] = None,
                 shed_watermark: Optional[int] = None):
        self.max_batch = max(1, int(max_batch))
        self.batch_timeout = max(0.0, float(batch_timeout))
        self.tenants = tenants if tenants is not None else TenantRegistry()
        self.shed_watermark = (int(shed_watermark)
                               if shed_watermark else None)
        self._cond = threading.Condition()
        self._pending: List[PendingRequest] = []
        self._closed = False
        self._paused = False
        self._vclock = 0.0            # fair-queue virtual time
        self._seq = 0                 # submit counter (vft tie-break)

    def pause(self) -> None:
        """Stop handing out batches (drain/maintenance).  Submissions
        still queue — and expire against their deadlines."""
        with self._cond:
            self._paused = True

    def resume(self) -> None:
        with self._cond:
            self._paused = False
            self._cond.notify_all()

    def __len__(self) -> int:
        with self._cond:
            return len(self._pending)

    def _shed_check_locked(self, req: PendingRequest) -> None:
        """Pressure shedding (holds the queue lock): lowest-weight
        tenants are refused first, everyone at 2x the watermark."""
        if self.shed_watermark is None:
            return
        depth = len(self._pending)
        if depth >= 2 * self.shed_watermark:
            raise QueueShed(
                "queue_collapse",
                f"serving queue saturated ({depth} pending >= "
                f"{2 * self.shed_watermark}); shedding all tenants")
        if depth >= self.shed_watermark:
            weight = self.tenants.get(req.tenant).weight
            top = self.tenants.max_weight()
            if weight < top:
                raise QueueShed(
                    "shed_low_weight",
                    f"serving queue under pressure ({depth} pending >= "
                    f"{self.shed_watermark}); shedding tenant "
                    f"{req.tenant!r} (weight {weight:g} < {top:g})")

    def submit(self, req: PendingRequest) -> None:
        """Admit one request: charge the tenant's token bucket
        (``TenantOverQuota`` -> 429 when empty), apply pressure
        shedding, stamp the fair-queue virtual finish time, enqueue."""
        quota = self.tenants.admit(req.tenant)
        with self._cond:
            if self._closed:
                raise RuntimeError("serving queue is shut down")
            self._shed_check_locked(req)
            req.enqueued_at = time.monotonic()
            # weighted fair queuing: heavier tenants' requests finish
            # "sooner" in virtual time, so they drain proportionally
            # faster under saturation.  max() with the queue vclock
            # means an idle tenant re-enters at *now* — no banked
            # scheduling credit from its idle spell.
            req._vft = max(quota.vft, self._vclock) + req.rows / quota.weight
            quota.vft = req._vft
            self._seq += 1
            req._seq = self._seq
            self._pending.append(req)
            # notify_all, not notify: a lingering worker (batch_timeout)
            # also waits on this condition and could swallow the single
            # wakeup while an idle replica sleeps through it
            self._cond.notify_all()

    def requeue(self, reqs: Sequence[PendingRequest]) -> None:
        """Put a dead replica's in-flight requests back (supervisor
        path): no fresh quota charge, original vft kept — they return
        to the *front* of the virtual-time order they already earned.
        Requests already completed by a zombie dispatch are skipped."""
        with self._cond:
            for req in reqs:
                if req.done or req.abandoned:
                    continue
                if self._closed:
                    req.fail(RuntimeError("server shutting down"))
                    continue
                self._pending.append(req)
            self._cond.notify_all()

    def depth(self) -> int:
        with self._cond:
            return len(self._pending)

    def degradation(self) -> dict:
        """Pressure snapshot for /health."""
        with self._cond:
            depth = len(self._pending)
        out = {"pending": depth, "shed_watermark": self.shed_watermark,
               "shedding": None}
        if self.shed_watermark is not None:
            if depth >= 2 * self.shed_watermark:
                out["shedding"] = "queue_collapse"
            elif depth >= self.shed_watermark:
                out["shedding"] = "shed_low_weight"
        return out

    def close(self) -> None:
        with self._cond:
            self._closed = True
            for req in self._pending:
                req.fail(RuntimeError("server shutting down"))
            self._pending.clear()
            self._cond.notify_all()

    # -- worker side --------------------------------------------------------

    def _sweep_locked(self) -> None:
        """Drop abandoned/already-completed waiters; expire requests
        whose deadline passed while queued (they 504 without burning a
        dispatch).  Also restores weighted-fair order: the pending list
        is kept sorted by virtual finish time (timsort on a
        nearly-sorted list — requeues are the only out-of-order
        inserts)."""
        now = time.monotonic()
        live = []
        for req in self._pending:
            if req.abandoned or req.done:
                continue
            if req.expired(now):
                req.fail(TimeoutError(
                    "request deadline expired waiting for a serving replica"))
                continue
            live.append(req)
        live.sort(key=lambda r: (r._vft, r._seq))
        self._pending = live
        counts: Dict[str, int] = {}
        for req in live:
            counts[req.tenant] = counts.get(req.tenant, 0) + 1
        seen = {d.get("tenant", "") for d in _M_TENANT_DEPTH.label_sets()}
        for tenant in set(counts) | (seen - {""}):
            _M_TENANT_DEPTH.set(counts.get(tenant, 0), tenant=tenant)

    def take(self) -> Optional[List[PendingRequest]]:
        """Block until a dispatch group is available; None on shutdown."""
        with self._cond:
            head = None
            while head is None:
                while True:
                    self._sweep_locked()
                    if self._closed:
                        return None
                    if self._pending and not self._paused:
                        break
                    self._cond.wait()
                head = self._pending[0]
                if head.batchable and self.batch_timeout > 0:
                    fill_by = head.enqueued_at + self.batch_timeout
                    while True:
                        rows = sum(r.rows for r in self._pending
                                   if r.batchable)
                        remaining = fill_by - time.monotonic()
                        if rows >= self.max_batch or remaining <= 0:
                            break
                        self._cond.wait(remaining)
                        self._sweep_locked()
                        if self._closed:
                            return None
                        if self._paused or not self._pending:
                            # paused mid-linger (pause() must stop
                            # dispatch) or everything expired: start over
                            head = None
                            break
                        head = self._pending[0]
                        if not head.batchable:
                            break
            if not head.batchable:
                batch = [self._pending.pop(0)]
            else:
                batch, rows, keep = [], 0, []
                for req in self._pending:
                    if req.batchable and (
                            not batch or rows + req.rows <= self.max_batch):
                        batch.append(req)
                        rows += req.rows
                    else:
                        keep.append(req)
                self._pending = keep
            now = time.monotonic()
            for req in batch:
                req.attempts += 1
                self._vclock = max(self._vclock, req._vft)
                _M_QUEUE_WAIT.observe(max(0.0, now - req.enqueued_at))
            return batch


def coalesce(batch: Sequence[PendingRequest], spec: BatchSpec):
    """Stack the batch's rows per feed and pad up to the bucket shape.

    Padding repeats each feed's last real row: the padded rows run
    through the same program and ``scatter`` drops them, and a copy of
    a real row cannot bring NaN/Inf the way synthetic zeros could.
    """
    rows = sum(r.rows for r in batch)
    bucket = next_bucket(rows)
    feeds: Dict[str, np.ndarray] = {}
    for name in spec.feed_names:
        parts = [np.asarray(r.feeds[name]) for r in batch]
        if len(parts) == 1 and bucket == rows:
            feeds[name] = parts[0]
            continue
        if bucket > rows:
            parts.append(np.repeat(parts[-1][-1:], bucket - rows, axis=0))
        feeds[name] = np.concatenate(parts, axis=0)
    return feeds, rows, bucket


def scatter(batch: Sequence[PendingRequest], outs: Sequence[Any],
            bucket: int) -> None:
    """Slice each fetch back to its waiter (de-padding)."""
    for o in outs:
        lead = np.shape(o)[0] if np.ndim(o) else None
        if lead != bucket:
            raise RuntimeError(
                f"fetch output shape {np.shape(o)} is not batch-aligned to "
                f"the dispatched bucket ({bucket} rows); the program's shape "
                "metadata mis-declared a batch-major fetch")
    start = 0
    for req in batch:
        req.complete([o[start:start + req.rows] for o in outs])
        start += req.rows
