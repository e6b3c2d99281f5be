"""Bucketed request coalescing for the serving engine
(``paddle_tpu/serving/batching.py``, single-tenant).

Concurrent ``/predict`` requests are coalesced into one padded batch at
power-of-two bucket shapes.  A worker that frees up takes whatever
compatible requests are queued right now, so light traffic keeps
single-request latency and heavy traffic shares one dispatch.

- ``BatchSpec`` decides from the program's shape metadata whether rows
  can be coalesced at all (every feed and fetch batch-major: leading
  dim -1, static trailing dims, lod_level 0).  Programs that fail the
  test still serve; each request then runs alone at its own shape.
- ``PendingRequest`` is one waiter: feeds, row count, deadline and a
  completion event.
- ``RequestQueue`` hands replicas dispatch groups in arrival order, up
  to ``max_batch`` rows, optionally lingering ``batch_timeout`` seconds
  to fill a bucket, and expires requests whose deadline passed while
  queued.
- ``coalesce``/``scatter`` pad rows up to the bucket by repeating the
  last real row and slice each fetch back to its waiter.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


def next_bucket(rows: int) -> int:
    """Smallest power of two >= rows (rows <= 1 maps to 1): the padded
    batch dim."""
    if rows <= 1:
        return 1
    return 1 << (rows - 1).bit_length()


def bucket_ladder(max_batch: int) -> Tuple[int, ...]:
    """The bucket shapes a server with this cap runs: 1, 2, 4 .. the
    bucket covering max_batch."""
    out = []
    b = 1
    while b < max_batch:
        out.append(b)
        b <<= 1
    out.append(next_bucket(max_batch))
    return tuple(out)


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
                 dtypes: Optional[Dict[str, Any]] = None):
        self.batchable = batchable
        self.reason = reason
        self.feed_names = tuple(feed_names)
        self.row_shapes = row_shapes or {}
        self.dtypes = dtypes or {}
        self._feed_set = frozenset(self.feed_names)

    @classmethod
    def disabled(cls, reason: str) -> "BatchSpec":
        return cls(False, reason)

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
                return cls.disabled(f"feed {name!r} has no shape metadata")
            if var.lod_level:
                return cls.disabled(f"feed {name!r} is LoD "
                                    f"(lod_level={var.lod_level})")
            if len(var.shape) < 1 or var.shape[0] != -1:
                return cls.disabled(
                    f"feed {name!r} shape {var.shape} is not batch-major")
            if any(d < 0 for d in var.shape[1:]):
                return cls.disabled(
                    f"feed {name!r} shape {var.shape} has dynamic "
                    "non-batch dims")
            if var.dtype == "bfloat16":
                return cls.disabled(f"feed {name!r} is bfloat16, which "
                                    "numpy cannot hold")
            row_shapes[name] = tuple(var.shape[1:])
            dtypes[name] = np.dtype(var.dtype)
        for name in fetch_names:
            var = block.find_var(name)
            if var is None or var.shape is None:
                return cls.disabled(f"fetch {name!r} has no shape metadata")
            if var.lod_level:
                return cls.disabled(f"fetch {name!r} is LoD "
                                    f"(lod_level={var.lod_level})")
            if len(var.shape) < 1 or var.shape[0] != -1:
                return cls.disabled(
                    f"fetch {name!r} shape {var.shape} is not batch-major "
                    "(per-request rows cannot be scattered back)")
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
    """One in-flight request: feeds + row span + completion event."""

    __slots__ = ("feeds", "rows", "batchable", "deadline", "enqueued_at",
                 "abandoned", "outputs", "error", "bucket", "_event", "_done")

    def __init__(self, feeds: Dict[str, Any], rows: int = 1,
                 batchable: bool = False, deadline: Optional[float] = None):
        self.feeds = feeds
        self.rows = rows
        self.batchable = batchable
        self.deadline = deadline          # time.monotonic timestamp
        self.enqueued_at = time.monotonic()
        self.abandoned = False            # waiter gave up (timed out)
        self.outputs: Optional[list] = None
        self.error: Optional[BaseException] = None
        self.bucket: Optional[int] = None  # padded rows it dispatched at
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

    ``take()`` returns one dispatch group: batchable requests in arrival
    order totalling at most ``max_batch`` rows, or a single unbatchable
    request.  With ``batch_timeout`` > 0 the head request may linger
    that long for peers to fill the bucket; at 0 coalescing is purely
    opportunistic, so an idle server adds no latency.
    """

    def __init__(self, max_batch: int = 8, batch_timeout: float = 0.0):
        self.max_batch = max(1, int(max_batch))
        self.batch_timeout = max(0.0, float(batch_timeout))
        self._cond = threading.Condition()
        self._pending: List[PendingRequest] = []
        self._closed = False

    def __len__(self) -> int:
        with self._cond:
            return len(self._pending)

    def submit(self, req: PendingRequest) -> None:
        with self._cond:
            if self._closed:
                raise RuntimeError("serving queue is shut down")
            req.enqueued_at = time.monotonic()
            self._pending.append(req)
            # notify_all: a lingering worker also waits on this
            # condition and could swallow a single wakeup
            self._cond.notify_all()

    def close(self) -> None:
        with self._cond:
            self._closed = True
            for req in self._pending:
                req.fail(RuntimeError("server shutting down"))
            self._pending.clear()
            self._cond.notify_all()

    def _sweep_locked(self) -> None:
        """Drop abandoned waiters; expire requests whose deadline passed
        while queued (they time out without burning a dispatch)."""
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
        self._pending = live

    def take(self) -> Optional[List[PendingRequest]]:
        """Block until a dispatch group is available; None on shutdown."""
        with self._cond:
            head = None
            while head is None:
                while True:
                    self._sweep_locked()
                    if self._closed:
                        return None
                    if self._pending:
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
                        if not self._pending:
                            head = None  # everything expired: start over
                            break
                        head = self._pending[0]
                        if not head.batchable:
                            break
            if not head.batchable:
                return [self._pending.pop(0)]
            batch, rows, keep = [], 0, []
            for req in self._pending:
                if req.batchable and (
                        not batch or rows + req.rows <= self.max_batch):
                    batch.append(req)
                    rows += req.rows
                else:
                    keep.append(req)
            self._pending = keep
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
