"""Executor replicas for the serving engine
(``paddle_tpu/serving/replica.py``).

Each ``Replica`` owns its own ``Scope`` (its own copy of the parameters,
loaded from the export onto its device) and its own ``Executor``, so
nothing is locked because nothing mutable is shared.  The one shared
object is the parsed ``Program``, read-only after shape propagation;
sharing it keeps every replica's plan cache and telemetry keyed by the
same program fingerprint.  Workers pull dispatch groups from the
``RequestQueue``: while one replica is inside a forward, admission and
batch formation go on.

The pool is supervised:

- every worker holds an in-flight lease ``(batch, started_at)`` while
  inside ``Executor.run``;
- a supervisor thread sweeps the leases every ``min(heartbeat, 0.25)``
  s: a dispatch that outlives
  ``dispatch_timeout`` (a hung card, an injected hang) or raises an
  error that is not the request's own marks the replica dead, requeues
  its batch, and schedules a replacement ``Replica`` (fresh Scope, fresh
  Executor, the parameters loaded again) behind ``RetryPolicy`` backoff
  and a sliding-window restart budget (``MAX_RESTARTS`` in
  ``RESTART_WINDOW_S``);
- a requeued request carries a bounded ``attempts`` count (stamped at
  ``take()``): past ``max_attempts`` it is quarantined with 503
  ``retry_exhausted``, and requeued work is redispatched solo, so one
  poison row cannot take innocent batchmates down twice.

A replica marked dead while its thread is wedged becomes a zombie: the
thread finishes (or hangs) on its own, and a completion it produces
later is harmless, because ``PendingRequest.complete`` is first-wins and
the queue skips ``done`` requests.  On one card a zombie's batch runs
beside its replacement's on the default stream.  ``_mark_dead`` drops
the pool's last reference to the dead replica, so its Scope (a model's
parameters on the card) is freed once its thread ends.

``FaultInjector`` is the test and chaos hook: armed, it makes dispatch N
raise, hang or die.  ``ModelBundle(optimize=True)`` rewrites the export
once through ``analysis.optimize_program`` (verified or reverted pass by
pass) and every replica serves the rewritten program.

On the card each replica's Executor captures a bucket's plan as a CUDA
graph on its second run there (warmup runs each bucket once) and replays
it after that; captures run one at a time per device and take
``capture_error_mode="thread_local"``, so the other replicas' threads go
on (``executor._DeviceGate``).  A dead replica's graphs and their pools
are freed with its Executor.
"""

from __future__ import annotations

import collections
import concurrent.futures
import threading
import time
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from paddle_tpu_torch import io
from paddle_tpu_torch.distributed.retry import RetryPolicy
from paddle_tpu_torch.executor import Executor, Scope
from paddle_tpu_torch.observability import metrics as _metrics
from paddle_tpu_torch.serving.batching import (
    BatchSpec,
    PendingRequest,
    RequestQueue,
    RetryExhausted,
    _M_BATCH_ROWS,
    _M_UNBATCHED,
    bucket_ladder,
    coalesce,
    scatter,
)

_M_RESTARTS = _metrics.counter(
    "serving_replica_restarts_total",
    "replicas respawned by the serving supervisor")
_M_DEATHS = _metrics.counter(
    "serving_replica_deaths_total",
    "replicas declared dead, labeled by cause (exception|hang|injected)")
_M_REQUEUED = _metrics.counter(
    "serving_requeued_total",
    "in-flight requests requeued after losing their replica")
_M_LIVE = _metrics.gauge(
    "serving_replicas_live", "replicas currently taking batches")
_M_TTR = _metrics.histogram(
    "serving_time_to_ready_seconds",
    "warmup() wall time until every replica has run its bucket "
    "ladder, labeled by boot source (aot = every run plan built from the "
    "artifact store's records, plan = every run plan built by the "
    "replica's Executor, mixed = partial artifact coverage)",
    buckets=_metrics.COMPILE_TIME_BUCKETS)

#: Errors attributed to the request (a malformed feed dict, a bad dtype,
#: a feed shape the program does not declare, a shape mismatch at
#: scatter): fail the waiters, keep the replica.  An executor that raises
#: anything else (a CUDA fault among them) has unknown state and is
#: replaced rather than trusted with the next batch.
_REQUEST_ERRORS = (KeyError, ValueError, TypeError)

#: Backoff between respawns of the same pool (attempt index = restarts
#: inside the sliding window), as patient as SUPERVISOR_POLICY.
RESPAWN_POLICY = RetryPolicy(max_attempts=64, base_delay=0.05,
                             max_delay=2.0, jitter=0.25)

#: The restart budget: at most this many respawns inside any sliding
#: window of RESTART_WINDOW_S seconds; past it /health reports
#: ``restart_budget_exhausted`` until the window slides.
MAX_RESTARTS = 8
RESTART_WINDOW_S = 60.0


class ReplicaDied(RuntimeError):
    """Raised inside a worker by an injected hard death (the in-process
    stand-in for SIGKILL: the dispatch never returns a result)."""


class FaultInjector:
    """Deterministic dispatch-time fault hook for chaos tests/benches.

    ``kind``:

    - ``"raise"`` — dispatch raises ``RuntimeError`` (replica-fatal);
    - ``"die"``   — dispatch raises ``ReplicaDied``, modeling a worker
      killed mid-flight (no partial results, lease left dangling);
    - ``"hang"``  — dispatch sleeps ``hang_s`` seconds, modeling a
      wedged device; the supervisor must detect it via the lease.

    The fault fires on the ``nth`` armed dispatch (1-based, counted
    across the pool, or only on ``replica`` when given) and only while
    armed — pools arm the injector *after* warmup so compile traffic
    cannot eat the fault.  One-shot by default (``repeat=False``).
    """

    def __init__(self, kind: str, nth: int = 1,
                 replica: Optional[int] = None, hang_s: float = 5.0,
                 repeat: bool = False, armed: bool = False):
        if kind not in ("raise", "die", "hang"):
            raise ValueError(f"unknown fault kind: {kind!r}")
        self.kind = kind
        self.nth = max(1, int(nth))
        self.replica = replica
        self.hang_s = float(hang_s)
        self.repeat = bool(repeat)
        self._armed = bool(armed)
        self._count = 0
        self._fired = 0
        self._lock = threading.Lock()

    @classmethod
    def from_spec(cls, spec: str) -> "FaultInjector":
        """Parse ``KIND[@N[:rIDX]]``, e.g. ``die@5`` (5th dispatch dies)
        or ``hang@3:r1`` (replica 1's 3rd armed dispatch hangs).
        Returns a disarmed injector; the server arms a ``--chaos``
        spec itself once construction (and warmup) is done."""
        kind, _, rest = spec.strip().partition("@")
        nth, replica = 1, None
        if rest:
            nth_s, _, rep_s = rest.partition(":")
            nth = int(nth_s or 1)
            if rep_s:
                replica = int(rep_s.lstrip("r"))
        return cls(kind, nth=nth, replica=replica)

    def arm(self) -> None:
        with self._lock:
            self._armed = True
            self._count = 0

    def disarm(self) -> None:
        with self._lock:
            self._armed = False

    @property
    def fired(self) -> int:
        return self._fired

    def before_dispatch(self, replica_index: int) -> None:
        with self._lock:
            if not self._armed:
                return
            if self.replica is not None and replica_index != self.replica:
                return
            self._count += 1
            if self._count != self.nth:
                return
            self._fired += 1
            if self.repeat:
                self._count = 0
            else:
                self._armed = False
        if self.kind == "hang":
            time.sleep(self.hang_s)
            return
        if self.kind == "die":
            raise ReplicaDied(
                f"injected death on replica {replica_index}")
        raise RuntimeError(
            f"injected dispatch failure on replica {replica_index}")


class ModelBundle:
    """One parse of a save_inference_model export, shared by replicas.
    With ``optimize`` the program is rewritten once here
    (``paddle_tpu/serving/replica.py:196-217``): the shared IR keeps
    every replica on one fingerprint (one plan-cache key, one telemetry
    label), and ``opt_report`` says what the rewrite did."""

    def __init__(self, model_dir: str, optimize: bool = True):
        from paddle_tpu_torch import analysis

        self.model_dir = model_dir
        self.program, feed_names, fetch_names, self.param_names = \
            io.read_inference_export(model_dir)
        self.feed_names = list(feed_names)
        self.fetch_names = list(fetch_names)
        self.opt_report = None
        if optimize:
            self.program, self.opt_report = analysis.optimize_program(
                self.program, feed_names=set(self.feed_names),
                fetch_names=self.fetch_names)

    def batch_spec(self) -> BatchSpec:
        return BatchSpec.from_program(self.program, self.feed_names,
                                      self.fetch_names)

    def load_params_into(self, scope: Scope, device) -> None:
        scope.load_numpy(
            {name: io.load_exported_param(self.model_dir, name)
             for name in self.param_names}, device)

    def check_feeds(self, feeds) -> None:
        """Raise ValueError for a feed whose rank or static non-batch
        dims differ from its declared shape: the request's fault (400),
        which must not read as a replica failure."""
        block = self.program.global_block()
        for name, value in feeds.items():
            var = block.find_var(name)
            if var is None or var.shape is None or var.lod_level:
                continue
            shape = np.shape(value)
            want = tuple(var.shape)
            if len(shape) != len(want) or any(
                    w >= 0 and w != g for w, g in zip(want[1:], shape[1:])):
                raise ValueError(f"feed {name!r} has shape {shape}; the "
                                 f"program declares {want}")


class Replica:
    """One worker clone: private Scope + private Executor on ``place``
    (``CUDAPlace(0)`` when None); with ``store`` (an AOT artifact store)
    the Executor consults it at every plan miss."""

    def __init__(self, bundle: ModelBundle, index: int, place=None,
                 fault: Optional[FaultInjector] = None, store=None):
        self.index = index
        self.bundle = bundle
        self.fault = fault
        self.exe = Executor(place)
        # an artifact-booted replica: its plans come from the store's
        # records where they match (paddle_tpu_torch/aot)
        self.exe.aot_store = store
        self.scope = Scope()
        bundle.load_params_into(self.scope, self.exe.device)

    def run(self, feeds) -> list:
        if self.fault is not None:
            self.fault.before_dispatch(self.index)
        self.bundle.check_feeds(feeds)
        return list(self.exe.run(self.bundle.program, feed=feeds,
                                 fetch_list=list(self.bundle.fetch_names),
                                 scope=self.scope))


class ReplicaPool:
    """N supervised replicas pulling coalesced batches from one queue."""

    def __init__(self, bundle: ModelBundle, queue: RequestQueue,
                 spec: BatchSpec, replicas: int = 1, place=None,
                 fault: Optional[FaultInjector] = None,
                 max_attempts: int = 3, heartbeat: float = 1.0,
                 dispatch_timeout: Optional[float] = None,
                 artifact_store=None):
        self.bundle = bundle
        self.artifact_store = artifact_store
        self.queue = queue
        self.spec = spec
        self._place = place
        self.fault = fault
        self.configured = max(1, int(replicas))
        self.max_attempts = max(1, int(max_attempts))
        self.heartbeat = max(0.01, float(heartbeat))
        # a dispatch is one forward; anything resembling a lease TTL
        # (heartbeat x N) past it is a wedged card, floored so a slow
        # first kernel build never reads as a hang.
        self.dispatch_timeout = (float(dispatch_timeout)
                                 if dispatch_timeout
                                 else max(30.0, self.heartbeat * 30.0))

        self._lock = threading.Lock()
        self._stopping = threading.Event()
        self._live: Dict[int, Replica] = {}
        self._threads: Dict[int, threading.Thread] = {}
        self._dead: set = set()
        self._inflight: Dict[int, Tuple[List[PendingRequest], float]] = {}
        self._next_index = 0
        self._pending_respawns = 0
        self._next_respawn_at = 0.0
        self._restarts: Deque[float] = collections.deque()
        self._restarts_total = 0
        self._budget_exhausted = False

        for _ in range(self.configured):
            rep = Replica(bundle, self._next_index, place, fault=fault,
                          store=artifact_store)
            self._next_index += 1
            self._spawn_worker(rep)
        _M_LIVE.set(len(self._live))

        self._supervisor_thread = threading.Thread(
            target=self._supervise, daemon=True, name="serving-supervisor")
        self._supervisor_thread.start()

    # -- introspection -------------------------------------------------------

    @property
    def replicas(self) -> List[Replica]:
        with self._lock:
            return list(self._live.values())

    def info(self) -> dict:
        with self._lock:
            return {
                "configured": self.configured,
                "live": len(self._live),
                "dead": len(self._dead),
                "restarts": self._restarts_total,
                "pending_respawns": self._pending_respawns,
                "max_attempts": self.max_attempts,
                "heartbeat_s": self.heartbeat,
                "dispatch_timeout_s": self.dispatch_timeout,
                "restart_budget_exhausted": self._budget_exhausted,
            }

    def degraded_reasons(self) -> List[str]:
        """Why /health should say ``degraded`` (empty list = healthy)."""
        reasons = []
        with self._lock:
            live = len(self._live)
            if live < self.configured:
                reasons.append(f"replicas_down:{self.configured - live}")
            if live == 0:
                reasons.append("no_live_replicas")
            if self._budget_exhausted and self._pending_respawns:
                reasons.append("restart_budget_exhausted")
        return reasons

    # -- lifecycle ----------------------------------------------------------

    def pause(self) -> None:
        """Stop workers from taking new batches (drain / maintenance /
        deterministic overload in tests).  In-flight batches finish;
        queued requests wait and expire against their deadlines."""
        self.queue.pause()

    def resume(self) -> None:
        self.queue.resume()

    def stop(self) -> None:
        self._stopping.set()
        self.queue.close()
        with self._lock:
            threads = dict(self._threads)
            dead = set(self._dead)
        for idx, t in threads.items():
            # zombie threads (hung dispatch) are daemons: don't let one
            # wedge shutdown for its full hang
            t.join(timeout=1.0 if idx in dead else 30.0)
        self._supervisor_thread.join(timeout=5.0)

    def warmup(self, buckets: Optional[Sequence[int]] = None) -> int:
        """Run the bucket ladder once on every replica with zero batches,
        so the first live request finds the kernels built and the
        executors' plans cached.  Returns the number of (replica,
        bucket) runs; the wall time lands in
        ``serving_time_to_ready_seconds{boot=}``."""
        if not self.spec.batchable:
            return 0
        buckets = tuple(buckets or bucket_ladder(self.queue.max_batch))
        reps = self.replicas
        t0 = time.monotonic()

        def _one(rep):
            for b in buckets:
                rep.run({name: np.zeros((b,) + self.spec.row_shapes[name],
                                        dtype=self.spec.dtypes[name])
                         for name in self.spec.feed_names})

        # map() re-raises a replica's warmup error here
        with concurrent.futures.ThreadPoolExecutor(len(reps)) as ex:
            list(ex.map(_one, reps))
        _M_TTR.observe(time.monotonic() - t0, boot=self.boot_source())
        return len(buckets) * len(reps)

    def boot_source(self) -> str:
        """``aot`` / ``plan`` / ``mixed``: where the live replicas' run
        plans came from (their Executors' ``compile_counts``): every one
        from the artifact store, every one built by its Executor, or some
        of each (``paddle_tpu/serving/replica.py:409-421``, whose ``jit``
        is the port's ``plan``)."""
        built = aot = 0
        for rep in self.replicas:
            counts = rep.exe.compile_counts
            built += counts.get("plan", 0)
            aot += counts.get("aot", 0)
        if aot and not built:
            return "aot"
        return "mixed" if (built and aot) else "plan"

    # -- worker loop --------------------------------------------------------

    def _spawn_worker(self, rep: Replica) -> None:
        t = threading.Thread(target=self._worker, args=(rep,), daemon=True,
                             name=f"serving-replica-{rep.index}")
        with self._lock:
            self._live[rep.index] = rep
            self._threads[rep.index] = t
        t.start()

    def _worker(self, rep: Replica) -> None:
        idx = rep.index
        while True:
            with self._lock:
                if idx in self._dead:
                    return
            batch = self.queue.take()
            if batch is None:
                return
            # a requeued request may have been completed by a zombie of
            # the replica that originally took it — don't run it twice
            batch = [r for r in batch if not r.done]
            if not batch:
                continue
            with self._lock:
                swept = idx in self._dead
                if not swept:
                    self._inflight[idx] = (batch, time.monotonic())
            if swept:
                # declared dead between take() and here: hand the work
                # back untouched (attempts were already stamped; the
                # requeue path tolerates that)
                self.queue.requeue(batch)
                return
            try:
                self._execute(rep, batch)
            except BaseException as exc:  # noqa: BLE001 - replica-fatal
                cause = ("injected" if isinstance(exc, ReplicaDied)
                         else "exception")
                self._mark_dead(idx, cause=cause, exc=exc)
                return
            finally:
                with self._lock:
                    self._inflight.pop(idx, None)
            with self._lock:
                if idx in self._dead:
                    # hang-swept while executing: our completions stand
                    # (first-wins) but a zombie takes no more work
                    return

    def _execute(self, rep: Replica, batch: List[PendingRequest]) -> None:
        try:
            if len(batch) == 1 and not batch[0].batchable:
                # exact-shape path: a ragged, LoD or odd-shaped request,
                # counted by reason
                req = batch[0]
                _M_BATCH_ROWS.observe(req.rows, bucket="unbatched")
                _M_UNBATCHED.inc(reason=req.solo_reason)
                req.complete(rep.run(req.feeds))
                return
            feeds, rows, bucket = coalesce(batch, self.spec)
            _M_BATCH_ROWS.observe(rows, bucket=str(bucket))
            for req in batch:
                req.bucket = bucket
            outs = rep.run(feeds)
            scatter(batch, outs, bucket)
        except _REQUEST_ERRORS as exc:
            # the request's fault, not the replica's: fail the waiters,
            # keep serving
            for req in batch:
                req.fail(exc)

    # -- supervision --------------------------------------------------------

    def _mark_dead(self, index: int, cause: str,
                   exc: Optional[BaseException] = None) -> None:
        with self._lock:
            rep = self._live.pop(index, None)
            if rep is None:
                return  # already swept by the other path
            batch, _ = self._inflight.pop(index, (None, 0.0))
            self._dead.add(index)
            self._pending_respawns += 1
            now = time.monotonic()
            streak = sum(1 for t in self._restarts
                         if now - t <= RESTART_WINDOW_S)
            self._next_respawn_at = max(
                self._next_respawn_at,
                now + RESPAWN_POLICY.for_attempt(streak))
            live = len(self._live)
        _M_DEATHS.inc(cause=cause)
        _M_LIVE.set(live)
        if batch:
            self._requeue_batch(batch, exc)

    def _requeue_batch(self, batch: List[PendingRequest],
                       exc: Optional[BaseException]) -> None:
        retry: List[PendingRequest] = []
        for req in batch:
            if req.done:
                continue
            if req.attempts >= self.max_attempts:
                req.fail(RetryExhausted(
                    f"request quarantined after {req.attempts} dispatch "
                    f"attempts, each of which lost its replica "
                    f"(last error: {exc!r})"))
                continue
            # redispatch solo so a poison row can't take a second set of
            # innocent batchmates down with it
            req.batchable = False
            req.solo_reason = "requeued"
            retry.append(req)
        if retry:
            _M_REQUEUED.inc(len(retry))
            self.queue.requeue(retry)

    def _supervise(self) -> None:
        while not self._stopping.wait(min(self.heartbeat, 0.25)):
            now = time.monotonic()
            with self._lock:
                hung = [idx for idx, (_, t0) in self._inflight.items()
                        if idx in self._live
                        and now - t0 > self.dispatch_timeout]
            for idx in hung:
                self._mark_dead(
                    idx, cause="hang",
                    exc=TimeoutError(
                        f"replica {idx} dispatch exceeded "
                        f"{self.dispatch_timeout:.1f}s lease"))
            self._maybe_respawn()

    def _maybe_respawn(self) -> None:
        with self._lock:
            if self._pending_respawns <= 0 or self._stopping.is_set():
                return
            now = time.monotonic()
            while (self._restarts and
                   now - self._restarts[0] > RESTART_WINDOW_S):
                self._restarts.popleft()
            if len(self._restarts) >= MAX_RESTARTS:
                self._budget_exhausted = True
                return
            self._budget_exhausted = False
            if now < self._next_respawn_at:
                return
            self._pending_respawns -= 1
            index = self._next_index
            self._next_index += 1
            self._restarts.append(now)
        try:
            rep = Replica(self.bundle, index, self._place, fault=self.fault,
                          store=self.artifact_store)
        except Exception:
            # params/device unavailable right now: put the slot back and
            # retry next sweep with more backoff
            with self._lock:
                self._pending_respawns += 1
                self._next_respawn_at = (
                    time.monotonic() +
                    RESPAWN_POLICY.for_attempt(len(self._restarts)))
            return
        if self._stopping.is_set():
            return
        self._spawn_worker(rep)
        with self._lock:
            self._restarts_total += 1
            live = len(self._live)
        _M_RESTARTS.inc()
        _M_LIVE.set(live)
