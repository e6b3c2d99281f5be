"""Retry and backoff policy (``paddle_tpu/distributed/retry.py``;
reference: go/connection/conn.go's reconnect-with-retry and the Go
master client's exponential backoff, go/master/client.go:62).

- exponential backoff (``base_delay * multiplier**attempt``) capped at
  ``max_delay``, with proportional random jitter so a fleet retrying a
  restarted service does not reconnect in lockstep;
- an overall ``deadline`` (seconds from the first attempt) on top of the
  attempt cap: whichever is hit first ends the retry budget;
- only transport errors are retried (``retry_on``); application errors
  propagate at once.

Every retry is counted in the telemetry registry:
``rpc_retries_total{client,op}``, ``rpc_retry_exhausted_total{client,op}``
and ``rpc_backoff_seconds_total{client,op}``.  The serving supervisor
paces the respawns it drives itself with ``for_attempt``.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, replace
from typing import Callable, Iterator, Optional, Tuple, Type

from paddle_tpu_torch.observability import metrics as _metrics

_M_RETRIES = _metrics.counter(
    "rpc_retries_total", "RPC re-attempts after a retryable failure")
_M_EXHAUSTED = _metrics.counter(
    "rpc_retry_exhausted_total", "RPC calls that ran out of retry budget")
_M_BACKOFF = _metrics.counter(
    "rpc_backoff_seconds_total", "total seconds slept in retry backoff")


@dataclass(frozen=True)
class RetryPolicy:
    """Retry budget: attempt cap, exponential backoff shape, deadline."""

    max_attempts: int = 5
    base_delay: float = 0.05
    max_delay: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.25          # +/- fraction of the computed delay
    deadline: Optional[float] = None   # seconds from the first attempt
    retry_on: Tuple[Type[BaseException], ...] = (ConnectionError, OSError)

    def with_(self, **kw) -> "RetryPolicy":
        return replace(self, **kw)

    def for_attempt(self, n: int,
                    rng: Optional[random.Random] = None) -> float:
        """Backoff delay after failure ``n`` (0-based: ``for_attempt(0)``
        is the sleep before the second try).

        The undithered delay is ``d = min(base_delay * multiplier**n,
        max_delay)``; with ``jitter`` j the value is uniform in
        ``[d * (1 - j), d * (1 + j)]`` (floored at 0), so its expectation
        stays ``d``.
        """
        rng = rng or random
        d = min(self.base_delay * (self.multiplier ** max(int(n), 0)),
                self.max_delay)
        if self.jitter:
            d *= 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
        return max(d, 0.0)

    def delays(self, rng: Optional[random.Random] = None) -> Iterator[float]:
        """Backoff delay before attempt 2, 3, ... (max_attempts-1
        values); each is ``for_attempt(i)`` for i = 0, 1, ..."""
        for i in range(max(self.max_attempts - 1, 0)):
            yield self.for_attempt(i, rng)


#: Five attempts over roughly a second: long enough to ride out a
#: service restart, short enough not to mask a dead cluster.
DEFAULT_POLICY = RetryPolicy()

#: Patient policy for a supervisor's control-plane calls.
SUPERVISOR_POLICY = RetryPolicy(max_attempts=8, base_delay=0.1,
                                max_delay=3.0, deadline=30.0)


def retry_call(fn: Callable, *args, policy: RetryPolicy = DEFAULT_POLICY,
               client: str = "rpc", op: str = "call",
               on_retry: Optional[Callable[[BaseException], None]] = None,
               rng: Optional[random.Random] = None, **kwargs):
    """Run ``fn(*args, **kwargs)`` under the policy's retry budget.

    ``on_retry(exc)`` fires between attempts.  Raises the last error
    once the budget (attempts or deadline) is spent.
    """
    t0 = time.monotonic()
    delays = policy.delays(rng)
    while True:
        try:
            return fn(*args, **kwargs)
        except policy.retry_on as e:
            delay = next(delays, None)
            overdue = (policy.deadline is not None and
                       time.monotonic() - t0 + (delay or 0.0)
                       > policy.deadline)
            if delay is None or overdue:
                _M_EXHAUSTED.inc(client=client, op=op)
                raise
            if on_retry is not None:
                on_retry(e)
            _M_RETRIES.inc(client=client, op=op)
            _M_BACKOFF.inc(delay, client=client, op=op)
            time.sleep(delay)
