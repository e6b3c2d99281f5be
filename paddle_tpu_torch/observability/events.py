"""Host-side event recorder exporting Chrome-trace JSON
(``paddle_tpu/observability/events.py``).

``torch.profiler`` records the device timeline; this records the host
story (a plan build beside a cached step beside a serving request) as
complete ("X") events that ``chrome://tracing`` or Perfetto load next
to a profiler trace.  The ring is bounded (``max_events``), so an
always-on recorder cannot grow without limit under serving traffic.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
from typing import Any, Dict, List


class EventRecorder:
    """Thread-safe bounded ring of Chrome-trace events.

    Timestamps are microseconds since the recorder's epoch
    (``perf_counter`` based, monotonic), which is what the trace viewer
    expects; wall-clock anchoring is recorded once in metadata.
    """

    def __init__(self, max_events: int = 100_000):
        self._t0 = time.perf_counter()
        self._epoch_unix = time.time()
        self._events: collections.deque = collections.deque(maxlen=max_events)
        self._lock = threading.Lock()

    def now(self) -> float:
        """Seconds since the recorder epoch."""
        return time.perf_counter() - self._t0

    def complete(self, name: str, start: float, dur: float,
                 cat: str = "paddle", **args):
        """Record a complete ("X") event; ``start``/``dur`` in seconds
        on the ``now()`` clock."""
        ev: Dict[str, Any] = {
            "name": name, "cat": cat, "ph": "X",
            "ts": start * 1e6, "dur": max(dur, 0.0) * 1e6,
            "pid": os.getpid(), "tid": threading.get_ident(),
        }
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "paddle", **args):
        t0 = self.now()
        try:
            yield
        finally:
            self.complete(name, t0, self.now() - t0, cat, **args)

    def instant(self, name: str, cat: str = "paddle", **args):
        ev: Dict[str, Any] = {
            "name": name, "cat": cat, "ph": "i", "s": "t",
            "ts": self.now() * 1e6,
            "pid": os.getpid(), "tid": threading.get_ident(),
        }
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def clear(self):
        """Drop recorded events.  The epoch is deliberately NOT rebased:
        a span in flight on another thread (serving handlers) captured
        its start against the current epoch, and rebasing would give it
        a garbage/negative timestamp when it completes."""
        with self._lock:
            self._events.clear()

    def to_chrome_trace(self) -> dict:
        return {
            "traceEvents": self.events(),
            "displayTimeUnit": "ms",
            "otherData": {
                "recorder": "paddle_tpu_torch.observability",
                "epoch_unix_sec": self._epoch_unix,
            },
        }

    def export(self, path: str) -> str:
        """Write ``chrome://tracing``-loadable JSON; returns ``path``."""
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)
        return path


GLOBAL_EVENTS = EventRecorder()
