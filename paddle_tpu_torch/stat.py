"""Timer and stat registry (``paddle_tpu/stat.py``; reference:
paddle/utils/Stat.h:63-233, where REGISTER_TIMER / REGISTER_TIMER_INFO
accumulate into a global StatSet printed every N batches or each pass,
enabled with WITH_TIMER).

Host-side timers measure the interpreter and driver path (data feed,
feed conversion, dispatch); device time belongs to ``torch.profiler``
(``paddle_tpu_torch.profiler``).  The metrics layer with labels,
histograms and the Prometheus exposition is
``paddle_tpu_torch.observability``, whose table formatter
``print_status`` goes through.
"""

from __future__ import annotations

import contextlib
import functools
import sys
import threading
import time
from typing import Dict

from paddle_tpu_torch.observability.metrics import format_table


class StatItem:
    __slots__ = ("total", "count", "max")

    def __init__(self):
        self.total = 0.0
        self.count = 0
        self.max = 0.0

    def add(self, dt: float):
        self.total += dt
        self.count += 1
        if dt > self.max:
            self.max = dt


class StatSet:
    def __init__(self, name: str = "GlobalStatInfo"):
        self.name = name
        self._items: Dict[str, StatItem] = {}
        self._lock = threading.Lock()

    def add(self, key: str, dt: float):
        with self._lock:
            self._items.setdefault(key, StatItem()).add(dt)

    def reset(self):
        with self._lock:
            self._items.clear()

    def items(self):
        with self._lock:
            return dict(self._items)

    def print_status(self, out=None):
        """The per-pass dump (Stat.h printAllStatus), through the shared
        table formatter."""
        out = out or sys.stderr
        rows = [
            (key, f"{it.total * 1e3:.2f}",
             f"{it.total / max(it.count, 1) * 1e3:.3f}",
             f"{it.max * 1e3:.3f}", str(it.count))
            for key, it in sorted(self.items().items(),
                                  key=lambda kv: -kv[1].total)
        ]
        print(f"======= StatSet: [{self.name}] =======", file=out)
        print(format_table(rows, headers=("timer", "total_ms", "avg_ms",
                                          "max_ms", "count")), file=out)


GLOBAL_STATS = StatSet()


@contextlib.contextmanager
def timer(name: str, stats: StatSet = None):
    """``with stat.timer("forwardBackward"):``, REGISTER_TIMER."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        (stats or GLOBAL_STATS).add(name, time.perf_counter() - t0)


def timed(name: str, stats: StatSet = None):
    """Decorator form of ``timer``; the wrapper keeps the wrapped
    function's name and docstring."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*a, **k):
            with timer(name, stats):
                return fn(*a, **k)

        return wrapper

    return deco
