"""The kernel tuner: measured launch configs behind the wrappers that pick
a launch parameter from the shape (``paddle_tpu/pallas/tuning``).

- ``space.py``   -- a family per tunable kernel: its candidate configs at
  a shape, each valid by the wrapper's own predicate, and its harness;
- ``measure.py`` -- device time by CUDA events, each candidate first
  held against the kernel's plain version (a miss is infeasible);
- ``db.py``      -- the JSON database keyed by (kernel, shape bucket,
  dtype, device kind);
- ``bucket.py``  -- the power-of-two ladder shared with the serving
  bucketer;
- ``tune.py``    -- ``paddle tune``.

Dispatch: a wrapper whose launch has a runtime parameter asks ``lookup``
for its (kernel, shape, dtype); it re-checks a hit against the actual
shape with its own predicate and keeps its own choice on a miss or an
invalid hit.  With an empty database (the shipped one) ``live`` is
False once the database is read, and the wrappers test it before they
call ``lookup``: one attribute read a launch, and every launch, route and
result as without the tuner.  A lookup is memoized per (kernel, shape,
dtype, device kind) and database, and counted in
``tuning_db_lookup_total{kernel, result}`` the first time.

``PADDLE_TPU_TUNING_DB`` names the database (a path, or ``off``, ``0``,
``none``, ``disabled`` for none).
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, Optional, Sequence

from paddle_tpu_torch.kernels.tuning.bucket import (  # noqa: F401
    bucket_dim, bucket_ladder, bucket_shape)
from paddle_tpu_torch.kernels.tuning.db import (  # noqa: F401
    DEFAULT_PATH, SCHEMA, TuningDB, current_device_kind, make_key,
    normalize_device_kind)

_LOCK = threading.Lock()
_UNSET = object()
_MISS = object()
_STATE: Dict[str, Any] = {"db": _UNSET}
_MEMO: Dict[tuple, Any] = {}

#: False once the active database is known to hold no entry: the
#: wrappers skip ``lookup`` then.  True while it is unread.
live = True

_M_LOOKUP = None


def _lookup_metric():
    global _M_LOOKUP
    if _M_LOOKUP is None:
        from paddle_tpu_torch.observability import metrics as _metrics

        _M_LOOKUP = _metrics.counter(
            "tuning_db_lookup_total",
            "kernel-dispatch tuning-database consultations by result "
            "(hit = the database has an entry for the shape's bucket, its "
            "config possibly the default; miss = none, the wrapper's own "
            "choice); counted once per shape and database, not per launch")
    return _M_LOOKUP


def _resolve_default() -> TuningDB:
    env = os.environ.get("PADDLE_TPU_TUNING_DB", "")
    if env.lower() in ("off", "0", "none", "disabled"):
        return TuningDB()
    return TuningDB.load_or_empty(env or DEFAULT_PATH)


def _install(db) -> None:
    global live
    _STATE["db"] = db
    _MEMO.clear()
    live = db is _UNSET or bool(db.entries)


def get_db() -> TuningDB:
    """The process's active database (read once, then kept)."""
    with _LOCK:
        if _STATE["db"] is _UNSET:
            _install(_resolve_default())
        return _STATE["db"]


def set_db(db: "TuningDB | str | None") -> None:
    """Swap the active database: a ``TuningDB``, a path, or None to read
    ``PADDLE_TPU_TUNING_DB`` (or the shipped one) again on next use."""
    with _LOCK:
        if db is None:
            _install(_UNSET)
        elif isinstance(db, str):
            _install(TuningDB.load_or_empty(db))
        else:
            _install(db)


def disable() -> None:
    """Every wrapper's own choice for this process (an empty DB)."""
    set_db(TuningDB())


def lookup(kernel: str, shape: Sequence[int], dtype: str,
           device_kind: Optional[str] = None) -> Optional[Dict[str, Any]]:
    """The tuned config for ``kernel`` at ``shape``'s bucket, or None
    (the wrapper's own choice).  The caller re-checks a config against
    the actual shape: an entry tuned at the bucket's shape need not fit a
    smaller shape of the bucket.  The returned dict is shared: read it,
    do not change it."""
    db = _STATE["db"]
    if db is _UNSET:
        db = get_db()
    if not db.entries:
        return None
    key = (kernel, tuple(shape), dtype, device_kind)
    cfg = _MEMO.get(key, _MISS)
    if cfg is not _MISS:
        return cfg
    cfg = db.lookup(kernel, shape, dtype,
                    device_kind or current_device_kind())
    _MEMO[key] = cfg
    try:
        _lookup_metric().inc(kernel=kernel,
                             result="miss" if cfg is None else "hit")
    except Exception:
        pass   # telemetry never sinks a launch
    return cfg


def dtype_name(dtype) -> str:
    """A torch dtype's key token: "float32", "bfloat16"."""
    return str(dtype).rsplit(".", 1)[-1]
