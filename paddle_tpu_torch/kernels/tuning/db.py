"""The tuning database: measured launch configs, one JSON document
(``paddle_tpu/pallas/tuning/db.py``).

- schema-versioned (``paddle_tpu.tuning_db.v1``, the JAX package's
  schema): a loader rejects a document of another schema rather than
  misread it;
- keyed by ``kernel|shape-bucket|dtype|device-kind``, the shape bucket
  rounding every dimension up the serving engine's power-of-two ladder
  (``bucket.py``), so one measured config covers a bucket;
- written atomically (a tmp file, then ``os.replace``) and merged, not
  clobbered, on a re-tune: tuning one kernel never drops another's
  entries.

Dispatch reads it through ``lookup`` in ``tuning/__init__``; a wrapper
keeps its own choice on a miss, so with no database, or an empty one, every
launch is the one it is without the tuner.  The device kind on the card is
``torch.cuda.get_device_name(0)`` normalized ("NVIDIA H100 80GB HBM3" ->
"nvidia_h100_80gb_hbm3"); without a card it is "cpu".
"""

from __future__ import annotations

import functools
import json
import os
import tempfile
from typing import Any, Dict, Optional, Sequence

from paddle_tpu_torch.kernels.tuning.bucket import bucket_shape

SCHEMA = "paddle_tpu.tuning_db.v1"

#: The database shipped beside this module (empty: every wrapper's own
#: choice).
DEFAULT_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "tuning_db.json")


def make_key(kernel: str, shape: Sequence[int], dtype: str,
             device_kind: str) -> str:
    """The key of a query shape: the shape is bucketed here, so every
    shape of a bucket finds the same entry."""
    dims = "x".join(str(d) for d in bucket_shape(shape))
    return f"{kernel}|{dims}|{dtype}|{device_kind}"


class TuningDB:
    """The tuning document in memory: {key: record}.

    A record is ``{"config": {...}, "time_ms", "default_time_ms",
    "speedup", "n_configs", "n_infeasible", "shape": [...]}``; dispatch
    reads only ``config``, the rest says where it came from."""

    def __init__(self, entries: Optional[Dict[str, dict]] = None,
                 path: Optional[str] = None):
        self.entries: Dict[str, dict] = dict(entries or {})
        self.path = path

    def lookup(self, kernel: str, shape: Sequence[int], dtype: str,
               device_kind: str) -> Optional[Dict[str, Any]]:
        rec = self.entries.get(make_key(kernel, shape, dtype, device_kind))
        if rec is None:
            return None
        cfg = rec.get("config")
        return dict(cfg) if isinstance(cfg, dict) else None

    def __len__(self) -> int:
        return len(self.entries)

    def put(self, kernel: str, shape: Sequence[int], dtype: str,
            device_kind: str, record: dict) -> str:
        key = make_key(kernel, shape, dtype, device_kind)
        self.entries[key] = dict(record)
        return key

    @classmethod
    def load(cls, path: str) -> "TuningDB":
        """Parse a tuning document.  Raises ValueError on another schema
        and passes IO and JSON errors on; ``load_or_empty`` tolerates
        them."""
        with open(path) as f:
            doc = json.load(f)
        if not isinstance(doc, dict) or doc.get("schema") != SCHEMA:
            got = doc.get("schema") if isinstance(doc, dict) else None
            raise ValueError(
                f"tuning db {path}: schema {got!r} != {SCHEMA!r}; re-run "
                "`paddle tune` to regenerate")
        return cls(doc.get("entries", {}), path=path)

    @classmethod
    def load_or_empty(cls, path: str) -> "TuningDB":
        """Dispatch's loader: a missing, corrupt or foreign-schema file
        is an empty DB (every wrapper's own choice), never a crash."""
        try:
            return cls.load(path)
        except (ValueError, OSError):
            return cls(path=path)

    def save(self, path: Optional[str] = None,
             merge_existing: bool = True) -> str:
        """Write atomically: a tmp file in the target's directory, then
        ``os.replace``, so no reader sees a torn document.  Where the
        target holds a valid DB, its entries are merged under ours."""
        path = path or self.path or DEFAULT_PATH
        entries = self.entries
        if merge_existing and os.path.exists(path):
            try:
                entries = dict(TuningDB.load(path).entries)
                entries.update(self.entries)
            except (ValueError, OSError):
                pass   # an unreadable target: overwrite it with ours
        doc = {"schema": SCHEMA, "entries": dict(sorted(entries.items()))}
        d = os.path.dirname(os.path.abspath(path)) or "."
        fd, tmp = tempfile.mkstemp(prefix=".tuning_db_", suffix=".tmp",
                                   dir=d)
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(doc, f, indent=1)
                f.write("\n")
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        self.path = path
        return path


def normalize_device_kind(kind: str) -> str:
    """'NVIDIA H100 80GB HBM3' -> 'nvidia_h100_80gb_hbm3' (a stable key
    token)."""
    return "_".join(kind.strip().lower().split())


@functools.lru_cache(maxsize=1)
def current_device_kind() -> str:
    """The normalized name of CUDA card 0, or "cpu" without a card."""
    try:
        import torch

        if torch.cuda.is_available():
            return normalize_device_kind(torch.cuda.get_device_name(0))
        return "cpu"
    except Exception:
        return "unknown"
