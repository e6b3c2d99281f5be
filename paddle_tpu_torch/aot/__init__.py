"""AOT serving artifacts: cut the cold start (``paddle_tpu/aot``).

``paddle compile`` exports a model's serving plans -- the run plan of
every bucket a replica would build at boot -- and the kernel libraries
they launch into a versioned artifact directory (``artifact.py``).
``paddle serve --artifacts=DIR`` boots replicas from that store: the
Executor consults it at every plan-cache miss and, on a manifest match,
builds the plan from the entry's record without the verifier and the
classification, the donation mask proved again; ``kernels/_build`` loads
the store's libraries before it would run ``nvcc``.  A CUDA graph is not
a file: it is still captured on a plan's second run in a scope, as a
plan-booted replica's is.  Any mismatch -- versions, the card, the tuning
database, the flags, the fingerprint, a corrupt record or library,
donation drift, a library built from other sources -- is a loud fallback
counted in ``aot_load_total{result}``: slower, never wrong.

A store reaches the plans through an Executor's ``aot_store`` (the
serving replica pool sets each replica's), and the kernel libraries,
loaded once a process, through ``attach(store)``.

``capture(writer)`` is the export side: inside it every plan an Executor
builds is recorded into ``writer``.
"""

from __future__ import annotations

import contextlib
from typing import Optional

from paddle_tpu_torch.aot.artifact import (ArtifactStore, ArtifactWriter,
                                           MANIFEST_NAME, SCHEMA)
from paddle_tpu_torch.aot.export import export_generator, export_model

__all__ = [
    "ArtifactStore", "ArtifactWriter", "MANIFEST_NAME", "SCHEMA",
    "active_exporter", "active_store", "attach", "capture", "detach",
    "export_generator", "export_model",
]

_ACTIVE_STORE: Optional[ArtifactStore] = None
_ACTIVE_EXPORTER: Optional[ArtifactWriter] = None


def attach(store: ArtifactStore) -> ArtifactStore:
    """Make ``store`` the process-wide store that the kernel libraries'
    loader (``kernels/_build.load``) consults."""
    global _ACTIVE_STORE
    _ACTIVE_STORE = store
    return store


def detach() -> None:
    global _ACTIVE_STORE
    _ACTIVE_STORE = None


def active_store() -> Optional[ArtifactStore]:
    return _ACTIVE_STORE


def active_exporter() -> Optional[ArtifactWriter]:
    return _ACTIVE_EXPORTER


@contextlib.contextmanager
def capture(writer: ArtifactWriter):
    """Every plan an Executor builds inside the block is recorded into
    ``writer`` (and runs as it would without the capture)."""
    global _ACTIVE_EXPORTER
    prev = _ACTIVE_EXPORTER
    _ACTIVE_EXPORTER = writer
    try:
        yield writer
    finally:
        _ACTIVE_EXPORTER = prev
