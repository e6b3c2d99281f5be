"""Diagnostics helpers shared by entry scripts and tests
(``paddle_tpu/diagnostics.py``)."""

from __future__ import annotations

import contextlib
import os
import sys
import tempfile


@contextlib.contextmanager
def capture_stderr_fd():
    """Capture fd 2: what native code writes there (a compiler's
    warnings, a CUDA library's messages) bypasses ``sys.stderr``.  The
    captured text is written out again on exit, so outer log scrapers
    still see it.  The yielded getter returns '' until the context
    exits."""
    captured = {"text": ""}
    saved = os.dup(2)
    tmp = tempfile.TemporaryFile(mode="w+b")
    sys.stderr.flush()
    os.dup2(tmp.fileno(), 2)
    try:
        yield lambda: captured["text"]
    finally:
        sys.stderr.flush()
        os.dup2(saved, 2)
        os.close(saved)
        tmp.seek(0)
        captured["text"] = tmp.read().decode("utf-8", "replace")
        tmp.close()
        sys.stderr.write(captured["text"])
        sys.stderr.flush()
