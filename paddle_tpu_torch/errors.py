"""Error types and ``enforce`` (``paddle_tpu/errors.py``; reference:
paddle/platform/enforce.h PADDLE_ENFORCE, invariant checks with
contextual messages, and paddle/utils/Error.h, the legacy
error-carrying return type).

Python surfaces errors as exceptions; this module gives them the
reference's taxonomy so callers can catch categories, plus ``enforce``
for invariant checks inside ops and layers."""

from __future__ import annotations


class PaddleError(Exception):
    """Base of the framework's error taxonomy."""


class EnforceNotMet(PaddleError):
    """An invariant failed (PADDLE_ENFORCE)."""


class InvalidArgumentError(PaddleError):
    pass


class NotFoundError(PaddleError):
    pass


class AlreadyExistsError(PaddleError):
    pass


class UnavailableError(PaddleError):
    """Resource or service unreachable (pserver down, device missing)."""


def enforce(cond, msg: str = "", *fmt_args):
    """PADDLE_ENFORCE(cond, fmt, ...) (platform/enforce.h:257)."""
    if not cond:
        raise EnforceNotMet(msg % fmt_args if fmt_args else msg)
