"""Default-scope helpers (``paddle_tpu/default_scope_funcs.py``;
reference: python/paddle/v2/fluid/default_scope_funcs.py, a
thread-local scope stack with enter/leave and var lookup in the
innermost scope), over the port's ``Scope`` and ``global_scope``."""

from __future__ import annotations

import functools
import threading

from paddle_tpu_torch.executor import Scope, global_scope

__all__ = ["get_cur_scope", "enter_local_scope", "leave_local_scope",
           "var", "find_var", "scoped_function"]

_local = threading.local()


def _stack():
    if not hasattr(_local, "stack"):
        _local.stack = [global_scope()]
    return _local.stack


def get_cur_scope() -> Scope:
    return _stack()[-1]


def enter_local_scope() -> Scope:
    s = get_cur_scope().new_scope()
    _stack().append(s)
    return s


def leave_local_scope():
    stack = _stack()
    if len(stack) > 1:
        stack.pop()


def var(name: str):
    return get_cur_scope().var(name)


def find_var(name: str):
    return get_cur_scope().find_var(name)


def scoped_function(fn):
    """Run ``fn`` inside a fresh local scope (decorator or direct)."""
    @functools.wraps(fn)
    def wrapper(*a, **k):
        enter_local_scope()
        try:
            return fn(*a, **k)
        finally:
            leave_local_scope()

    return wrapper
