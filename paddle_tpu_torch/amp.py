"""Automatic mixed precision (the port of ``paddle_tpu/amp.py``).

When enabled, the matmul and conv rules (``mul``, ``conv2d``) cast their
float32 or float64 operands to bfloat16, sum in float32 inside the
kernels, and keep bf16 activations; parameters, optimizer state and
gradients stay float32 (master weights), because each rule's grad brings
a cast operand's gradient back to the operand's own dtype.  Training
batch norm then normalizes bf16 activations with float32 statistics.
bf16 keeps float32's exponent range, so no loss scaling is needed.

The state is module-global, as in the JAX package; ``Executor.run``
reads it once and runs a program's forward and grad ops under it.
"""

from __future__ import annotations

import contextlib

import torch

_STATE = {"enabled": False}


def enable(flag: bool = True) -> None:
    _STATE["enabled"] = bool(flag)


def is_enabled() -> bool:
    return _STATE["enabled"]


def compute_dtype():
    """bf16 when AMP is on, else None (keep the operands' dtype)."""
    return torch.bfloat16 if _STATE["enabled"] else None


@contextlib.contextmanager
def amp_guard(flag: bool = True):
    """AMP on (or off) inside the block; the previous state after it,
    also when the block raises."""
    old = _STATE["enabled"]
    _STATE["enabled"] = bool(flag)
    try:
        yield
    finally:
        _STATE["enabled"] = old


def cast_operands(*xs):
    dt = compute_dtype()
    if dt is None:
        return xs
    return tuple(x.to(dt) if x.dtype in (torch.float32, torch.float64)
                 else x for x in xs)


def out_dtype(x) -> torch.dtype:
    """Output dtype for a matmul/conv given input x (pre-cast)."""
    dt = compute_dtype()
    return (dt if dt is not None and x.dtype in (torch.float32,
                                                 torch.bfloat16)
            else x.dtype)


def preferred_acc():
    """The JAX rules' ``preferred_element_type``: None under AMP (bf16 in
    and out, f32 sums inside the product), float32 otherwise.  The port's
    kernels and plain versions always sum in float32 and round once to
    the output dtype, which is what both settings compute."""
    return None if is_enabled() else torch.float32
