"""Mixed precision hooks of the matmul and conv rules.

The JAX package casts operands to bf16 when AMP is on
(``paddle_tpu/amp.py``).  This slice serves in float32, so AMP is off:
operands keep their dtype and sums run in float32.
"""

from __future__ import annotations

import torch


def cast_operands(*xs):
    return xs


def out_dtype(x) -> torch.dtype:
    """Output dtype for a matmul/conv given input x (pre-cast)."""
    return x.dtype


def preferred_acc() -> torch.dtype:
    """The accumulation dtype of dot/conv."""
    return torch.float32
