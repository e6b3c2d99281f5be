"""Shared helpers for op lowerings."""

from __future__ import annotations

import torch

from paddle_tpu_torch.lod import rewrap, unwrap

_TORCH_DTYPES = {
    "bool": torch.bool,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
}


def torch_dtype(name: str) -> torch.dtype:
    return _TORCH_DTYPES[name]


def broadcast_to_x(x, y, axis: int = -1):
    """Reference elementwise broadcast rule: Y's dims align to a
    contiguous run of X's dims starting at ``axis`` (-1 = trailing)."""
    x_ = unwrap(x)
    y_ = unwrap(y)
    if x_.shape == y_.shape:
        return y_
    # the default axis aligns Y's ORIGINAL rank to X's trailing dims,
    # computed before the trailing-1 trim
    if axis == -1:
        axis = x_.ndim - y_.ndim
    yshape = list(y_.shape)
    while yshape and yshape[-1] == 1 and len(yshape) > 1:
        yshape = yshape[:-1]
    full = [1] * x_.ndim
    for i, s in enumerate(yshape):
        full[axis + i] = s
    return torch.reshape(y_, full)


def elementwise(ctx, fn):
    x = ctx.input("X")
    y = ctx.input("Y")
    axis = ctx.attr("axis", -1)
    out = fn(unwrap(x), broadcast_to_x(x, y, axis))
    ctx.set_output("Out", rewrap(x, out))


def clip(x, lo, hi):
    """``jnp.clip``: min(max(x, lo), hi) over tensor bounds, whose backward
    splits a tie's gradient in half between x and the bound, as JAX's
    max and min do (``torch.clamp`` passes all of it to x)."""
    lo, hi = (v.to(x.dtype) if isinstance(v, torch.Tensor)
              else torch.full((), v, dtype=x.dtype, device=x.device)
              for v in (lo, hi))
    return torch.minimum(torch.maximum(x, lo), hi)


def absolute(x):
    """``jnp.abs``: |x| with gradient 1 at 0 (``torch.abs`` gives 0)."""
    return torch.where(x >= 0, x, -x)


def top_k(x, k: int):
    """(values, indices) of the ``k`` largest along the last axis, the
    lower index first among equal values, as ``lax.top_k`` orders them
    (``torch.topk`` leaves ties in no set order): a stable sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def unary(ctx, fn, slot_in="X", slot_out="Out"):
    x = ctx.input(slot_in)
    ctx.set_output(slot_out, rewrap(x, fn(unwrap(x))))


# --- explicit grad rules ---------------------------------------------------


def grad_in(ctx, slot: str):
    """The value of a grad op's incoming gradient slot (``Out@GRAD``),
    or None where no gradient reached it."""
    names = ctx.op.input(slot)
    return ctx.values.get(names[0]) if names and names[0] else None


def grad_out(ctx, slot: str):
    """The name a grad op writes ``slot`` (``X@GRAD``) to, or None where
    that gradient is not wanted."""
    names = ctx.op.output(slot)
    return names[0] if names and names[0] else None
