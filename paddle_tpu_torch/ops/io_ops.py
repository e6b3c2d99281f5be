"""The rematerialization ops and ``fill`` (``paddle_tpu/ops/io_ops.py``):
``segment_rng_key`` and ``recompute_segment_grad``, which
``framework.recompute_scope`` and ``append_backward`` emit, and ``fill``,
which the optimizer's constant folding emits.  The rest of the JAX
module (feed/fetch as ops, save, load, print, cond) is not ported yet.

``recompute_segment_grad`` replays its segment's forward from the
segment's external inputs under ``torch.enable_grad()`` (the Executor
runs every op under ``no_grad``) and pulls the cotangents through with
``torch.autograd.grad``, as ``autodiff.generic_grad_lower`` does for one
op.  Every kernel inside the segment then launches through its
``torch.autograd.Function`` (``Matmul``, ``FlashAttention``,
``Softmax``, ``ConvNHWC``, ``BatchNormTrain``, ``LSTMSeq``): the ops pick
it where autograd records, and ``kernels/_build.refuse_recording``
raises on a raw launch there.
"""

from __future__ import annotations

import weakref
from typing import Any, Dict

import numpy as np
import torch

from paddle_tpu_torch.lod import rewrap, unwrap
from paddle_tpu_torch.ops.common import torch_dtype
from paddle_tpu_torch.registry import (LowerContext, OpRegistry,
                                       SkipInferShape, register_op)

#: The JAX package's random ops; inside a recompute segment each draws
#: from a generator seeded by the segment's key and its own index.
RANDOM_OPS = frozenset({"uniform_random", "gaussian_random", "dropout",
                        "sampling_id", "random_crop", "nce"})


def segment_generator(key, op, device) -> torch.Generator:
    """The generator random op ``op`` of a recompute segment draws from,
    in the forward and in the backward replay alike: seeded by the
    segment's key and the op's stable ``__seg_rng_idx__``, so a replay
    that runs a pruned subset of the segment draws what the forward drew
    (``paddle_tpu/executor.py:269-276``, ``_segment_op_rng``)."""
    idx = int(op.attr("__seg_rng_idx__", 0))
    seed = (int(key) * 1000003 + idx) % (2 ** 63 - 1)
    return torch.Generator(device=device).manual_seed(seed)


def segment_op_generator(key, op, device, generator):
    """The generator an op of a recompute segment runs with: its own
    (``segment_generator``) for a random op when the segment has a key,
    else ``generator`` (the run's)."""
    if key is not None and op.type in RANDOM_OPS:
        return segment_generator(key, op, device)
    return generator


@register_op("segment_rng_key", inputs=(), stop_gradient=True)
def _segment_rng_key(ctx):
    """The key of one rematerialization segment: a draw from the run's
    generator where the run has one (the segment holds a random op),
    else 0, which no op reads.  The forward segment and its backward
    replay both derive their randomness from this one value."""
    gen = ctx.generator_or_none()
    if gen is None:
        key = torch.zeros((), dtype=torch.int64, device=ctx.device)
    else:
        key = torch.randint(0, 2 ** 62, (), generator=gen,
                            device=gen.device, dtype=torch.int64)
    ctx.set_output("Out", key)


@register_op("recompute_segment_grad", inputs=("X", "OutGrad", "SegKey"),
             stop_gradient=True)
def _recompute_segment_grad(ctx):
    """Backward of a rematerialization segment: replay the segment's
    forward from its external inputs under autograd (instead of reading
    saved intermediates) and pull the output cotangents through, so the
    segment's activations are never live across the forward->backward
    span (``paddle_tpu/ops/io_ops.py:260-300``)."""
    seg_ops = ctx.attr("__seg_ops__")
    ext_in = list(ctx.attr("__seg_inputs__"))
    ext_out = list(ctx.attr("__seg_outputs__"))
    key_names = ctx.op.input("SegKey")
    key = ctx.values.get(key_names[0]) if key_names else None

    local: Dict[str, Any] = {n: ctx.values[n] for n in ext_in}
    targets, leaves = [], []
    for n, gn in zip(ext_in, ctx.op.output("X@GRAD")):
        if not gn:
            continue
        leaf = unwrap(ctx.values[n]).detach().requires_grad_(True)
        local[n] = rewrap(ctx.values[n], leaf)
        targets.append((n, gn))
        leaves.append(leaf)
    if not targets:
        return
    with torch.enable_grad():
        for op in seg_ops:
            gen = segment_op_generator(key, op, ctx.device, None)
            OpRegistry.get(op.type).lower(
                LowerContext(op, local, ctx.device, gen))
    outs, cts = [], []
    for n, gn in zip(ext_out, ctx.op.input("OutGrad")):
        out = unwrap(local[n])
        if not gn or gn not in ctx.values or not (
                isinstance(out, torch.Tensor) and out.requires_grad):
            continue  # a zero cotangent adds nothing
        outs.append(out)
        cts.append(unwrap(ctx.values[gn]).to(out.dtype))
    grads = (torch.autograd.grad(outs, leaves, cts, allow_unused=True)
             if outs else [None] * len(leaves))
    for (n, gn), g in zip(targets, grads):
        primal = ctx.values[n]
        if g is None:
            g = torch.zeros_like(unwrap(primal))
        ctx.values[gn] = rewrap(primal, g.detach())


def _infer_fill_shape(op, block):
    outs = op.outputs.get("Out", [])
    if len(outs) != 1 or not outs[0]:
        raise SkipInferShape
    ov = block.find_var(outs[0])
    shape = op.attr("shape", None)
    if ov is None or not shape:
        raise SkipInferShape
    if ov.shape is None:
        ov.shape = tuple(int(s) for s in shape)


#: fill op -> {device: (its data attr, that data on the device)}
_FILL_DATA: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


@register_op("fill", inputs=(), stop_gradient=True,
             infer_shape=_infer_fill_shape)
def _fill(ctx):
    """Out = the ``data`` attr (a folded constant) as ``dtype`` and
    ``shape``, or ``value`` everywhere when there is no data.  The data
    reaches a device once, on the op's first run there (a plan's first
    run in a scope, which is never captured); every run then copies it
    on the device, so a plan that holds the op can be captured."""
    shape = tuple(int(s) for s in ctx.attr("shape", []))
    dtype = torch_dtype(str(ctx.attr("dtype", "float32")))
    raw = ctx.attr("data", None)
    if raw is None:
        out = torch.full(shape, ctx.attr("value", 0.0), dtype=dtype,
                         device=ctx.device)
    else:
        from paddle_tpu_torch.executor import tensor_from_numpy

        per_device = _FILL_DATA.setdefault(ctx.op, {})
        hit = per_device.get(ctx.device)
        if hit is None or hit[0] is not raw:
            hit = per_device[ctx.device] = (raw, tensor_from_numpy(
                np.asarray(raw), ctx.device).to(dtype).reshape(shape))
        out = hit[1].clone()
    ctx.set_output("Out", out)
