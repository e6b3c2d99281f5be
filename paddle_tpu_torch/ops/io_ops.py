"""The io and structural ops (``paddle_tpu/ops/io_ops.py``): ``feed`` and
``fetch`` (the identity), ``save`` and ``load`` (the single-tensor file
format of ``io.serialize_tensor_bytes``), ``print``, ``grad_printer``
and ``seq_text_printer`` (host-side printing), the legacy two-branch
``cond``, ``fill`` (which the optimizer's constant folding emits), and
the rematerialization ops ``segment_rng_key`` and
``recompute_segment_grad``, which ``framework.recompute_scope`` and
``append_backward`` emit.

The JAX package runs its host-side ops through ordered ``io_callback``s
inside the jitted step.  Here they run on the host as the plan reaches
them, so each holds an ``OpInfo.host_sync`` reason and its plan stays
eager: a captured CUDA graph replays no Python, and a print or a save
would happen once, at capture.  ``grad_printer`` itself is the identity
and captures; its grad op, which prints, does not.  ``load`` reads its
file on every run, where the JAX package reads it once, when it traces
the op, and keeps that value for as long as its compile cache holds the
program (ROADMAP Queue 3).  ``cond`` runs both sub-blocks over the whole
batch and merges their outputs row by row with ``torch.where``; it
reads nothing on the host and captures.

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

import os
import weakref
from typing import Any, Dict

import numpy as np
import torch

from paddle_tpu_torch.lod import LoDArray, rewrap, unwrap
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


# ---------------------------------------------------------------------------
# feed / fetch, save / load, cond
# ---------------------------------------------------------------------------


@register_op("feed", inputs=("X",), stop_gradient=True)
def _feed(ctx):
    ctx.set_output("Out", ctx.input("X"))


@register_op("fetch", inputs=("X",), stop_gradient=True)
def _fetch(ctx):
    ctx.set_output("Out", ctx.input("X"))


def _host_array(v) -> np.ndarray:
    """A value's data as numpy on the host (a LoD value's rows)."""
    from paddle_tpu_torch.executor import _to_numpy

    v = unwrap(v)
    return _to_numpy(v) if isinstance(v, torch.Tensor) else np.asarray(v)


@register_op("save", inputs=("X",), outputs=(), stop_gradient=True,
             host_sync="writes its value to a file on the host each run")
def _save(ctx):
    from paddle_tpu_torch.io import serialize_tensor_bytes

    path = ctx.attr("file_path")
    if not bool(ctx.attr("overwrite", True)) and os.path.exists(path):
        raise IOError(f"save op: {path} exists and overwrite=False")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(serialize_tensor_bytes(_host_array(ctx.input("X"))))


@register_op("load", inputs=(), stop_gradient=True,
             host_sync="reads its file and copies it to the device each run")
def _load(ctx):
    from paddle_tpu_torch.executor import tensor_from_numpy
    from paddle_tpu_torch.io import deserialize_tensor_bytes

    with open(ctx.attr("file_path"), "rb") as f:
        arr = deserialize_tensor_bytes(f.read())
    ctx.set_output("Out", tensor_from_numpy(arr, ctx.device))


@register_op("cond", inputs=("Cond", "Xs"), outputs=("Outs", "IndexTensors"))
def _cond(ctx):
    """The legacy two-branch cond (``operators/cond_op.cc``): rows where
    Cond holds take the true sub-block's outputs, the rest the false
    one's.  Both sub-blocks run over the whole batch."""
    from paddle_tpu_torch.executor import run_block

    mask = unwrap(ctx.input("Cond")).to(torch.bool).reshape(-1)
    out_names = [n for n in ctx.op.output("Outs") if n]

    def run(block):
        values = dict(ctx.values)
        run_block(block, values, ctx.device, ctx._generator)
        return [values[n] for n in out_names]

    t_outs = run(ctx.attr("true_block"))
    f_outs = run(ctx.attr("false_block"))
    for n, t, f in zip(out_names, t_outs, f_outs):
        t, f = unwrap(t), unwrap(f)
        m = mask.reshape((-1,) + (1,) * (t.dim() - 1))
        ctx.values[n] = torch.where(m, t, f)


# ---------------------------------------------------------------------------
# the printers
# ---------------------------------------------------------------------------


@register_op("print", inputs=("X",), stop_gradient=True,
             host_sync="prints its value on the host each run")
def _print(ctx):
    """Print X on the host, in the JAX op's text, and pass it on."""
    print(f"[print {ctx.attr('message', '')}]",
          _host_array(ctx.input("X")), flush=True)
    ctx.set_output("Out", ctx.input("X"))


def _grad_printer_grad_lower(ctx):
    """Print the incoming gradient on the host and pass it through
    unchanged (``gserver/evaluators/Evaluator.cpp`` GradientPrinter)."""
    gout = ctx.input("Out@GRAD")
    message = ctx.op.attr("__fwd_attrs__", {}).get("message", "")
    print(f"[grad {message}]", _host_array(gout), flush=True)
    ctx.values[ctx.op.output("X@GRAD")[0]] = gout


def _grad_printer_sync(op):
    # the forward is the identity; its grad op prints
    if op.type.endswith("_grad"):
        return "prints its gradient on the host each run"
    return None


@register_op("grad_printer", inputs=("X",),
             grad_lower=_grad_printer_grad_lower,
             host_sync=_grad_printer_sync)
def _grad_printer(ctx):
    """The identity; its grad op prints the gradient
    (gradient_printer_evaluator)."""
    ctx.set_output("Out", ctx.input("X"))


#: (weakref of the Scope, realpath) of each result file truncated in the
#: evaluation that Scope runs
_SEQTEXT_TRUNCATED = set()


@register_op("seq_text_printer", inputs=("X", "Id"), stop_gradient=True,
             host_sync="writes its rows to a text file on the host each run")
def _seq_text_printer(ctx):
    """Write id sequences as dictionary-translated lines ``id \\t tokens``
    to ``result_file`` (``Evaluator.cpp`` SequenceTextPrinter): the Id
    input where given, else the sequence's index.  A LoD X gives a line
    a sequence, a dense (N, W) X one a row.  The file is truncated once
    an evaluation, keyed, as in the JAX package, on the Scope active when
    the op runs, and appended to after that."""
    import paddle_tpu_torch.executor as executor_mod

    x = ctx.input("X")
    result_file = ctx.attr("result_file")
    dict_file = ctx.attr("dict_file", None)
    delimited = ctx.attr("delimited", True)
    words = None
    if dict_file:
        with open(dict_file) as f:
            words = [line.rstrip("\n") for line in f]
    sep = " " if (delimited is None or delimited) else ""

    if isinstance(x, LoDArray):
        data = _host_array(x.data)
        lengths = _host_array(x.seq_lens())
    else:
        data = _host_array(x)
        data = data.reshape(data.shape[0], -1)
        lengths = np.ones((data.shape[0],), np.int32)
    ids = (_host_array(ctx.input("Id")).astype(np.int64).reshape(-1)
           if ctx.op.input("Id") else np.zeros((0,), np.int64))
    lines = []
    row = 0
    for k, n in enumerate(lengths):
        n = int(n)
        seq = data[row:row + n].reshape(-1).astype(np.int64).tolist()
        row += n
        toks = [(words[i] if words and 0 <= i < len(words) else str(i))
                for i in seq]
        sid = int(ids[k]) if ids.size else k
        lines.append(f"{sid}\t" + sep.join(toks))

    scope = (executor_mod._scope_stack[-1]
             if executor_mod._scope_stack else None)
    key = (weakref.ref(scope) if scope is not None else None,
           os.path.realpath(result_file))
    mode = "a" if key in _SEQTEXT_TRUNCATED else "w"
    _SEQTEXT_TRUNCATED.add(key)
    # keys of collected Scopes go, so the set stays bounded
    _SEQTEXT_TRUNCATED.difference_update(
        [k for k in _SEQTEXT_TRUNCATED
         if k[0] is not None and k[0]() is None])
    with open(result_file, mode) as f:
        f.write("\n".join(lines) + ("\n" if lines else ""))
    ctx.set_output("Out", x)
