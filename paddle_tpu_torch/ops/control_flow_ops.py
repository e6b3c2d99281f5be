"""Control-flow ops over sub-blocks (``paddle_tpu/ops/control_flow_ops.py``):
``recurrent``, the step-block RNN that ``layers.StaticRNN`` builds,
``while`` and ``conditional_block``, the tensor-array ops,
``max_sequence_len``, ``select_where`` (the ``IfElse`` merge),
``is_empty`` and ``multiplex``.

The JAX package traces a sub-block into one ``lax.scan``,
``lax.while_loop`` or ``lax.cond``; here the op runs it eagerly on a
values map of its own (``executor.run_block``): the values the block
reads from the enclosing scope, and the loop state.  ``recurrent`` runs
its step block once a time step on the time-major slice of each
batch-major input and the memories.  Its gradient, ``recurrent_grad``,
is the generic replay (``autodiff.generic_grad_lower``): the loop again
under autograd, as the JAX package takes the vjp of the whole scan.  The
step block's kernel ops (``mul``) launch through their
``torch.autograd.Function`` there, and a raw kernel launch that autograd
would record raises (``kernels/_build.refuse_recording``).

``while`` carries the condition and every variable its block writes
that exists outside it, as the JAX op's ``lax.while_loop`` carries them;
the block's other values live one iteration.  Deciding whether to run
an iteration is one read of the condition on the host (a device sync on
the card); ``condition_reads`` counts them, one more than the
iterations.  ``while`` has no gradient, as in the JAX package.
``conditional_block`` reads its condition once and runs its block or
leaves its outputs as they were."""

from __future__ import annotations

import torch

from paddle_tpu_torch.analysis import dataflow
from paddle_tpu_torch.lod import LoDArray, LoDRankTable, unwrap
from paddle_tpu_torch.ops.common import torch_dtype
from paddle_tpu_torch.registry import SkipInferShape, register_op
from paddle_tpu_torch.tensor_array import TensorArray

#: host reads of a ``while`` or ``conditional_block`` condition
condition_reads = 0


def _holds(cond) -> bool:
    """A scalar condition's value on the host, counted."""
    global condition_reads
    condition_reads += 1
    return bool(unwrap(cond).reshape(()))


def _external(ctx):
    """The values ``ctx.op``'s sub-block reads from the enclosing scope."""
    return {n: ctx.values[n] for n in dataflow.sub_block_external_reads(
        ctx.op) if n in ctx.values}


@register_op("recurrent",
             inputs=("Inputs", "InitStates", "Params"),
             outputs=("Outputs", "FinalStates"))
def _recurrent(ctx):
    """StaticRNN: the step block once per time step with linked memories.

    attrs: sub_block, state_names (the memories the block reads),
    state_update_names (the vars holding each memory's next value),
    step_input_names (the per-step slices, aligned with Inputs),
    step_output_names, reverse.  Inputs are batch-major (B, T, ...); step
    t sees their (B, ...) slices at t, walking T backward with
    ``reverse``; each output stacks its steps on axis 1."""
    from paddle_tpu_torch.executor import run_block   # imports the ops

    sub = ctx.attr("sub_block")
    state_names = ctx.attr("state_names")
    state_update_names = ctx.attr("state_update_names")
    step_input_names = ctx.attr("step_input_names")
    step_output_names = ctx.attr("step_output_names")
    seqs = [unwrap(v) for v in ctx.inputs("Inputs")]
    states = [unwrap(v) for v in ctx.inputs("InitStates")]
    base = _external(ctx)
    steps = seqs[0].shape[1]
    outs = [[None] * steps for _ in step_output_names]
    order = range(steps - 1, -1, -1) if ctx.attr("reverse", False) \
        else range(steps)
    for t in order:
        values = dict(base)
        values.update(zip(state_names, states))
        values.update((n, s[:, t]) for n, s in zip(step_input_names, seqs))
        run_block(sub, values, ctx.device, ctx._generator)
        states = [values[n] for n in state_update_names]
        for per_step, n in zip(outs, step_output_names):
            per_step[t] = unwrap(values[n])
    for name, per_step in zip(ctx.op.output("Outputs"), outs):
        ctx.values[name] = torch.stack(per_step, 1)
    for name, state in zip(ctx.op.output("FinalStates"), states):
        if name:
            ctx.values[name] = state


@register_op("while", inputs=("X", "Condition"), outputs=("Out", "StepScopes"),
             stop_gradient=True)
def _while(ctx):
    """The sub-block while ``Condition`` holds (``:38-70``).  The loop
    state is the condition and each variable the block writes that the
    enclosing scope already holds; it goes back there after the loop."""
    from paddle_tpu_torch.executor import run_block

    sub = ctx.attr("sub_block")
    cond_name = ctx.op.input("Condition")[0]
    outer = ctx.values
    written = dict.fromkeys(n for op_ in sub.ops
                            for n in op_.output_arg_names if n)
    carry_names = [cond_name] + [n for n in written
                                 if n in outer and n != cond_name]
    base = _external(ctx)
    carry = {n: outer[n] for n in carry_names}
    while _holds(carry[cond_name]):
        values = dict(base)
        values.update(carry)
        run_block(sub, values, ctx.device, ctx._generator)
        carry = {n: values[n] for n in carry_names}
    outer.update(carry)


@register_op("conditional_block", inputs=("Cond", "X"),
             outputs=("Out", "Scope"))
def _conditional_block(ctx):
    """The sub-block once where the scalar ``Cond`` holds; otherwise each
    Out keeps the value it had, so each must be set before the op, as
    the JAX op's ``lax.cond`` passes them through (``:115-137``)."""
    from paddle_tpu_torch.executor import run_block

    out_names = [n for n in ctx.op.output("Out") if n]
    init = {n: ctx.values[n] for n in out_names}
    if not _holds(ctx.inputs("Cond")[0]):
        return
    values = _external(ctx)
    values.update(init)
    run_block(ctx.attr("sub_block"), values, ctx.device, ctx._generator)
    for n in out_names:
        ctx.values[n] = values[n]


# --- tensor arrays ---------------------------------------------------------


@register_op("create_array", inputs=(), stop_gradient=True)
def _create_array(ctx):
    """An empty TensorArray of ``capacity`` slots of ``elem_shape``."""
    ctx.set_output("Out", TensorArray.create(
        ctx.attr("capacity", 64), tuple(ctx.attr("elem_shape")),
        torch_dtype(ctx.attr("dtype", "float32")), ctx.device))


@register_op("write_to_array", inputs=("X", "I", "Array"))
def _write_to_array(ctx):
    ctx.set_output("Out", ctx.input("Array").write(unwrap(ctx.input("I")),
                                                   unwrap(ctx.input("X"))))


@register_op("read_from_array", inputs=("X", "I"))
def _read_from_array(ctx):
    ctx.set_output("Out", ctx.input("X").read(unwrap(ctx.input("I"))))


@register_op("lod_array_length", inputs=("X",), stop_gradient=True)
def _lod_array_length(ctx):
    ctx.set_output("Out", ctx.input("X").length.reshape(1).long())


@register_op("max_sequence_len", inputs=("RankTable",), stop_gradient=True)
def _max_sequence_len(ctx):
    """The longest length of a rank table or a LoD value, or the time
    axis of a padded one, as a scalar tensor."""
    x = ctx.input("RankTable")
    if isinstance(x, LoDRankTable):
        out = x.lengths.max().reshape(())
    elif isinstance(x, LoDArray):
        out = x.seq_lens().max().reshape(())
    else:
        out = torch.full((), unwrap(x).shape[1], dtype=torch.int32,
                         device=unwrap(x).device)
    ctx.set_output("Out", out)


@register_op("select_where", inputs=("Cond", "X", "Y"), diff_inputs=("X", "Y"))
def _select_where(ctx):
    """Row-wise select, the IfElse merge: Out[i] = X[i] where Cond[i],
    else Y[i], Cond's trailing dims broadcast."""
    cond = unwrap(ctx.inputs("Cond")[0]).bool()
    x = unwrap(ctx.input("X"))
    y = unwrap(ctx.input("Y"))
    while cond.ndim < x.ndim:
        cond = cond[..., None] if cond.ndim else cond.reshape((1,))
    ctx.set_output("Out", torch.where(cond, x, y))


@register_op("is_empty", inputs=("X",), stop_gradient=True)
def _is_empty(ctx):
    x = unwrap(ctx.input("X"))
    ctx.set_output("Out", torch.full((), x.numel() == 0, dtype=torch.bool,
                                     device=x.device))


def _infer_multiplex_shape(op, block):
    """Out picks one row per index from the stacked candidates: it
    mirrors any single candidate's shape."""
    xs = op.inputs.get("X", [])
    outs = op.outputs.get("Out", [])
    if not xs or not xs[0] or len(outs) != 1 or not outs[0]:
        raise SkipInferShape
    xv, ov = block.find_var(xs[0]), block.find_var(outs[0])
    if xv is None or ov is None or xv.shape is None:
        raise SkipInferShape
    if ov.shape is None:
        ov.shape = tuple(xv.shape)


@register_op("multiplex", inputs=("Ids", "X"), diff_inputs=("X",),
             infer_shape=_infer_multiplex_shape)
def _multiplex(ctx):
    """Row i of Out is row i of candidate Ids[i]."""
    ids = unwrap(ctx.input("Ids")).reshape(-1).long()
    xs = torch.stack([unwrap(v) for v in ctx.inputs("X")])   # (K, N, ...)
    ctx.set_output("Out", xs[ids, torch.arange(ids.shape[0],
                                               device=ids.device)])
