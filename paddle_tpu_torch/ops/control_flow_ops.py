"""Control-flow ops over sub-blocks: ``recurrent``, the step-block RNN
that ``layers.StaticRNN`` builds (``paddle_tpu/ops/control_flow_ops.py:
72-112``).  ``while`` and ``conditional_block`` wait for the LoD
control-flow slice.

The JAX package traces the step block into one ``lax.scan``; here the op
runs it once a time step, eagerly, on a values map of its own
(``executor.run_block``): the time-major slice of each batch-major
input, the memories, and the values the block reads from the enclosing
scope.  Its gradient, ``recurrent_grad``, is the generic replay
(``autodiff.generic_grad_lower``): the loop again under autograd, as the
JAX package takes the vjp of the whole scan.  The step block's kernel
ops (``mul``) launch through their ``torch.autograd.Function`` there,
and a raw kernel launch that autograd would record raises
(``kernels/_build.refuse_recording``)."""

from __future__ import annotations

import torch

from paddle_tpu_torch import framework
from paddle_tpu_torch.lod import unwrap
from paddle_tpu_torch.registry import register_op


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
    outer = ctx.values
    seqs = [unwrap(v) for v in ctx.inputs("Inputs")]
    states = [unwrap(v) for v in ctx.inputs("InitStates")]
    base = {n: outer[n] for n in framework._sub_block_external_reads(ctx.op)
            if n in outer}
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
