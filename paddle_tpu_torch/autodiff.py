"""Generic gradient lowering by replaying the forward rule under autograd
(the port of ``paddle_tpu/autodiff.py``).

A ``<type>_grad`` op emitted by ``append_backward`` carries its forward
op's desc in attrs.  If the forward op registered no explicit
``grad_lower``, the grad op runs this rule: rebuild the forward
computation from the run's values with the differentiated inputs as
fresh leaves, run it under ``torch.enable_grad()`` (the Executor runs
every op under ``no_grad``), and pull the incoming cotangents through
with ``torch.autograd.grad``.

The replay is a second forward of the op, which XLA's CSE removes in the
JAX package but eager PyTorch pays for.  The ops whose forward launches
a CUDA kernel (conv2d, batch_norm, mul, softmax) therefore register
explicit grad rules: a ctypes launch is opaque to autograd, and the
replay must never reach one.  An op that keeps a kernel's residual for
its backward (the LSTM's gates) passes its own ``lower``: the replay
then differentiates the op's plain tensor code around a residual-fed
autograd function instead of launching the kernel again.

A LoDArray primal is differentiated through its ``data``: the leaf is
the packed rows, rewrapped with the primal's offsets for the replay, and
its gradient comes back as a LoDArray with those offsets, as
``paddle_tpu/autodiff.py:54-56, 127-128`` has it.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from paddle_tpu_torch.lod import rewrap, unwrap
from paddle_tpu_torch.registry import LowerContext, OpInfo, OpRegistry


class _OpProxy:
    """Operator-shaped view used to replay a forward lowering."""

    __slots__ = ("type", "inputs", "outputs", "attrs", "block")

    def __init__(self, type, inputs, outputs, attrs, block):
        self.type = type
        self.inputs = inputs
        self.outputs = outputs
        self.attrs = attrs
        self.block = block

    def input(self, slot):
        return self.inputs.get(slot, [])

    def output(self, slot):
        return self.outputs.get(slot, [])

    def attr(self, name, default=None):
        return self.attrs.get(name, default)

    @property
    def input_arg_names(self):
        return [n for ns in self.inputs.values() for n in ns]

    @property
    def output_arg_names(self):
        return [n for ns in self.outputs.values() for n in ns]


def generic_grad_lower(ctx: LowerContext, lower=None):
    """The grad op's outputs by replaying the forward rule (or ``lower``,
    a stand-in with the forward rule's contract) under autograd."""
    gop = ctx.op
    # the forward op this grad op was made from, rebuilt from its attrs
    fwd = _OpProxy(gop.attr("__fwd_type__"), gop.attr("__fwd_inputs__"),
                   gop.attr("__fwd_outputs__"), gop.attr("__fwd_attrs__"),
                   gop.block)
    fwd_inputs: Dict[str, List[str]] = fwd.inputs
    base = OpRegistry.get(fwd.type)

    # Leaf inputs that need grads: (fwd_name, grad_name).
    targets = []
    for gslot, gnames in gop.outputs.items():
        fnames = fwd_inputs.get(gslot[: -len("@GRAD")], [])
        for i, gn in enumerate(gnames):
            if gn:
                targets.append((fnames[i], gn))
    if not targets:
        return

    # Only outputs the forward lowering actually wrote.
    out_names = [(slot, i, n) for slot in sorted(fwd.outputs)
                 for i, n in enumerate(fwd.outputs[slot]) if n in ctx.values]

    local: Dict[str, Any] = {n: ctx.values[n] for ns in fwd_inputs.values()
                             for n in ns if n}
    # one leaf per target; a var in two slots keeps the last one, and the
    # earlier target's grad comes out zero (the two sum to the whole, as
    # the JAX package's replay has it)
    leaves = [unwrap(ctx.values[fn]).detach().requires_grad_(True)
              for fn, _ in targets]
    for (fn, _), leaf in zip(targets, leaves):
        local[fn] = rewrap(ctx.values[fn], leaf)
    with torch.enable_grad():
        (lower or base.lower)(LowerContext(fwd, local, ctx.device, None))
    outs, cts = [], []
    for slot, i, n in out_names:
        out = unwrap(local[n])
        if not (isinstance(out, torch.Tensor) and out.requires_grad):
            continue
        gnames = gop.inputs.get(slot + "@GRAD", [])
        gname = gnames[i] if i < len(gnames) else ""
        g = ctx.values.get(gname) if gname else None
        if g is None:
            continue  # a zero cotangent adds nothing
        outs.append(out)
        cts.append(unwrap(g).to(out.dtype))
    grads = (torch.autograd.grad(outs, leaves, cts, allow_unused=True)
             if outs else [None] * len(leaves))
    for (fn, gn), g in zip(targets, grads):
        primal = ctx.values[fn]
        if g is None:
            g = torch.zeros_like(unwrap(primal))
        ctx.values[gn] = rewrap(primal, g.detach())


def synthesize_grad_info(grad_type: str) -> OpInfo:
    """Build (and register) an OpInfo for ``<base>_grad`` on demand."""
    base = OpRegistry.get(grad_type[: -len("_grad")])
    lower = base.grad_lower if base.grad_lower is not None else generic_grad_lower
    info = OpInfo(type=grad_type, lower=lower, stop_gradient=True)
    OpRegistry._ops[grad_type] = info
    return info
