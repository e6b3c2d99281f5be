"""IR-level autodiff: ``append_backward`` (the port of
``paddle_tpu/backward.py``).

Walk the block in reverse, emit one ``<type>_grad`` op per relevant
forward op, sum the gradients of shared vars (``@RENAME`` + ``sum``),
and return (param, grad) pairs for the optimizer.  For the same Program
it emits the same ops, names and attrs as the JAX package, so a program
trained by either package serialises the same.

Consecutive relevant ops of one rematerialization segment
(``recompute_scope``) get one ``recompute_segment_grad`` op in place of
their per-op grads (``paddle_tpu/backward.py:102-151, 221-245``): it
replays the segment's forward from the segment's external inputs.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from paddle_tpu_torch.framework import (Block, Operator, Parameter, Variable,
                                        grad_var_name, is_float_dtype,
                                        unique_name)
from paddle_tpu_torch.registry import OpRegistry


def _ensure_grad_var(block: Block, fwd_name: str, grad_name: str) -> Variable:
    if block.has_var(grad_name):
        return block.var(grad_name)
    fwd = block.find_var(fwd_name)
    return block.create_var(
        name=grad_name,
        shape=fwd.shape if fwd is not None else None,
        dtype=fwd.dtype if fwd is not None else "float32",
        lod_level=fwd.lod_level if fwd is not None else 0,
        stop_gradient=True,
    )


def _wants_grad(block: Block, name: str, no_grad_set: Set[str]) -> bool:
    if not name or name in no_grad_set:
        return False
    var = block.find_var(name)
    if var is None or var.stop_gradient:
        return False
    return is_float_dtype(var.dtype)


def _make_grad_op_desc(
    op: Operator, block: Block, no_grad_set: Set[str]
) -> Optional[Tuple[str, Dict, Dict, Dict]]:
    """Default grad-op maker: the grad op reads every forward input and
    output and the output grads, and writes the grads of the
    differentiable inputs ("" where none is wanted)."""
    info = OpRegistry.get(op.type)
    if info.stop_gradient:
        return None
    if info.grad_maker is not None:
        return info.grad_maker(op, block, no_grad_set)

    inputs: Dict[str, List[str]] = {}
    for slot, names in op.inputs.items():
        inputs[slot] = list(names)
    for slot, names in op.outputs.items():
        inputs[slot] = list(names)
        inputs[slot + "@GRAD"] = [grad_var_name(n) for n in names]

    outputs: Dict[str, List[str]] = {}
    any_grad = False
    for slot, names in op.inputs.items():
        if info.diff_inputs is not None and slot not in info.diff_inputs:
            continue
        gnames = []
        for n in names:
            if _wants_grad(block, n, no_grad_set):
                gnames.append(grad_var_name(n))
                any_grad = True
            else:
                gnames.append("")
        outputs[slot + "@GRAD"] = gnames
    if not any_grad:
        return None

    attrs = {
        "__fwd_type__": op.type,
        "__fwd_inputs__": {k: list(v) for k, v in op.inputs.items()},
        "__fwd_outputs__": {k: list(v) for k, v in op.outputs.items()},
        "__fwd_attrs__": dict(op.attrs),
    }
    return (op.type + "_grad", inputs, outputs, attrs)


def _append_segment_grad(block, seg_id, fwd_ops, no_grad, _settle,
                         _contribute, pending):
    """One grad op for a whole rematerialization segment (forward-order
    ``fwd_ops``): inputs are the segment's external activations/params
    plus the settled grads of its externally-consumed outputs; outputs
    are grads of every differentiable external input."""
    produced: Set[str] = set()
    ext_in: List[str] = []
    for op in fwd_ops:
        for ns in op.inputs.values():
            for n in ns:
                if n and n not in produced and n not in ext_in:
                    ext_in.append(n)
        for ns in op.outputs.values():
            produced.update(n for n in ns if n)

    # externally-consumed outputs = those with grad contributions from
    # already-processed (later) consumers
    ext_out = [n for n in sorted(produced) if pending.get(n)]
    if not ext_out:
        return
    gout_names = []
    for n in ext_out:
        g = _settle(n)
        gout_names.append(g if g is not None else "")

    gin_names = []
    for n in ext_in:
        if _wants_grad(block, n, no_grad):
            gn = grad_var_name(n)
            if pending.get(n):
                gn = unique_name(gn + "@RENAME")
            _ensure_grad_var(block, n, gn)
            gin_names.append(gn)
            _contribute(n, gn)
        else:
            gin_names.append("")

    key_name = f"__segkey_{seg_id}__"
    ins = {"X": list(ext_in), "OutGrad": gout_names}
    if block.find_var(key_name) is not None:
        ins["SegKey"] = [key_name]
    block.append_op(
        type="recompute_segment_grad",
        inputs=ins,
        outputs={"X@GRAD": gin_names},
        attrs={"__seg_ops__": list(fwd_ops),
               "__seg_inputs__": list(ext_in),
               "__seg_outputs__": list(ext_out),
               "__seg_id__": seg_id})


def append_backward(
    loss: Variable,
    parameter_list: Optional[Sequence[str]] = None,
    no_grad_set: Optional[Set[str]] = None,
) -> List[Tuple[Parameter, Variable]]:
    """Append gradient ops for ``loss`` to its program's global block and
    return (parameter, gradient) pairs."""
    program = loss.block.program
    block = program.global_block()
    no_grad = set(no_grad_set or ())

    # Backward slice: which vars influence the loss.
    relevant: Set[str] = {loss.name}
    relevant_ops: List[Operator] = []
    for op in reversed(block.ops):
        if OpRegistry.get(op.type, none_ok=True) is None:
            continue
        if relevant & set(op.output_arg_names):
            relevant_ops.append(op)  # already reverse order
            relevant |= set(op.input_arg_names)

    # Seed d(loss)/d(loss) = 1.
    loss_grad = _ensure_grad_var(block, loss.name, grad_var_name(loss.name))
    block.append_op(
        type="fill_constant",
        outputs={"Out": [loss_grad.name]},
        attrs={"shape": list(loss.shape or ()), "value": 1.0,
               "dtype": loss.dtype},
    )

    # pending[fwd_name] = grad var names contributed by consumers.
    pending: Dict[str, List[str]] = {loss.name: [loss_grad.name]}

    def _settle(name: str) -> Optional[str]:
        """Materialize the final (summed) gradient of forward var
        ``name`` as grad_var_name(name); None if nothing contributed."""
        contribs = pending.get(name, [])
        target = grad_var_name(name)
        if not contribs:
            return None
        if len(contribs) == 1:
            src = contribs[0]
            if src != target:
                _ensure_grad_var(block, name, target)
                block.append_op(type="assign", inputs={"X": [src]},
                                outputs={"Out": [target]})
            pending[name] = [target]
            return target
        _ensure_grad_var(block, name, target)
        block.append_op(type="sum", inputs={"X": contribs},
                        outputs={"Out": [target]})
        pending[name] = [target]
        return target

    def _contribute(name: str, grad_name: str):
        pending.setdefault(name, []).append(grad_name)

    # group consecutive relevant ops of one rematerialization segment:
    # one recompute_segment_grad op replaces their per-op grads
    grouped: List[Any] = []
    for op in relevant_ops:  # already reverse order
        seg = op.attr("__recompute_seg__", None)
        if seg is not None and grouped and grouped[-1][0] == seg:
            grouped[-1][1].append(op)
        else:
            grouped.append((seg, [op]))

    for seg, seg_rev_ops in grouped:
        if seg is not None:
            _append_segment_grad(block, seg, list(reversed(seg_rev_ops)),
                                 no_grad, _settle, _contribute, pending)
            continue
        op = seg_rev_ops[0]
        desc = _make_grad_op_desc(op, block, no_grad)
        if desc is None:
            continue
        gtype, ginputs, goutputs, gattrs = desc

        # Settle incoming output-grads; skip ops no grad reaches.
        have_any_outgrad = False
        for slot, names in list(op.outputs.items()):
            gslot = slot + "@GRAD"
            if gslot not in ginputs:
                continue
            settled = []
            for n in names:
                g = _settle(n)
                settled.append(g if g is not None else "")
                have_any_outgrad = have_any_outgrad or g is not None
            ginputs[gslot] = settled
        if not have_any_outgrad:
            continue

        # Rename grad outputs of vars that already have contributions
        # (a var read by several ops: rename now, sum when settled).
        for slot, gnames in goutputs.items():
            fwd_names = ginputs.get(slot[: -len("@GRAD")], [])
            fixed = []
            for i, gn in enumerate(gnames):
                if not gn:
                    fixed.append("")
                    continue
                fwd_n = fwd_names[i] if i < len(fwd_names) else None
                if fwd_n is not None and pending.get(fwd_n):
                    gn = unique_name(gn + "@RENAME")
                if fwd_n is not None:
                    _ensure_grad_var(block, fwd_n, gn)
                    _contribute(fwd_n, gn)
                fixed.append(gn)
            goutputs[slot] = fixed

        block.append_op(type=gtype, inputs=ginputs, outputs=goutputs,
                        attrs=gattrs)

    # Settle parameter gradients.
    if parameter_list is not None:
        params = [block.var(p) if isinstance(p, str) else p
                  for p in parameter_list]
    else:
        params = [p for p in block.all_parameters() if p.trainable]

    result: List[Tuple[Parameter, Variable]] = []
    for p in params:
        if p.name in no_grad:
            continue
        g = _settle(p.name)
        if g is None:
            continue
        gvar = block.var(g)
        # regularization: grad += decay(param), appended here
        if getattr(p, "regularizer", None) is not None:
            g = p.regularizer.append_regularization_op(p, gvar, block)
            gvar = block.var(g) if isinstance(g, str) else g
        result.append((p, gvar))
    return result
