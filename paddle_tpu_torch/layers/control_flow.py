"""Control-flow layers (``paddle_tpu/layers/control_flow.py``): the
step-block RNNs ``StaticRNN`` and ``DynamicRNN``, which build a
``recurrent`` op over a sub-block; ``While`` (a ``while`` op over its
sub-block); ``IfElse``, whose branches both run over the whole batch and
merge row by row through ``select_where``; the tensor-array layers, the
LoD rank-table layers and the loop counter's ``increment`` and
``less_than``; and the guards and records the reference exported."""

from __future__ import annotations

from typing import List, Optional

from paddle_tpu_torch import framework
from paddle_tpu_torch.framework import Variable
from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = [
    "While", "StaticRNN", "IfElse", "DynamicRNN", "ConditionalBlock",
    "BlockGuard", "StaticRNNGuard", "StaticRNNMemoryLink", "WhileGuard",
    "increment", "less_than", "array_write", "array_read", "array_length",
    "create_array", "lod_rank_table", "max_sequence_len",
    "lod_tensor_to_array", "array_to_lod_tensor", "shrink_memory",
    "split_lod_tensor", "merge_lod_tensor",
]


def increment(x, value=1.0, in_place=True, **kwargs):
    helper = LayerHelper("increment", **kwargs)
    out = x if in_place else helper.create_tmp_variable(x.dtype, x.shape)
    helper.append_op(type="increment", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"step": float(value)})
    return out


def less_than(x, y, **kwargs):
    helper = LayerHelper("less_than", **kwargs)
    out = helper.create_tmp_variable("bool", x.shape)
    helper.append_op(type="less_than", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]})
    return out


def create_array(dtype, elem_shape, capacity: int = 64, **kwargs):
    helper = LayerHelper("array", **kwargs)
    out = helper.block.create_var(
        name=helper.name, dtype=dtype,
        type=framework.VarType.LOD_TENSOR_ARRAY)
    helper.append_op(type="create_array", outputs={"Out": [out]},
                     attrs={"dtype": dtype, "elem_shape": list(elem_shape),
                            "capacity": capacity})
    return out


def array_write(x, i, array, **kwargs):
    helper = LayerHelper("array_write", **kwargs)
    helper.append_op(type="write_to_array",
                     inputs={"X": [x], "I": [i], "Array": [array]},
                     outputs={"Out": [array]})
    return array


def array_read(array, i, **kwargs):
    """Slot ``i`` of ``array``; its shape is unknown to the Program (put
    a ``reshape`` after it where a layer needs one)."""
    helper = LayerHelper("array_read", **kwargs)
    out = helper.create_tmp_variable(array.dtype)
    helper.append_op(type="read_from_array", inputs={"X": [array], "I": [i]},
                     outputs={"Out": [out]})
    return out


def array_length(array, **kwargs):
    helper = LayerHelper("array_length", **kwargs)
    out = helper.create_tmp_variable("int64", (1,))
    helper.append_op(type="lod_array_length", inputs={"X": [array]},
                     outputs={"Out": [out]})
    return out


def _external_reads(block) -> List[str]:
    """Names a sub-block reads from enclosing scopes (read before any
    local write), in the order it first reads them."""
    written = set()
    external = []
    for op in block.ops:
        for n in op.input_arg_names:
            if n and n not in written and n not in external:
                if (block.parent is not None
                        and block.parent.find_var(n) is not None):
                    external.append(n)
        for n in op.output_arg_names:
            if n:
                written.add(n)
    return external


class While:
    """``while (cond) { sub_block }``.  The condition and the loop state
    are set before the loop and updated inside it.

        cond = layers.less_than(i, n)
        w = While(cond)
        with w.block():
            ... ops updating the state, i, and cond ...

    The ``while`` op reads the sub-block's external reads (X) and lists
    each variable of the enclosing block the sub-block writes (Out)."""

    def __init__(self, cond: Variable, name=None):
        self.helper = LayerHelper("while", name=name)
        self.cond_var = cond

    def block(self):
        return _SubBlockGuard(self)

    def _complete(self, sub_block):
        parent = self.helper.main_program.current_block()
        x = [n for n in _external_reads(sub_block) if n != self.cond_var.name]
        step_scopes = parent.create_var(
            name=self.helper.name + ".step_scopes",
            type=framework.VarType.STEP_SCOPES)
        out = [n for op in sub_block.ops for n in op.output_arg_names
               if n and parent.find_var(n) is not None]
        parent.append_op(
            type="while",
            inputs={"X": x, "Condition": [self.cond_var]},
            outputs={"Out": list(dict.fromkeys(out)),
                     "StepScopes": [step_scopes]},
            attrs={"sub_block": sub_block},
        )


class _SubBlockGuard:
    """``with w.block():`` — a new sub-block is current inside, and on a
    clean exit the owner's op goes into the parent block."""

    def __init__(self, owner):
        self.owner = owner

    def __enter__(self):
        self.block = self.owner.helper.main_program.create_block()
        return self.block

    def __exit__(self, exc_type, exc, tb):
        self.owner.helper.main_program.rollback()
        if exc_type is None:
            self.owner._complete(self.block)
        return False


class StaticRNN:
    """Step-block RNN, one ``recurrent`` op over its sub-block.

        rnn = StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(x)          # x: (B, T, D)
            h = rnn.memory(shape=[-1, H], batch_ref=x_t)   # or init=...
            new_h = some_layers(x_t, h)
            rnn.update_memory(h, new_h)
            rnn.step_output(new_h)
        out, = rnn()                          # (B, T, H)
    """

    def __init__(self, name=None):
        self.helper = LayerHelper("static_rnn", name=name)
        self._sub_block = None
        self._seq_inputs: List[Variable] = []   # outer (B, T, ...) vars
        self._step_inputs: List[Variable] = []  # in-block (B, ...) vars
        self._memories: List[Variable] = []     # in-block state vars
        self._mem_inits: List[Variable] = []    # outer init vars
        self._mem_updates: List[Optional[str]] = []
        self._outputs: List[Variable] = []
        self._reverse = False

    def step(self):
        return StaticRNNGuard(self)

    # -- inside-step API ----------------------------------------------------

    def step_input(self, x: Variable) -> Variable:
        self._seq_inputs.append(x)
        v = self._sub_block.create_var(
            name=self.helper.name + f".step_in_{len(self._step_inputs)}",
            shape=(x.shape[0],) + tuple(x.shape[2:]) if x.shape else None,
            dtype=x.dtype)
        self._step_inputs.append(v)
        return v

    def memory(self, init: Optional[Variable] = None, shape=None,
               batch_ref: Optional[Variable] = None, init_value=0.0,
               dtype="float32") -> Variable:
        if init is None:
            from paddle_tpu_torch.layers import tensor as tensor_layers

            # the init ops run once, before the loop: they belong to the
            # parent block
            prog = self.helper.main_program
            saved_idx = prog.current_block_idx
            prog.current_block_idx = self._sub_block.parent_idx
            try:
                if batch_ref is not None:
                    # a step input's batch dim is its outer sequence's
                    if batch_ref in self._step_inputs:
                        batch_ref = self._seq_inputs[
                            self._step_inputs.index(batch_ref)]
                    init = tensor_layers.fill_constant_batch_size_like(
                        batch_ref, shape, dtype, init_value)
                else:
                    init = tensor_layers.fill_constant(shape, dtype,
                                                       init_value)
            finally:
                prog.current_block_idx = saved_idx
        self._mem_inits.append(init)
        mem = self._sub_block.create_var(
            name=self.helper.name + f".mem_{len(self._memories)}",
            shape=init.shape, dtype=init.dtype)
        self._memories.append(mem)
        self._mem_updates.append(None)
        return mem

    def update_memory(self, mem: Variable, new: Variable):
        self._mem_updates[self._memories.index(mem)] = new.name

    def step_output(self, o: Variable):
        self._outputs.append(o)

    output = step_output

    def __call__(self):
        return self._result

    def _complete(self, sub_block):
        assert all(u is not None for u in self._mem_updates), \
            "every StaticRNN memory needs update_memory()"
        parent = self.helper.main_program.current_block()
        internal = ({v.name for v in self._step_inputs}
                    | {v.name for v in self._memories})
        params = [n for n in _external_reads(sub_block) if n not in internal
                  and n not in {v.name for v in self._seq_inputs}
                  and n not in {v.name for v in self._mem_inits}]
        outs = []
        for o in self._outputs:
            outs.append(parent.create_var(
                name=self.helper.name + f".out_{len(outs)}",
                shape=(None if o.shape is None else
                       (o.shape[0], None) + tuple(o.shape[1:])),
                dtype=o.dtype))
        finals = [
            parent.create_var(name=self.helper.name + f".final_{i}",
                              shape=m.shape, dtype=m.dtype)
            for i, m in enumerate(self._memories)
        ]
        parent.append_op(
            type="recurrent",
            inputs={"Inputs": self._seq_inputs,
                    "InitStates": self._mem_inits, "Params": params},
            outputs={"Outputs": outs, "FinalStates": finals},
            attrs={
                "sub_block": sub_block,
                "state_names": [m.name for m in self._memories],
                "state_update_names": list(self._mem_updates),
                "step_input_names": [v.name for v in self._step_inputs],
                "step_output_names": [o.name for o in self._outputs],
                "reverse": self._reverse,
            },
        )
        self._result = outs


class StaticRNNGuard:
    """``with rnn.step():`` — a new sub-block is current inside, and on a
    clean exit the parent block gets the ``recurrent`` op over it."""

    def __init__(self, rnn):
        self.rnn = rnn

    def __enter__(self):
        self.rnn._sub_block = self.rnn.helper.main_program.create_block()
        return self.rnn

    def __exit__(self, exc_type, exc, tb):
        prog = self.rnn.helper.main_program
        block = self.rnn._sub_block
        prog.rollback()
        if exc_type is None:
            self.rnn._complete(block)
        return False


BlockGuard = StaticRNNGuard
WhileGuard = StaticRNNGuard


class StaticRNNMemoryLink:
    """A memory link's record (init, pre_mem, mem), as the reference
    exported it; StaticRNN keeps its links itself."""

    def __init__(self, init, pre_mem, mem=None):
        self.init = init
        self.pre_mem = pre_mem
        self.mem = mem


class IfElse:
    """A batched conditional: both branches run over the whole batch and
    ``select_where`` merges their outputs row by row on ``cond`` (B, 1).

        ie = IfElse(cond)
        with ie.true_block():
            ie.output(then_value)
        with ie.false_block():
            ie.output(else_value)
        out, = ie()
    """

    def __init__(self, cond: Variable, name=None):
        self.helper = LayerHelper("ifelse", name=name)
        self.cond = cond
        self._true_outs: List[Variable] = []
        self._false_outs: List[Variable] = []
        self._phase = None

    def true_block(self):
        return _IfElsePhase(self, True)

    def false_block(self):
        return _IfElsePhase(self, False)

    def input(self, x: Variable) -> Variable:
        return x  # both branches see the whole batch

    def output(self, *outs):
        (self._true_outs if self._phase else self._false_outs).extend(outs)

    def __call__(self):
        assert len(self._true_outs) == len(self._false_outs), \
            "IfElse branches must output the same number of vars"
        results = []
        for t, f in zip(self._true_outs, self._false_outs):
            out = self.helper.create_tmp_variable(t.dtype, t.shape)
            self.helper.append_op(
                type="select_where",
                inputs={"Cond": [self.cond], "X": [t], "Y": [f]},
                outputs={"Out": [out]})
            results.append(out)
        return results


class _IfElsePhase:
    def __init__(self, owner, phase):
        self.owner = owner
        self.phase = phase

    def __enter__(self):
        self.owner._phase = self.phase
        return self.owner

    def __exit__(self, exc_type, exc, tb):
        self.owner._phase = None
        return False


class ConditionalBlock:
    """The reference's scope-guarded conditional block.  As in the JAX
    package, ``block()`` raises: ``IfElse`` (both branches, a row-wise
    select) is the form a batched program takes."""

    def __init__(self, inputs, name=None):
        self.inputs = inputs

    def block(self):
        raise NotImplementedError(
            "use layers.IfElse (dense two-branch select) — the TPU "
            "mapping of conditional blocks")


# --- the LoD dynamic-RNN machinery ------------------------------------------


def lod_rank_table(x: Variable, level: int = 0, **kwargs):
    helper = LayerHelper("lod_rank_table", **kwargs)
    out = helper.block.create_var(name=helper.name, dtype="int32",
                                  type=framework.VarType.LOD_TENSOR)
    helper.append_op(type="lod_rank_table", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"level": level})
    return out


def max_sequence_len(rank_table: Variable, **kwargs):
    helper = LayerHelper("max_seq_len", **kwargs)
    out = helper.create_tmp_variable("int32", ())
    helper.append_op(type="max_sequence_len",
                     inputs={"RankTable": [rank_table]},
                     outputs={"Out": [out]})
    return out


def lod_tensor_to_array(x: Variable, table: Variable, max_len=None,
                        **kwargs):
    helper = LayerHelper("lod_tensor_to_array", **kwargs)
    out = helper.block.create_var(name=helper.name, dtype=x.dtype,
                                  type=framework.VarType.LOD_TENSOR_ARRAY)
    helper.append_op(type="lod_tensor_to_array",
                     inputs={"X": [x], "RankTable": [table]},
                     outputs={"Out": [out]}, attrs={"max_len": max_len})
    return out


def array_to_lod_tensor(x: Variable, table: Variable, **kwargs):
    helper = LayerHelper("array_to_lod_tensor", **kwargs)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(type="array_to_lod_tensor",
                     inputs={"X": [x], "RankTable": [table]},
                     outputs={"Out": [out]})
    return out


def shrink_memory(x: Variable, i: Variable, table: Variable, **kwargs):
    helper = LayerHelper("shrink_memory", **kwargs)
    out = helper.create_tmp_variable(x.dtype, x.shape)
    helper.append_op(type="shrink_rnn_memory",
                     inputs={"X": [x], "I": [i], "RankTable": [table]},
                     outputs={"Out": [out]})
    return out


def split_lod_tensor(input: Variable, mask: Variable, **kwargs):
    helper = LayerHelper("split_lod_tensor", **kwargs)
    out_true = helper.create_tmp_variable(input.dtype, input.shape)
    out_false = helper.create_tmp_variable(input.dtype, input.shape)
    helper.append_op(type="split_lod_tensor",
                     inputs={"X": [input], "Mask": [mask]},
                     outputs={"OutTrue": [out_true], "OutFalse": [out_false]})
    return out_true, out_false


def merge_lod_tensor(in_true: Variable, in_false: Variable, x: Variable,
                     mask: Variable, **kwargs):
    helper = LayerHelper("merge_lod_tensor", **kwargs)
    out = helper.create_tmp_variable(in_true.dtype, in_true.shape)
    helper.append_op(type="merge_lod_tensor",
                     inputs={"X": [x], "Mask": [mask], "InTrue": [in_true],
                             "InFalse": [in_false]},
                     outputs={"Out": [out]})
    return out


class DynamicRNN(StaticRNN):
    """Variable-length RNN over padded batches: the StaticRNN scan with
    the caller's length masks, where the reference ran length-sorted LoD
    batches through shrink_memory."""
