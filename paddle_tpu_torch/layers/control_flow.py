"""Control-flow layers (``paddle_tpu/layers/control_flow.py``): the
step-block RNNs ``StaticRNN`` and ``DynamicRNN``, which build a
``recurrent`` op over a sub-block, and the block guards they use.
``While``, ``IfElse``, the tensor arrays and the LoD rank-table layers
wait for the LoD control-flow slice."""

from __future__ import annotations

from typing import List, Optional

from paddle_tpu_torch.framework import Variable
from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = ["StaticRNN", "DynamicRNN", "StaticRNNGuard", "BlockGuard"]


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


class DynamicRNN(StaticRNN):
    """Variable-length RNN over padded batches: the StaticRNN scan with
    the caller's length masks, where the reference ran length-sorted LoD
    batches through shrink_memory."""
