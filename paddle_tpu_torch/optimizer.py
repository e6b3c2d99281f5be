"""Optimizers: append backward + update ops to the program (the port of
``paddle_tpu/optimizer.py:19-222``).

``minimize`` = ``append_backward`` + the gradient clips + one update op
per parameter, with the learning rate and the accumulators created in
the startup program and every op of the update pass marked
``op_role="optimize"`` (so ``clone(for_test=True)`` strips it).  The
Executor then runs forward, backward and update op by op.  The
``global_step`` counter of the learning-rate schedules comes with
``lr_scheduler.py``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from paddle_tpu_torch import framework
from paddle_tpu_torch.backward import append_backward
from paddle_tpu_torch.framework import (Block, Parameter, Program, Variable,
                                        unique_name)
from paddle_tpu_torch.initializer import ConstantInitializer


class Optimizer:
    def __init__(self, learning_rate: float = 0.01, regularization=None,
                 grad_clip=None):
        self.grad_clip = grad_clip
        self._lr_value = learning_rate
        self._lr_var: Optional[Variable] = None
        # accepted for the JAX package's signature; regularizers are
        # per parameter (ParamAttr(regularizer=...)) in both packages
        self.regularization = regularization
        self._startup_program: Optional[Program] = None  # set per minimize()
        self._main_block: Optional[Block] = None
        # accumulators[name][param_name] -> Variable
        self._accumulators: Dict[str, Dict[str, Variable]] = {}

    # -- helpers ------------------------------------------------------------

    def _startup_block(self) -> Block:
        prog = self._startup_program or framework.default_startup_program()
        return prog.global_block()

    def _create_lr_var(self, block: Block):
        if self._lr_var is not None:
            return self._lr_var
        if isinstance(self._lr_value, Variable):
            # a learning rate computed in-graph
            self._lr_var = self._lr_value
            return self._lr_var
        name = unique_name("learning_rate")
        startup = self._startup_block()
        svar = startup.create_var(name=name, shape=(1,), dtype="float32",
                                  persistable=True)
        ConstantInitializer(float(self._lr_value))(svar, startup)
        self._lr_var = block.create_var(name=name, shape=(1,), dtype="float32",
                                        persistable=True)
        return self._lr_var

    def _add_accumulator(self, name: str, param: Parameter, fill_value=0.0,
                         shape=None, dtype="float32"):
        shape = shape if shape is not None else list(param.shape)
        acc_name = unique_name(f"{param.name}_{name}")
        startup = self._startup_block()
        svar = startup.create_var(name=acc_name, shape=shape, dtype=dtype,
                                  persistable=True)
        ConstantInitializer(float(fill_value))(svar, startup)
        # declare in the program being optimized (the param's program)
        block = param.block.program.global_block()
        var = block.create_var(name=acc_name, shape=shape, dtype=dtype,
                               persistable=True)
        self._accumulators.setdefault(name, {})[param.name] = var
        return var

    def _get_accumulator(self, name: str, param: Parameter) -> Variable:
        return self._accumulators[name][param.name]

    # -- override points ----------------------------------------------------

    def _create_accumulators(self, block: Block, params: List[Parameter]):
        pass

    def _append_optimize_op(self, block: Block, param_and_grad):
        raise NotImplementedError

    def _finish_update(self, block: Block):
        pass

    # -- public -------------------------------------------------------------

    def minimize(self, loss: Variable, startup_program: Optional[Program] = None,
                 parameter_list=None, no_grad_set=None):
        self._startup_program = startup_program
        params_grads = append_backward(loss, parameter_list, no_grad_set)
        opt_ops = self._create_optimization_pass(params_grads, loss)
        return opt_ops, params_grads

    def _create_optimization_pass(self, params_grads, loss: Variable):
        block = loss.block.program.global_block()
        self._main_block = block
        n_before = len(block.ops)
        if self.grad_clip is not None:
            params_grads = self.grad_clip.append_clip_ops(block, params_grads)
        self._create_lr_var(block)
        self._create_accumulators(block, [p for p, _ in params_grads])
        ops = []
        for p, g in params_grads:
            if g is None:
                continue
            ops.append(self._append_optimize_op(block, (p, g)))
        self._finish_update(block)
        # role-mark everything this pass appended (clip, lr, updates,
        # beta-pow bumps): clone(for_test) strips it
        for op in block.ops[n_before:]:
            op.attrs["op_role"] = "optimize"
        return ops


class SGDOptimizer(Optimizer):
    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            type="sgd",
            inputs={"Param": [p], "Grad": [g], "LearningRate": [self._lr_var]},
            outputs={"ParamOut": [p]},
        )


class MomentumOptimizer(Optimizer):
    def __init__(self, learning_rate, momentum, use_nesterov=False, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, params):
        for p in params:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        v = self._get_accumulator("velocity", p)
        return block.append_op(
            type="momentum",
            inputs={"Param": [p], "Grad": [g], "Velocity": [v],
                    "LearningRate": [self._lr_var]},
            outputs={"ParamOut": [p], "VelocityOut": [v]},
            attrs={"mu": self._momentum, "use_nesterov": self._use_nesterov},
        )


class AdamOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, params):
        for p in params:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
        self._beta1_pow = self._add_global_acc("beta1_pow", self._beta1)
        self._beta2_pow = self._add_global_acc("beta2_pow", self._beta2)

    def _add_global_acc(self, name, value):
        gname = unique_name(name)
        startup = self._startup_block()
        svar = startup.create_var(name=gname, shape=(1,), dtype="float32",
                                  persistable=True)
        ConstantInitializer(float(value))(svar, startup)
        block = self._main_block or framework.default_main_program().global_block()
        return block.create_var(name=gname, shape=(1,), dtype="float32",
                                persistable=True)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            type="adam",
            inputs={"Param": [p], "Grad": [g], "LearningRate": [self._lr_var],
                    "Moment1": [self._get_accumulator("moment1", p)],
                    "Moment2": [self._get_accumulator("moment2", p)],
                    "Beta1Pow": [self._beta1_pow], "Beta2Pow": [self._beta2_pow]},
            outputs={"ParamOut": [p],
                     "Moment1Out": [self._get_accumulator("moment1", p)],
                     "Moment2Out": [self._get_accumulator("moment2", p)]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon},
        )

    def _finish_update(self, block):
        # advance the beta powers once per step
        block.append_op(type="scale", inputs={"X": [self._beta1_pow]},
                        outputs={"Out": [self._beta1_pow]},
                        attrs={"scale": self._beta1})
        block.append_op(type="scale", inputs={"X": [self._beta2_pow]},
                        outputs={"Out": [self._beta2_pow]},
                        attrs={"scale": self._beta2})


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer
