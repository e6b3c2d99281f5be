"""LayerHelper (``paddle_tpu/layer_helper.py``): creates parameters in
the startup and main programs, appends bias and activation ops."""

from __future__ import annotations

import copy

from paddle_tpu_torch import framework
from paddle_tpu_torch.framework import Variable, unique_name
from paddle_tpu_torch.initializer import ConstantInitializer, XavierInitializer
from paddle_tpu_torch.param_attr import ParamAttr


class LayerHelper:
    def __init__(self, layer_type: str, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        self.name = kwargs.get("name") or unique_name(layer_type)

    @property
    def main_program(self):
        return self.kwargs.get("main_program") or framework.default_main_program()

    @property
    def startup_program(self):
        return self.kwargs.get("startup_program") or framework.default_startup_program()

    @property
    def block(self):
        return self.main_program.current_block()

    def create_parameter(self, attr, shape, dtype, is_bias: bool = False,
                         default_initializer=None):
        # copy: never mutate a caller-owned ParamAttr (it may be reused
        # across layers, which must get distinct parameter names)
        attr = copy.copy(ParamAttr.to_attr(attr))
        if attr.name is None:
            attr.name = unique_name(".".join([self.name, "b" if is_bias else "w"]))
        init = attr.initializer or default_initializer
        if init is None:
            init = ConstantInitializer(0.0) if is_bias else XavierInitializer()
        # declare in the main program (for the graph) ...
        param = self.block.create_parameter(
            shape=shape,
            dtype=dtype,
            name=attr.name,
            trainable=attr.trainable,
            regularizer=attr.regularizer,
            gradient_clip=attr.gradient_clip,
            optimize_attr={"learning_rate": attr.learning_rate},
        )
        # ... and append its init op to the startup program
        sblock = self.startup_program.global_block()
        if attr.name not in sblock.vars:
            svar = sblock.create_var(
                name=attr.name, shape=shape, dtype=dtype, persistable=True
            )
            init(svar, sblock)
        return param

    def create_tmp_variable(self, dtype, shape=None, lod_level=0) -> Variable:
        return self.block.create_var(
            name=unique_name(".".join([self.name, "tmp"])),
            dtype=dtype,
            shape=shape,
            lod_level=lod_level,
        )

    def append_op(self, **kwargs):
        return self.block.append_op(**kwargs)

    @property
    def param_attr(self):
        return self.kwargs.get("param_attr")

    @property
    def bias_attr(self):
        return self.kwargs.get("bias_attr")

    def append_bias_op(self, input_var: Variable, dim_start=1, dim_end=None) -> Variable:
        bias_attr = self.bias_attr
        if bias_attr is False or bias_attr is None and not self.kwargs.get("bias_default", True):
            return input_var
        size = list(input_var.shape[dim_start:dim_end]) if input_var.shape else [1]
        b = self.create_parameter(bias_attr, shape=size, dtype=input_var.dtype, is_bias=True)
        out = self.create_tmp_variable(input_var.dtype, input_var.shape, input_var.lod_level)
        self.append_op(
            type="elementwise_add",
            inputs={"X": [input_var], "Y": [b]},
            outputs={"Out": [out]},
            attrs={"axis": dim_start},
        )
        return out

    def append_activation(self, input_var: Variable) -> Variable:
        act = self.kwargs.get("act")
        if act is None:
            return input_var
        if isinstance(act, str):
            act = {"type": act}
        act = dict(act)
        act_type = act.pop("type")
        out = self.create_tmp_variable(input_var.dtype, input_var.shape, input_var.lod_level)
        self.append_op(
            type=act_type, inputs={"X": [input_var]}, outputs={"Out": [out]}, attrs=act
        )
        return out
