"""Hand-composable recurrent units for v1 configs
(``paddle_tpu/trainer/recurrent_units.py``): ``LstmRecurrentUnit`` /
``GatedRecurrentUnit`` and their ``*LayerGroup`` forms, built from
``memory()``, ``mixed_layer`` projections and ``lstm_step_layer`` /
``gru_step_layer`` inside ``recurrent_group``.

``inputs`` is a list of projections (e.g. ``full_matrix_projection``);
``para_prefix`` names the parameters, so two units with one prefix share
weights.  The ``*Naive`` spellings run the same step as the fused ones.
"""

from paddle_tpu_torch.param_attr import ParamAttr
from paddle_tpu_torch.initializer import ConstantInitializer
from paddle_tpu_torch.trainer_config_helpers import activations as _acts
from paddle_tpu_torch.trainer_config_helpers import layers as _l
from paddle_tpu_torch.trainer_config_helpers.layers_extra import (gru_step_layer,
                                                            lstm_step_layer)

__all__ = [
    "LstmRecurrentUnit", "LstmRecurrentUnitNaive",
    "LstmRecurrentLayerGroup", "GatedRecurrentUnit",
    "GatedRecurrentUnitNaive", "GatedRecurrentLayerGroup",
]


def _act(a, default=None):
    """An activation object, or an active_type string ('' = linear)."""
    if a is None:
        return default
    if isinstance(a, str):
        if a in ("", "linear"):
            return _acts.LinearActivation()
        cls = {
            "tanh": _acts.TanhActivation,
            "sigmoid": _acts.SigmoidActivation,
            "relu": _acts.ReluActivation,
            "softmax": _acts.SoftmaxActivation,
        }.get(a)
        if cls is None:
            raise ValueError(f"unknown active_type {a!r}")
        return cls()
    return a


def LstmRecurrentUnit(name, size, active_type, state_active_type,
                      gate_active_type, inputs, para_prefix=None,
                      error_clipping_threshold=0, out_memory=None):
    """One LSTM step for use inside a recurrent_group step function: a 4h
    ``_input_recurrent`` mixed layer over the given projections plus
    W_r·h_{t-1}, then the lstm step with a state memory link."""
    if para_prefix is None:
        para_prefix = name
    if out_memory is None:
        out_memory = _l.memory(name=name, size=size)
    state_memory = _l.memory(name=name + "_state", size=size)
    with _l.mixed_layer(
            name=name + "_input_recurrent", size=size * 4,
            bias_attr=ParamAttr(name=para_prefix + "_input_recurrent.b",
                                initializer=ConstantInitializer(0.0))) as m:
        for proj in inputs:
            m += proj
        m += _l.full_matrix_projection(
            input=out_memory,
            param_attr=ParamAttr(name=para_prefix + "_input_recurrent.w"))
    hid, cell = lstm_step_layer(
        input=m._lo, state=state_memory, size=size,
        act=_act(active_type, _acts.TanhActivation()),
        gate_act=_act(gate_active_type, _acts.SigmoidActivation()),
        state_act=_act(state_active_type, _acts.TanhActivation()),
        bias_attr=ParamAttr(name=para_prefix + "_check.b"),
        name=name, with_state_output=True)
    state_memory.set_input(cell)
    return hid


def LstmRecurrentUnitNaive(*args, **kwargs):
    return LstmRecurrentUnit(*args, **kwargs)


LstmRecurrentUnitNaive.__doc__ = (
    "The layer-decomposed spelling of LstmRecurrentUnit: the same step.")


def LstmRecurrentLayerGroup(name, size, active_type, state_active_type,
                            gate_active_type, inputs, para_prefix=None,
                            error_clipping_threshold=0, seq_reversed=False):
    """Whole-sequence LSTM: a sequence-level 4h transform mixed over the
    input projections, then a recurrent_group running
    LstmRecurrentUnit."""
    with _l.mixed_layer(name=name + "_transform_input", size=size * 4,
                        bias_attr=False) as m:
        for proj in inputs:
            m += proj

    def step(x_t):
        return LstmRecurrentUnit(
            name=name, size=size, active_type=active_type,
            state_active_type=state_active_type,
            gate_active_type=gate_active_type,
            inputs=[_l.identity_projection(input=x_t)],
            para_prefix=para_prefix,
            error_clipping_threshold=error_clipping_threshold)

    return _l.recurrent_group(step=step, input=[m._lo],
                              reverse=seq_reversed,
                              name=name + "_layer_group")


def GatedRecurrentUnit(name, size, active_type, gate_active_type, inputs,
                       para_prefix=None, error_clipping_threshold=0,
                       out_memory=None):
    """One GRU step for use inside a recurrent_group step function: a 3h
    input mixed layer over the projections, then the gru step against the
    output memory."""
    if para_prefix is None:
        para_prefix = name
    if out_memory is None:
        out_memory = _l.memory(name=name, size=size)
    with _l.mixed_layer(
            name=name + "_input_proj", size=size * 3,
            bias_attr=ParamAttr(name=para_prefix + "_input_proj.b",
                                initializer=ConstantInitializer(0.0))) as m:
        for proj in inputs:
            m += proj
    return gru_step_layer(
        input=m._lo, output_mem=out_memory, size=size,
        act=_act(active_type, _acts.TanhActivation()),
        gate_act=_act(gate_active_type, _acts.SigmoidActivation()),
        param_attr=ParamAttr(name=para_prefix + "_gate_weight"),
        bias_attr=ParamAttr(name=para_prefix + "_gate_bias"),
        name=name)


def GatedRecurrentUnitNaive(*args, **kwargs):
    return GatedRecurrentUnit(*args, **kwargs)


GatedRecurrentUnitNaive.__doc__ = (
    "The layer-decomposed spelling of GatedRecurrentUnit: the same step.")


def GatedRecurrentLayerGroup(name, size, active_type, gate_active_type,
                             inputs, para_prefix=None,
                             error_clipping_threshold=0,
                             seq_reversed=False):
    """Whole-sequence GRU: recurrent_group over GatedRecurrentUnit."""
    with _l.mixed_layer(name=name + "_transform_input", size=size * 3,
                        bias_attr=False) as m:
        for proj in inputs:
            m += proj

    def step(x_t):
        return GatedRecurrentUnit(
            name=name, size=size, active_type=active_type,
            gate_active_type=gate_active_type,
            inputs=[_l.identity_projection(input=x_t)],
            para_prefix=para_prefix,
            error_clipping_threshold=error_clipping_threshold)

    return _l.recurrent_group(step=step, input=[m._lo],
                              reverse=seq_reversed,
                              name=name + "_layer_group")
