"""v1 constructors of the long tail (``paddle_tpu/trainer_config_helpers/
layers_extra.py``), the part the recurrent groups and the nested
sequences reach: ``gru_step_layer`` and ``lstm_step_layer`` (one step
inside a recurrent_group), ``gated_unit_layer``, the nested-sequence
markers ``AggregateLevel``, ``ExpandLevel`` and ``SubsequenceInput``, and
generation's ``BaseGeneratedInput``.  The rest of the tail waits for ROADMAP Queue 1 item 3 step 3 part 2."""

from __future__ import annotations

from paddle_tpu_torch.trainer_config_helpers.layers import _record
from paddle_tpu_torch.v2 import layer as _v2
from paddle_tpu_torch.v2.layer import LayerOutput, SeqVal

__all__ = ["gru_step_layer", "gru_step_naive_layer", "lstm_step_layer",
           "gated_unit_layer", "AggregateLevel", "ExpandLevel",
           "SubsequenceInput", "BaseGeneratedInput"]


def _unwrap(v):
    return v.var if isinstance(v, SeqVal) else v


def _rewrap_like(parent_val, out):
    return SeqVal(out, parent_val.lengths) if isinstance(parent_val, SeqVal) \
        else out


def _simple(name_prefix, parents, build, size=None, is_seq=False,
            type_=None, name=None, **cfg):
    lo = LayerOutput(name or _v2._uname(name_prefix), list(parents), build,
                     size=size, is_seq=is_seq)
    if "proto_size" in cfg:
        # a captured proto size that differs from the LayerOutput's
        cfg["size"] = cfg.pop("proto_size")
    return _record(lo, type_ or name_prefix, **cfg)


def gru_step_layer(input, output_mem, size=None, act=None, name=None,
                   gate_act=None, param_attr=None, bias_attr=None, **kw):
    """One GRU step: ``input`` is the 3 x size projection, ``output_mem``
    the previous hidden (a ``gru_unit`` op)."""
    h = size or (input.size // 3 if input.size else None)

    def build(ctx, x, mem):
        from paddle_tpu_torch import layers as L

        out, _, _ = L.gru_unit(_unwrap(x), _unwrap(mem), (h or 0) * 3,
                               param_attr=param_attr, bias_attr=bias_attr)
        return out

    return _simple("gru_step", [input, output_mem], build, size=h, name=name,
                   active_type=(act.name if act else "tanh"))


gru_step_naive_layer = gru_step_layer


def lstm_step_layer(input, state, size=None, act=None, name=None,
                    gate_act=None, state_act=None, bias_attr=None,
                    with_state_output=False, **kw):
    """One LSTM step (the ``lstm_unit`` op): ``input`` the 4 x size gate
    projection, ``state`` the previous cell, a learned 4 x size gate bias
    unless ``bias_attr`` is False.  Returns the new hidden; with
    ``with_state_output`` also the new cell as a second LayerOutput."""
    h = size or (input.size // 4 if input.size else None)
    # the cell var of a build, kept in the build's ctx under this key
    cell_key = ("lstm_step_cell", object())

    def build(ctx, x, c_prev):
        from paddle_tpu_torch import layers as L
        from paddle_tpu_torch.layer_helper import LayerHelper

        helper = LayerHelper("lstm_step", bias_attr=bias_attr)
        gates = _unwrap(x)
        if bias_attr is not False:
            b = helper.create_parameter(bias_attr, shape=[4 * h],
                                        dtype="float32", is_bias=True)
            gates = L.elementwise_add(gates, b)
        c = helper.create_tmp_variable("float32", None)
        hh = helper.create_tmp_variable("float32", None)
        helper.append_op(type="lstm_unit",
                         inputs={"X": [gates], "C_prev": [_unwrap(c_prev)]},
                         outputs={"C": [c], "H": [hh]},
                         attrs={"forget_bias": 0.0})
        ctx[cell_key] = c
        return hh

    hid = _simple("lstm_step", [input, state], build, size=h, name=name,
                  active_type=(act.name if act else "tanh"))
    if not with_state_output:
        return hid

    def build_c(ctx, _h):
        # the hidden is the parent: its build has put the cell in ctx
        return ctx[cell_key]

    cell = _simple("get_output", [hid], build_c, size=h,
                   name=(name + "@state") if name else None)
    return hid, cell


def gated_unit_layer(input, size, act=None, gate_attr=None,
                     gate_param_attr=None, gate_bias_attr=None,
                     inproj_attr=None, inproj_param_attr=None,
                     inproj_bias_attr=None, name=None, **kw):
    """fc(input, act) * fc(input, sigmoid)."""
    from paddle_tpu_torch.trainer_config_helpers.activations import \
        SigmoidActivation
    from paddle_tpu_torch.trainer_config_helpers.layers import fc_layer

    proj = fc_layer(input=input, size=size, act=act,
                    param_attr=inproj_param_attr,
                    bias_attr=inproj_bias_attr,
                    name=name and name + "_input_proj")
    gate = fc_layer(input=input, size=size, act=SigmoidActivation(),
                    param_attr=gate_param_attr, bias_attr=gate_bias_attr,
                    name=name and name + "_gate")

    def build(ctx, p, g):
        from paddle_tpu_torch import layers as L

        return L.elementwise_mul(_unwrap(p), _unwrap(g))

    return _simple("gated_unit", [proj, gate], build, size=size,
                   type_="mixed", name=name)


# -- nested-sequence markers ------------------------------------------------


class AggregateLevel:
    TO_NO_SEQUENCE = "non-seq"
    TO_SEQUENCE = "seq"
    EACH_TIMESTEP = "non-seq"
    EACH_SEQUENCE = "seq"


class ExpandLevel:
    FROM_NO_SEQUENCE = "non-seq"
    FROM_SEQUENCE = "seq"
    FROM_TIMESTEP = "non-seq"


class SubsequenceInput:
    """A nested-sequence input of a recurrent_group: each outer step sees
    one subsequence (the group reads the wrapped layer's value)."""

    def __init__(self, input):
        self.input = input

    @property
    def size(self):
        return self.input.size

    @property
    def is_seq(self):
        return True

    @property
    def name(self):
        return self.input.name


class BaseGeneratedInput:
    """The base the generated inputs of a generation config derive from
    (``generation.GeneratedInput`` is the one ``beam_search`` takes)."""
