"""v2 layer DSL (``paddle_tpu/v2/layer.py``), the part the v1 seq2seq
cell and the v1 demos reach: each constructor returns a lazy ``LayerOutput``;
``Topology`` walks the DAG once and emits the ops into a Program with
``paddle_tpu_torch.layers``.  Sequence values flow as (padded (B, T, ...),
lengths (B,)) pairs, ``SeqVal``.  Every v1 constructor resolves under its
v2 name through the module's ``__getattr__`` (``_v1_bridge``).  ``data``,
nested sequence data, the pooling, image, dropout, batch-norm and lstm
constructors and the costs besides cross entropy and mse wait for later
slices."""

from __future__ import annotations

from typing import Callable, List, Optional

from paddle_tpu_torch.v2.activation import BaseActivation
from paddle_tpu_torch.v2.data_type import InputType

__all__ = ["fc", "embedding", "gru", "classification_cost",
           "cross_entropy_cost", "mse_cost", "regression_cost",
           "LayerOutput"]

_counter = [0]


def _uname(prefix):
    _counter[0] += 1
    return f"v2_{prefix}_{_counter[0]}"


class SeqVal:
    """A padded sequence value inside the build: (B, T, ...) + lengths."""

    def __init__(self, var, lengths):
        self.var = var
        self.lengths = lengths


class LayerOutput:
    def __init__(self, name: str, parents: List["LayerOutput"],
                 build_fn: Callable, size: Optional[int] = None,
                 is_seq: bool = False, input_type: Optional[InputType] = None):
        self.name = name
        self.parents = parents
        self.build_fn = build_fn
        self.size = size
        self.is_seq = is_seq
        self.input_type = input_type
        self._topology = None  # cached by parameters.create

    def build(self, ctx: dict):
        if id(self) in ctx:
            return ctx[id(self)]
        parent_vals = [p.build(ctx) for p in self.parents]
        val = self.build_fn(ctx, *parent_vals)
        ctx[id(self)] = val
        return val


def _act_name(act):
    if act is None:
        return None
    if isinstance(act, BaseActivation):
        return act.name
    return act


# ---------------------------------------------------------------------------
# sources & transforms
# ---------------------------------------------------------------------------


# the declaration order of the data layers: feed columns follow it, not
# the graph's build order
_DATA_DECL_COUNTER = [0]


def fc(input, size: int, act=None, param_attr=None, bias_attr=None,
       name=None, **kwargs) -> LayerOutput:
    inputs = input if isinstance(input, (list, tuple)) else [input]

    def build(ctx, *vals):
        from paddle_tpu_torch import layers as L

        seq_len = None
        fluid_ins = []   # (var, num_flatten_dims, size_hint)
        any_seq_in = False
        for v, lo in zip(vals, inputs):
            if isinstance(v, SeqVal):
                # the declared layer size is the weight-shape fallback
                # where a var lost its static feature dim
                fluid_ins.append((v.var, 2, lo.size))
                seq_len = v.lengths
                any_seq_in = True
            else:
                shp = getattr(v, "shape", None)
                nf = 2 if (shp is not None and len(shp) == 3) else 1
                any_seq_in = any_seq_in or nf == 2
                fluid_ins.append((v, nf, lo.size))
        if len(fluid_ins) == 1 or all(nf == fluid_ins[0][1]
                                      for _, nf, _ in fluid_ins):
            out = L.fc(input=[v for v, _, _ in fluid_ins]
                       if len(fluid_ins) > 1 else fluid_ins[0][0],
                       size=size, num_flatten_dims=fluid_ins[0][1],
                       param_attr=param_attr, bias_attr=bias_attr,
                       act=_act_name(act),
                       in_features_hints=[h for _, _, h in fluid_ins])
            return SeqVal(out, seq_len) if seq_len is not None else out
        # sequence and per-sequence inputs together: each projected at its
        # own flatten depth, the dense terms broadcast over time, then the
        # bias and the activation once
        total = None
        for i, (v, nf, hint) in enumerate(fluid_ins):
            pa = (param_attr[i] if isinstance(param_attr, (list, tuple))
                  else param_attr)
            part = L.fc(input=v, size=size, num_flatten_dims=nf,
                        param_attr=pa, bias_attr=False, act=None,
                        in_features_hints=[hint])
            if any_seq_in and nf == 1:
                part = L.reshape(part, shape=[0, 1, size])
            total = part if total is None else L.elementwise_add(total, part)
        if bias_attr is not False:
            from paddle_tpu_torch.layer_helper import LayerHelper

            helper = LayerHelper("v2_fc_bias", bias_attr=bias_attr)
            total = helper.append_bias_op(total, dim_start=2)
        a = _act_name(act)
        if a:
            total = getattr(L, a)(total)
        return SeqVal(total, seq_len) if seq_len is not None else total

    any_seq = any(getattr(i, "is_seq", False) for i in inputs)
    return LayerOutput(name or _uname("fc"), list(inputs), build, size=size,
                       is_seq=any_seq)


def embedding(input, size: int, param_attr=None, name=None, **kwargs):
    # the vocab comes from the parent data layer's declared range
    def build(ctx, ids):
        from paddle_tpu_torch import layers as L
        from paddle_tpu_torch.layer_helper import LayerHelper

        seq = isinstance(ids, SeqVal)
        idv = ids.var if seq else ids
        vocab = input.input_type.dim if input.input_type else input.size
        if seq:
            # lookup_table wants a trailing index dim: (B, T) -> (B, T, 1)
            helper = LayerHelper("v2_emb_reshape")
            r = helper.create_tmp_variable("int64", (-1, -1, 1))
            helper.append_op(type="reshape", inputs={"X": [idv]},
                             outputs={"Out": [r]},
                             attrs={"shape": [0, -1, 1]})
            idv = r
        # v1's ParameterAttribute(sparse_update=True) selects the
        # SelectedRows gradient
        is_sparse = kwargs.get(
            "is_sparse", bool(getattr(param_attr, "sparse_update", False)))
        emb = L.embedding(input=idv, size=[vocab, size],
                          param_attr=param_attr, is_sparse=is_sparse)
        return SeqVal(emb, ids.lengths) if seq else emb

    return LayerOutput(name or _uname("embedding"), [input], build,
                       size=size, is_seq=input.is_seq)


# ---------------------------------------------------------------------------
# sequence layers (padded + mask)
# ---------------------------------------------------------------------------


def _masked(ctx, seq: SeqVal, mode: str):
    """Masked pooling over time: (B, T, D), lengths (B,) -> (B, D)."""
    from paddle_tpu_torch.layer_helper import LayerHelper

    helper = LayerHelper("v2_seqpool")
    shape = None
    if seq.var.shape is not None:
        shape = (seq.var.shape[0],) + tuple(seq.var.shape[2:])
    out = helper.create_tmp_variable("float32", shape)
    helper.append_op(
        type="padded_sequence_pool",
        inputs={"X": [seq.var], "Length": [seq.lengths]},
        outputs={"Out": [out]},
        attrs={"pooltype": mode.upper()},
    )
    return out


def gru(input, size: int, reverse: bool = False, name=None,
        param_attr=None, bias_attr=None, **kwargs):
    """The fused ``gru`` op over a pre-projected (B, T, 3 size) sequence;
    reversed inside each row's window where the lengths are known."""

    def build(ctx, seq):
        from paddle_tpu_torch.layer_helper import LayerHelper

        helper = LayerHelper("v2_gru")
        w = helper.create_parameter(param_attr, shape=[size, 3 * size],
                                    dtype="float32")
        ins = {"Input": [seq.var], "Weight": [w]}
        if reverse and seq.lengths is not None:
            ins["Length"] = [seq.lengths]
        if bias_attr is not False:  # False = no bias, the v1 idiom
            b = helper.create_parameter(bias_attr, shape=[1, 3 * size],
                                        dtype="float32", is_bias=True)
            ins["Bias"] = [b]
        hidden = helper.create_tmp_variable("float32", (-1, -1, size))
        helper.append_op(
            type="gru",
            inputs=ins,
            outputs={"Hidden": [hidden]},
            attrs={"is_reverse": reverse})
        return SeqVal(hidden, seq.lengths)

    return LayerOutput(name or _uname("gru"), [input], build, size=size,
                       is_seq=True)


def append_padded_reverse(var, lengths=None):
    """A ``padded_sequence_reverse`` op over ``var`` (B, T, ...), inside
    each row's window when ``lengths`` is given: the backward sequence
    walk of a reversed recurrent group."""
    from paddle_tpu_torch.layer_helper import LayerHelper

    helper = LayerHelper("padded_sequence_reverse")
    out = helper.create_tmp_variable(var.dtype, var.shape)
    ins = {"X": [var]}
    if lengths is not None:
        ins["Length"] = [lengths]
    helper.append_op(type="padded_sequence_reverse", inputs=ins,
                     outputs={"Out": [out]})
    return out


# ---------------------------------------------------------------------------
# costs
# ---------------------------------------------------------------------------


def cross_entropy_cost(input, label, name=None, **kwargs):
    def build(ctx, pred, lab):
        from paddle_tpu_torch import layers as L
        from paddle_tpu_torch.layer_helper import LayerHelper

        if isinstance(pred, SeqVal):
            # per-step CE over the padded sequence, masked by length
            helper = LayerHelper("seq_ce")
            out = helper.create_tmp_variable("float32", (-1, 1))
            ins = {"X": [pred.var],
                   "Label": [lab.var if isinstance(lab, SeqVal) else lab]}
            if pred.lengths is not None:
                ins["Length"] = [pred.lengths]
            helper.append_op(type="padded_sequence_cross_entropy",
                             inputs=ins, outputs={"Out": [out]})
            return L.mean(out)
        return L.mean(L.cross_entropy(input=pred, label=lab))

    return LayerOutput(name or _uname("cost"), [input, label], build, size=1)


classification_cost = cross_entropy_cost


def mse_cost(input, label, name=None, **kwargs):
    def build(ctx, pred, lab):
        from paddle_tpu_torch import layers as L

        return L.mean(L.square_error_cost(input=pred, label=lab))

    return LayerOutput(name or _uname("mse"), [input, label], build, size=1)


regression_cost = mse_cost


# ---------------------------------------------------------------------------
# The v1 constructors under v2 names (``paddle_tpu/v2/layer.py:562-590``),
# resolved lazily through the module's __getattr__, clear of the
# trainer_config_helpers.layers -> v2.layer import cycle.  The names this
# module defines win.
# ---------------------------------------------------------------------------

_KEEP_NAMES = {"StaticInput", "SubsequenceInput", "GeneratedInput",
               "LayerType", "layer_support", "BaseGeneratedInput",
               "AggregateLevel", "ExpandLevel"}


def _convert_v1_name(inname: str) -> str:
    if inname in _KEEP_NAMES:
        return inname
    if inname == "maxid_layer":
        return "max_id"
    if (inname.endswith("memory") or inname.endswith("_seq")
            or inname.endswith("_sim") or inname == "hsigmoid"):
        return inname
    if inname in ("cross_entropy", "multi_binary_label_cross_entropy",
                  "cross_entropy_with_selfnorm"):
        return inname + "_cost"
    if inname.endswith("_cost"):
        return inname
    if inname.endswith("_layer"):
        return inname[:-len("_layer")]
    return inname


_v1_bridge_table = None


def _v1_bridge():
    global _v1_bridge_table
    if _v1_bridge_table is None:
        from paddle_tpu_torch.trainer_config_helpers import layers as v1
        from paddle_tpu_torch.trainer_config_helpers import layers_extra as v1x

        table = {}
        for mod in (v1, v1x):
            for nm in mod.__all__:
                table.setdefault(_convert_v1_name(nm), getattr(mod, nm))
        _v1_bridge_table = table
    return _v1_bridge_table


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    table = _v1_bridge()
    if name in table:
        return table[name]
    raise AttributeError(
        f"module 'paddle_tpu_torch.v2.layer' has no attribute {name!r}")
